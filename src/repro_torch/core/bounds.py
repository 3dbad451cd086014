"""Per-field error-bound specs (NeurLZ §3.1: user-input error bounds).

:class:`ErrorBound` is one field's spec: a value-range-relative bound
(``rel``), an absolute bound (``abs``), and an optional regulation ``mode``
(strict 1×, relaxed 2×, unregulated) that overrides the session default.
The conventional stage groups fields by ``(shape, dtype, bound)``, so fields
that share a spec still compress in one batched call
(:mod:`repro_torch.core.conv_stage`); each archive entry records the
absolute bound it honoured (``entry["abs_eb"]``) and its mode
(``entry["mode"]``), which is all the decoder reads.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

MODES = ("strict", "relaxed", "unregulated")


@dataclasses.dataclass(frozen=True)
class ErrorBound:
    """One field's error-bound spec.

    ``rel``  value-range-relative bound: ``rel * (max - min)`` of the field.
    ``abs``  absolute bound; wins over ``rel`` when both are set.
    ``mode`` regulation mode, or ``None`` to inherit the session default.
    """

    rel: float | None = None
    abs: float | None = None
    mode: str | None = None

    def __post_init__(self):
        if self.mode is not None and self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r} (want one of {MODES})")
        for k in ("rel", "abs"):
            v = getattr(self, k)
            if v is not None and not float(v) > 0.0:
                raise ValueError(f"ErrorBound.{k} must be > 0, got {v!r}")

    @property
    def specified(self) -> bool:
        return self.rel is not None or self.abs is not None

    def resolved(self, default_mode: str) -> "ErrorBound":
        """The concrete spec: mode filled in from the session default."""
        if not self.specified:
            raise ValueError("ErrorBound needs rel= or abs=")
        if self.mode is not None:
            return self
        return dataclasses.replace(self, mode=default_mode)

    def conv_key(self) -> tuple:
        """The conventional stage's grouping key (the mode does not touch
        that stage, so it is left out)."""
        return (self.rel, self.abs)

    def limit(self, abs_eb: float) -> float:
        """The error this spec promises for a field whose absolute bound is
        ``abs_eb``: 1× strict, 2× relaxed, unbounded unregulated."""
        if self.mode == "relaxed":
            return 2.0 * abs_eb
        if self.mode == "unregulated":
            return float("inf")
        return abs_eb


def as_bound(spec) -> ErrorBound:
    """An ErrorBound passes through; a bare number is a relative bound."""
    if isinstance(spec, ErrorBound):
        return spec
    if isinstance(spec, (int, float)):
        return ErrorBound(rel=float(spec))
    raise TypeError(f"cannot interpret {type(spec).__name__} as an ErrorBound "
                    "(want ErrorBound or a relative-bound number)")


def resolve_bounds(names, bounds, rel_eb=None, abs_eb=None, *,
                   default_mode: str = "strict") -> dict[str, ErrorBound]:
    """Concrete specs for every field of a snapshot.

    ``bounds`` is ``None`` (every field uses ``rel_eb``/``abs_eb``), one spec
    for all fields, or a mapping ``name -> spec`` whose missing names fall
    back to ``rel_eb``/``abs_eb``.  A field with no bound is an error.
    """
    default = (ErrorBound(rel=rel_eb, abs=abs_eb)
               if (rel_eb is not None or abs_eb is not None) else None)
    if bounds is None:
        per_field: Mapping = {}
        fallback = default
    elif isinstance(bounds, Mapping):
        per_field = bounds
        unknown = [n for n in bounds if n not in set(names)]
        if unknown:
            raise KeyError(f"bounds given for unknown fields {unknown}")
        fallback = default
    else:
        per_field = {}
        fallback = as_bound(bounds)
    out: dict[str, ErrorBound] = {}
    for name in names:
        spec = as_bound(per_field[name]) if name in per_field else fallback
        if spec is None or not spec.specified:
            raise ValueError(f"no error bound for field {name!r}: pass "
                             "rel_eb/abs_eb or a bounds entry for it")
        out[name] = spec.resolved(default_mode)
    return out
