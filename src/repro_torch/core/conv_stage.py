"""The conventional stage of a compression run.

It plans the fields it is handed into groups of identical ``(shape, dtype,
error-bound spec)`` and runs each group through the compressor's batched
entry point when its registry entry declares one
(:attr:`repro_torch.compressors.registry.CompressorEntry.compress_batched`),
else field by field.  The batched entries are byte-identical to the
per-field path, so archives do not depend on the grouping.  For
``szlike-lorenzo`` a group is one ``lorenzo3d_fwd`` launch.

:class:`ConvStats` counts how the work was dispatched (groups, batched
calls, per-field calls); the engine reports it under
``timing["conv_stage"]``.  With telemetry, one ``conv`` span covers a run
(closed after the device has finished), and the counters ``conv.groups``,
``conv.dispatches``, ``conv.batched_fields`` and ``conv.fallback_fields``
and the gauge ``conv.group_size`` follow the same counts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from .. import device as device_lib
from ..compressors import registry
from ..obs import telemetry as obs


@dataclasses.dataclass
class ConvStats:
    """How the conventional stage dispatched its work.  ``calls`` is one
    per batched group call plus one per per-field call."""

    fields: int = 0
    groups: int = 0
    batched_fields: int = 0
    fallback_fields: int = 0
    calls: int = 0
    conv_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def plan_groups(metas: Mapping[str, tuple],
                keys: Mapping[str, tuple] | None = None) -> list[list[str]]:
    """Group field names by ``(shape, dtype[, key])`` in input order.
    ``metas`` maps name -> ``(shape, dtype)``; ``keys`` optionally refines
    the plan with a per-field hashable (the error-bound spec)."""
    groups: dict[tuple, list[str]] = {}
    for name, (shape, dtype) in metas.items():
        k = (tuple(shape), str(np.dtype(dtype)),
             keys[name] if keys is not None else None)
        groups.setdefault(k, []).append(name)
    return list(groups.values())


class ConvStage:
    """Plan and run the conventional stage of one compression run on
    ``device`` (``cuda`` unless given)."""

    def __init__(self, compressor: str, rel_eb: float | None = None,
                 abs_eb: float | None = None, *, batch: bool = True,
                 bounds: Mapping | None = None, device=None, telemetry=None):
        self.entry = registry.get(compressor)   # unknown name -> ValueError
        self.rel_eb = rel_eb
        self.abs_eb = abs_eb
        self.batch = batch
        # Per-field ErrorBound specs; fields absent here use the run scalars.
        self.bounds = dict(bounds) if bounds else None
        self.device = device_lib.resolve(device)
        self.stats = ConvStats()
        self.tel = telemetry if telemetry is not None else obs.NULL

    def bound_for(self, name: str) -> tuple[float | None, float | None]:
        """``(rel_eb, abs_eb)`` handed to the compressor for one field (abs
        wins inside the compressor); also the field's grouping key."""
        if self.bounds is not None and name in self.bounds:
            return self.bounds[name].conv_key()
        return (self.rel_eb, self.abs_eb)

    def plan(self, metas: Mapping[str, tuple]) -> list[list[str]]:
        keys = ({n: self.bound_for(n) for n in metas}
                if self.bounds is not None else None)
        return plan_groups(metas, keys=keys)

    def run(self, fields: Mapping[str, np.ndarray]
            ) -> dict[str, tuple[dict, np.ndarray]]:
        """Compress ``fields``; returns ``{name: (archive, reconstruction)}``."""
        t0 = time.perf_counter()
        out: dict[str, tuple[dict, np.ndarray]] = {}
        arrs = {n: np.asarray(x) for n, x in fields.items()}
        metas = {n: (a.shape, a.dtype) for n, a in arrs.items()}
        tel = self.tel
        with tel.span("conv", fields=len(arrs)) as sp:
            calls0 = self.stats.calls
            for group in self.plan(metas):
                self.stats.groups += 1
                tel.counter("conv.groups").add()
                tel.gauge("conv.group_size").set(len(group))
                rel, ab = self.bound_for(group[0])   # one spec per group
                if (self.batch and len(group) > 1
                        and self.entry.batch_supports(metas[group[0]][1])):
                    results = self.entry.compress_batched(
                        [arrs[n] for n in group], rel, abs_eb=ab,
                        device=self.device)
                    self.stats.calls += 1
                    self.stats.batched_fields += len(group)
                    tel.counter("conv.dispatches").add()
                    tel.counter("conv.batched_fields").add(len(group))
                    out.update(zip(group, results))
                else:
                    for n in group:
                        out[n] = self.entry.compress(arrs[n], rel, abs_eb=ab,
                                                     device=self.device)
                        self.stats.calls += 1
                        self.stats.fallback_fields += 1
                        tel.counter("conv.dispatches").add()
                        tel.counter("conv.fallback_fields").add()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            sp.set(calls=self.stats.calls - calls0)
        self.stats.fields += len(arrs)
        self.stats.conv_s += time.perf_counter() - t0
        return {n: out[n] for n in arrs}
