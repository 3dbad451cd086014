"""The NeurLZ session API of the port.

    import repro_torch

    sess = repro_torch.NeurLZ(epochs=100)            # runs on cuda
    arc = sess.compress(fields, rel_eb=1e-3)
    arc = sess.compress(fields, bounds={"w": repro_torch.ErrorBound(abs=0.1)},
                        rel_eb=1e-3)     # per-field bounds
    arc.save("snap.nlz")
    out = repro_torch.open("snap.nlz").decode_all()

    tel = repro_torch.Telemetry()                    # spans, counters, traces
    faults = repro_torch.FaultConfig(retry=repro_torch.RetryPolicy())
    arc = repro_torch.NeurLZ(telemetry=tel, faults=faults).compress(
        fields, rel_eb=1e-3)   # a failed field degrades to conv-only

    sess = repro_torch.NeurLZ(group_size=1, max_resident_bytes=900_000_000)
    arc = sess.compress_to("snapshot_npys/", "snap.nlzs", rel_eb=1e-3)
    arc.report["peak_resident_bytes"]                # out of core, lazy
    w = arc.decode("w", roi=(slice(10, 20),))        # one region

Configuration is split by concern as in the JAX package — ``ModelConfig``
(the enhancer and its training), ``EngineConfig`` (which engine runs),
``RegulationConfig`` (the regulation mode) — and flattens losslessly into
:class:`NeurLZConfig`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping

from . import device as device_lib
from . import faults as faults_lib
from .core import neurlz
from .core.archive_api import Archive
from .core.neurlz import NeurLZConfig
from .obs import telemetry as obs


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The skipping-DNN enhancer and its compression-time training."""

    widths: tuple = (4, 4, 6, 6, 8)
    skip: bool = True
    learn_residual: bool = True
    weight_dtype: str = "float32"
    epochs: int = 100
    batch: int = 10
    lr: float = 1e-2
    seed: int = 0
    slice_axis: int = 0
    cross_field: Mapping[str, tuple] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Which engine executes a compression run."""

    engine: str = "serial"              # serial | batched | streaming
    compressor: str = "szlike"          # szlike | szlike-lorenzo | zfplike
    field_batching: str = "auto"        # auto | unroll | vmap (stacked)
    group_size: int = 2                 # fields per batched group (0 = all)
    prefetch: bool = True               # conventional stage lazily a group
    field_shard: bool = True            # spread groups over devices (one
    #   device a session: nothing to spread)
    conv_batch: bool = True             # batched conventional stage
    max_resident_bytes: int = 0         # streaming residency budget (0: off)
    telemetry: object | None = None     # repro_torch.Telemetry (None: off)
    faults: object | None = None        # repro_torch.FaultConfig (None:
    #   no injection, no retries, conv-only degradation on)


@dataclasses.dataclass(frozen=True)
class RegulationConfig:
    mode: str = "strict"                # strict | relaxed | unregulated


_MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(ModelConfig))
_ENGINE_FIELDS = tuple(f.name for f in dataclasses.fields(EngineConfig))
_REG_FIELDS = tuple(f.name for f in dataclasses.fields(RegulationConfig))


def join_config(model: ModelConfig, engine: EngineConfig,
                regulation: RegulationConfig) -> NeurLZConfig:
    kw = {f: getattr(model, f) for f in _MODEL_FIELDS}
    kw.update({f: getattr(engine, f) for f in _ENGINE_FIELDS})
    kw.update({f: getattr(regulation, f) for f in _REG_FIELDS})
    return NeurLZConfig(**kw)


def split_config(config: NeurLZConfig
                 ) -> tuple[ModelConfig, EngineConfig, RegulationConfig]:
    return (ModelConfig(**{f: getattr(config, f) for f in _MODEL_FIELDS}),
            EngineConfig(**{f: getattr(config, f) for f in _ENGINE_FIELDS}),
            RegulationConfig(**{f: getattr(config, f) for f in _REG_FIELDS}))


class NeurLZ:
    """A configured compression session on one device (``cuda`` unless
    ``device`` says otherwise)."""

    def __init__(self, model: ModelConfig | None = None,
                 engine: EngineConfig | str | None = None,
                 regulation: RegulationConfig | None = None, *,
                 config: NeurLZConfig | None = None, device=None,
                 **flat_kwargs):
        if isinstance(engine, str):
            flat_kwargs.setdefault("engine", engine)
            engine = None
        m0, e0, r0 = (split_config(config) if config is not None else
                      (ModelConfig(), EngineConfig(), RegulationConfig()))
        mkw, ekw, rkw = {}, {}, {}
        for k, v in flat_kwargs.items():
            if k in _MODEL_FIELDS:
                mkw[k] = v
            elif k in _ENGINE_FIELDS:
                ekw[k] = v
            elif k in _REG_FIELDS:
                rkw[k] = v
            elif k == "lowering":
                raise TypeError("repro_torch has no 'lowering' switch: the "
                                "tensors' device picks the kernel (cuda) or "
                                "the plain version (cpu)")
            else:
                raise TypeError(f"unknown NeurLZ config field {k!r}")
        self.model = dataclasses.replace(model or m0, **mkw)
        self.engine = dataclasses.replace(engine or e0, **ekw)
        self.regulation = dataclasses.replace(regulation or r0, **rkw)
        self.config.check()
        self.device = device_lib.resolve(device)

    @property
    def config(self) -> NeurLZConfig:
        return join_config(self.model, self.engine, self.regulation)

    def compress(self, fields: Mapping, bounds=None, *,
                 rel_eb: float | None = None, abs_eb: float | None = None,
                 collect_stats: bool = True,
                 init_params: Mapping | None = None,
                 batch_schedules: Mapping | None = None) -> Archive:
        """Compress one snapshot's fields into an :class:`Archive`.

        ``bounds`` is the per-field error-bound surface: one
        :class:`ErrorBound` (or bare relative bound) for every field, or a
        mapping ``name -> spec`` whose missing fields fall back to
        ``rel_eb``/``abs_eb``.  Each field honours its own bound and mode.
        ``init_params`` / ``batch_schedules`` optionally fix each field's
        initial enhancer weights and batch order (parity runs against the
        JAX package feed its ``init_params`` and ``epoch_batches``).
        """
        arc = neurlz.compress_impl(
            fields, rel_eb, abs_eb=abs_eb, config=self.config,
            collect_stats=collect_stats, device=self.device,
            init_params=init_params, batch_schedules=batch_schedules,
            bounds=bounds)
        return self._adopt(Archive.from_dict(arc, device=self.device))

    def compress_to(self, source, sink, bounds=None, *,
                    rel_eb: float | None = None,
                    abs_eb: float | None = None,
                    collect_stats: bool = True,
                    resume: bool = False) -> Archive:
        """Stream-compress ``source`` into the container ``sink``, out of
        core, on this session's device.

        ``source`` is anything :func:`repro_torch.streaming.as_source`
        accepts (a dict of arrays, a directory of ``.npy`` files, a
        ``ChunkedFieldSource`` such as ``BlockedSource``); ``sink`` a path
        or a binary file object.  Runs the bounded-memory streaming
        pipeline whatever ``engine`` says, under ``max_resident_bytes``,
        and returns a **lazy** :class:`Archive` over the written container
        with the pipeline's report as ``archive.report``.

        ``resume=True``: if ``sink`` holds a partial container of an
        interrupted run of the *same* configuration, its sealed entries are
        salvaged and only the remaining fields compressed; the finished
        container's entries equal an uninterrupted run's.  A configuration
        mismatch is an error.
        """
        from .streaming import pipeline
        if isinstance(sink, os.PathLike):
            sink = os.fspath(sink)
        cfg = dataclasses.replace(self.config, engine="streaming")
        report = pipeline.compress(source, sink, rel_eb, abs_eb=abs_eb,
                                   config=cfg, collect_stats=collect_stats,
                                   bounds=bounds, resume=resume,
                                   device=self.device)
        arc = Archive.open(sink, device=self.device)
        arc.report = report
        return self._adopt(arc)

    def _adopt(self, arc: Archive) -> Archive:
        """Give ``arc`` this session's telemetry and faults where it has
        none of its own."""
        if self.engine.telemetry is not None and arc.telemetry is obs.NULL:
            arc.telemetry = self.engine.telemetry
        if (self.engine.faults is not None
                and arc.faults is faults_lib.DEFAULT):
            arc.faults = self.engine.faults
        return arc

    def decompress(self, archive, *, reassemble: bool = False) -> dict:
        """Decode every field of an :class:`Archive` or archive dict on
        this session's device, with its telemetry and faults, by this
        session's engine (``batched`` and ``streaming`` decode as
        ``serial`` does); ``reassemble=True`` joins blocked fields."""
        if not (isinstance(archive, Archive) and archive.device == self.device):
            arc = archive.to_dict() if isinstance(archive, Archive) else archive
            archive = Archive(arc, device=self.device)
        engine = "batched" if self.engine.engine == "batched" else "serial"
        return self._adopt(archive).decode_all(engine=engine,
                                               reassemble=reassemble)

    def __repr__(self) -> str:
        return (f"NeurLZ(engine={self.engine.engine!r}, "
                f"compressor={self.engine.compressor!r}, "
                f"mode={self.regulation.mode!r}, epochs={self.model.epochs}, "
                f"device={str(self.device)!r})")


def open(path, *, repair: bool = False, device=None) -> Archive:  # noqa: A001
    """:meth:`Archive.open`: ``repro_torch.open(path)`` decodes on ``cuda``
    unless ``device`` says otherwise."""
    return Archive.open(path, repair=repair, device=device)
