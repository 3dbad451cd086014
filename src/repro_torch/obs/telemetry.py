"""Structured telemetry: spans, counters/gauges, per-field learning traces.

One :class:`Telemetry` handle rides through a whole compression (or decode)
run and records three kinds of data:

* **Spans** — nested wall/thread-time intervals (``with tel.span("conv")``).
  Nesting is tracked per thread; spans opened on a thread with no enclosing
  span (the streaming pipeline's reader and writer threads) attach to the
  run's root span, so the exported tree shows the async overlap instead of
  orphan intervals.
* **Counters / gauges** — monotonic totals (conv dispatches, archive entry
  reads, writer back-pressure stalls) and sampled levels (resident bytes
  vs. the ledger ceiling, writer queue depth).  Gauges keep a bounded
  timestamped sample trail so exporters can draw them as Perfetto counter
  tracks.
* **Learning traces** — per-field, per-epoch records of the online
  training trajectory (loss, residual RMS in original units, predicted
  PSNR/bitrate, optional measured PSNR on sampled slices): the paper's
  epoch-trajectory figures as first-class data instead of a thrown-away
  ``loss_history``.

The disabled path is allocation-free: a :data:`NULL` singleton implements
the same surface with shared no-op span/counter/gauge objects, so
``tel.span(...)`` / ``tel.counter(...).add()`` in a hot loop costs a method
call and nothing else.  Engines obtain their handle with :func:`of`, which
maps ``config.telemetry is None`` to :data:`NULL`.

A copy of the JAX package's ``repro.obs.telemetry``: records, exports and
timing schema are the same, so traces of the two packages compare field for
field.  It imports nothing but the standard library.  On CUDA a span reads
the host clock: the engine closes a span after it has waited for the
device, so a field's device work lands in its own span.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any

__all__ = [
    "Telemetry", "TelemetryConfig", "SpanRecord", "Counter", "Gauge",
    "NullTelemetry", "NULL", "of", "build_timing", "learning_trace",
    "TIMING_KEYS",
]


# Canonical engine timing schema: every engine's ``timing`` dict carries at
# least these keys (streaming adds its ledger/writer extras on top).
TIMING_KEYS = ("total_s", "conv_s", "train_s", "conv_stage")

# Crude per-outlier storage cost (bits) for the predicted-bitrate trace:
# the paper's B-bar coordinate is ~log2(n) bits; 32 covers every block size
# the benchmarks run.  A prediction, not an accounting — the archive's
# ``bitrate`` table stays the measured truth.
_PRED_OUTLIER_BITS = 32.0

_GAUGE_SAMPLE_CAP = 8192        # per-gauge timestamped sample trail bound


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for an enabled :class:`Telemetry` handle."""

    learning_traces: bool = True    # record per-epoch learning trajectories
    sample_psnr: bool = False       # measure PSNR on sampled slices per
    #   epoch (serial engine only — the batched/streaming engines run every
    #   epoch inside one fused dispatch, so there is no per-epoch host hook)
    sample_slices: int = 4          # slices sampled for sample_psnr
    max_spans: int = 200_000        # hard cap; further spans are dropped


@dataclasses.dataclass
class SpanRecord:
    """One finished span."""

    id: int
    parent: int | None
    name: str
    thread: int                 # python thread ident
    thread_name: str
    t0: float                   # seconds since the handle's epoch
    dur: float                  # wall seconds
    cpu: float                  # thread-CPU seconds inside the span
    attrs: dict[str, Any]


class Counter:
    """Monotonic counter (thread-safe adds)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Sampled level: keeps last/min/max plus a bounded (ts, value) trail
    so exporters can draw the gauge as a counter track over time."""

    __slots__ = ("name", "value", "vmin", "vmax", "samples", "_lock",
                 "_clock")

    def __init__(self, name: str, clock):
        self.name = name
        self.value = None
        self.vmin = None
        self.vmax = None
        self.samples: list[tuple[float, float]] = []
        self._lock = threading.Lock()
        self._clock = clock

    def set(self, v) -> None:
        with self._lock:
            self.value = v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            if len(self.samples) < _GAUGE_SAMPLE_CAP:
                self.samples.append((self._clock(), float(v)))


class _ActiveSpan:
    """Context manager for one open span; ``set(**attrs)`` adds attributes
    mid-flight (e.g. a result count known only at the end)."""

    __slots__ = ("_tel", "_name", "_attrs", "_id", "_parent", "_t0", "_cpu0",
                 "_root")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict,
                 root: bool = False):
        self._tel = tel
        self._name = name
        self._attrs = attrs
        self._root = root

    def set(self, **attrs) -> "_ActiveSpan":
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        tel = self._tel
        stack = tel._stack()
        self._parent = stack[-1] if stack else tel._root_id
        self._id = tel._next_id()
        if self._root and tel._root_id is None:
            tel._root_id = self._id
        stack.append(self._id)
        self._t0 = tel._clock()
        self._cpu0 = time.thread_time()
        return self

    def __exit__(self, *exc) -> bool:
        tel = self._tel
        dur = tel._clock() - self._t0
        cpu = time.thread_time() - self._cpu0
        stack = tel._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        th = threading.current_thread()
        tel._record(SpanRecord(
            id=self._id, parent=self._parent, name=self._name,
            thread=th.ident or 0, thread_name=th.name,
            t0=self._t0, dur=dur, cpu=cpu, attrs=self._attrs))
        if self._root and tel._root_id == self._id:
            tel._root_id = None
        return False


class Telemetry:
    """One run's telemetry sink.  Thread-safe; reusable across runs (spans
    and traces accumulate — hand a fresh handle per run for clean exports).
    """

    enabled = True

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self.epoch = time.time()          # wall anchor for exported ts
        self._perf0 = time.perf_counter()
        self._spans: list[SpanRecord] = []
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._traces: dict[str, list[dict]] = {}
        self._lock = threading.Lock()
        self._ids = 0
        self._root_id: int | None = None
        self._local = threading.local()
        self.dropped_spans = 0

    # -- internals ----------------------------------------------------------

    def _clock(self) -> float:
        """Monotonic seconds since handle construction."""
        return time.perf_counter() - self._perf0

    def _stack(self) -> list[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) >= self.config.max_spans:
                self.dropped_spans += 1
                return
            self._spans.append(rec)

    # -- recording surface --------------------------------------------------

    def span(self, name: str, *, root: bool = False, **attrs) -> _ActiveSpan:
        """Open a span (use as a context manager).  ``root=True`` marks the
        run's top-level span: spans later opened on *other* threads with no
        enclosing span (reader/writer threads) parent to it."""
        return _ActiveSpan(self, name, attrs, root=root)

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._clock))
        return g

    def record_trace(self, field: str, record: dict) -> None:
        """Append one learning-trace record (one per training epoch)."""
        with self._lock:
            self._traces.setdefault(field, []).append(record)

    # -- read surface -------------------------------------------------------

    @property
    def spans(self) -> list[SpanRecord]:
        return list(self._spans)

    @property
    def counters(self) -> dict[str, int | float]:
        return {n: c.value for n, c in self._counters.items()}

    def counters_prefixed(self, prefix: str) -> dict[str, int | float]:
        """Counters whose name starts with ``prefix`` (e.g. ``"serve."``)
        — lets a subsystem report its own slice of a shared handle."""
        return {n: c.value for n, c in self._counters.items()
                if n.startswith(prefix)}

    @property
    def gauges(self) -> dict[str, dict]:
        return {n: {"last": g.value, "min": g.vmin, "max": g.vmax}
                for n, g in self._gauges.items()}

    def trace(self, field: str) -> list[dict]:
        return list(self._traces.get(field, ()))

    @property
    def traces(self) -> dict[str, list[dict]]:
        return {f: list(rs) for f, rs in self._traces.items()}

    def span_tree(self) -> dict[int | None, list[SpanRecord]]:
        """Finished spans grouped by parent id (children in start order)."""
        tree: dict[int | None, list[SpanRecord]] = {}
        for s in sorted(self._spans, key=lambda s: s.t0):
            tree.setdefault(s.parent, []).append(s)
        return tree

    def span_summary(self) -> dict[str, dict]:
        """Aggregate wall/CPU time per span name — the span-tree-derived
        timing schema engines attach to ``timing["spans"]``."""
        agg: dict[str, dict] = {}
        for s in self._spans:
            a = agg.setdefault(s.name, {"count": 0, "wall_s": 0.0,
                                        "cpu_s": 0.0})
            a["count"] += 1
            a["wall_s"] += s.dur
            a["cpu_s"] += s.cpu
        return agg

    def summary(self) -> dict:
        """Aggregated run summary (the third exporter)."""
        return {
            "spans": self.span_summary(),
            "counters": self.counters,
            "gauges": self.gauges,
            "fields": sorted(self._traces),
            "epochs": {f: len(rs) for f, rs in self._traces.items()},
            "dropped_spans": self.dropped_spans,
        }

    # -- export convenience (implementations in repro_torch.obs.export) -----

    def export_jsonl(self, sink) -> int:
        from . import export
        return export.write_jsonl(self, sink)

    def chrome_trace(self) -> dict:
        from . import export
        return export.chrome_trace(self)

    def export_chrome_trace(self, sink) -> int:
        from . import export
        return export.write_chrome_trace(self, sink)


# ---------------------------------------------------------------------------
# Disabled path: shared no-op singletons, zero allocations per call
# ---------------------------------------------------------------------------

class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


class _NullCounter:
    __slots__ = ()
    value = 0

    def add(self, n=1):
        return None


class _NullGauge:
    __slots__ = ()
    value = None
    vmin = None
    vmax = None

    def set(self, v):
        return None


_NULL_SPAN = _NullSpan()
_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()


class NullTelemetry:
    """Disabled telemetry: every call returns a shared no-op singleton."""

    enabled = False
    config = TelemetryConfig(learning_traces=False)

    def span(self, name, *, root=False, **attrs):
        return _NULL_SPAN

    def counter(self, name):
        return _NULL_COUNTER

    def gauge(self, name):
        return _NULL_GAUGE

    def record_trace(self, field, record):
        return None

    def trace(self, field):
        return []

    traces: dict = {}

    @property
    def spans(self):
        return []

    @property
    def counters(self):
        return {}

    def counters_prefixed(self, prefix):
        return {}

    @property
    def gauges(self):
        return {}

    def summary(self):
        return {}


NULL = NullTelemetry()


def of(config) -> Telemetry | NullTelemetry:
    """The telemetry handle carried by a config-like object (``.telemetry``
    attribute), or :data:`NULL`."""
    tel = getattr(config, "telemetry", None)
    return tel if tel is not None else NULL


# ---------------------------------------------------------------------------
# Engine timing schema + learning-trace recording
# ---------------------------------------------------------------------------

def build_timing(tel, *, total_s: float, conv_s: float, train_s: float,
                 conv_stage: dict, **extra) -> dict:
    """The one engine ``timing`` schema.

    Every engine reports the same core keys (:data:`TIMING_KEYS`); streaming
    passes its ledger/writer numbers through ``extra``.  With telemetry
    enabled the dict also carries ``spans`` — per-name wall/CPU aggregates
    derived from the span tree — so post-hoc consumers see where the wall
    clock went without holding the handle."""
    timing = {"total_s": total_s, "conv_s": conv_s, "train_s": train_s,
              "conv_stage": conv_stage}
    timing.update(extra)
    if tel.enabled:
        timing["spans"] = tel.span_summary()
    return timing


def learning_trace(tel, field: str, history, *, eb: float, vrange: float,
                   base_bytes: float, n_points: int, mode: str,
                   sample_psnr=None) -> None:
    """Record one field's per-epoch learning trajectory.

    ``history`` is the per-epoch mean training loss on the normalized
    residual ``(X − X')/eb`` — every engine produces it, fused or not.  From
    it and the run constants we derive, per epoch:

    * ``loss`` — the raw normalized-residual MSE (or L1) itself,
    * ``residual_rms`` — ``sqrt(loss) * eb``: RMS of the *remaining* error
      in original units had training stopped at this epoch,
    * ``pred_psnr`` — the PSNR that residual level implies against the
      field's value range,
    * ``pred_outlier_rate`` / ``pred_bitrate`` — a Gaussian-residual
      estimate of the strict-mode outlier fraction (``|r| > eb``) and the
      bitrate it would cost on top of the conv+weights base,
    * ``sample_psnr`` — measured PSNR on sampled slices when the serial
      engine ran with ``TelemetryConfig.sample_psnr`` (None elsewhere: the
      fused engines have no per-epoch host hook).
    """
    if not tel.enabled or not tel.config.learning_traces:
        return
    base_bitrate = 8.0 * float(base_bytes) / max(1, n_points)
    for e, loss in enumerate(history):
        loss = max(float(loss), 0.0)
        rms = math.sqrt(loss) * eb
        mse = loss * eb * eb
        if mse > 0.0 and vrange > 0.0:
            pred_psnr = (20.0 * math.log10(vrange)
                         - 10.0 * math.log10(mse))
        else:
            pred_psnr = float("inf")
        p_out = math.erfc(1.0 / math.sqrt(2.0 * loss)) if loss > 0.0 else 0.0
        rec = {
            "epoch": e,
            "loss": loss,
            "residual_rms": rms,
            "pred_psnr": pred_psnr,
            "pred_outlier_rate": p_out if mode == "strict" else 0.0,
            "pred_bitrate": base_bitrate + (_PRED_OUTLIER_BITS * p_out
                                            if mode == "strict" else 0.0),
        }
        if sample_psnr is not None and e < len(sample_psnr):
            rec["sample_psnr"] = float(sample_psnr[e])
        tel.record_trace(field, rec)
