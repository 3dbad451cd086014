"""Observability for the port's engine: spans, counters, learning traces.

Usage::

    import repro_torch
    from repro_torch import obs

    tel = obs.Telemetry()
    arc = repro_torch.NeurLZ(telemetry=tel).compress(fields, rel_eb=1e-3)

    tel.export_chrome_trace("trace.json")   # flame graph in Perfetto
    tel.export_jsonl("events.jsonl")        # line-per-event log
    tel.summary()                           # aggregated dict
    tel.trace("cloud")                      # per-epoch learning trajectory

Pass no telemetry (the default) and every instrumentation point is a shared
no-op singleton: the disabled path allocates nothing, waits for no device,
and archives are byte-identical to an instrumented run's.  The records and
exports equal the JAX package's ``repro.obs`` for the same events.
"""
from .telemetry import (NULL, TIMING_KEYS, Counter, Gauge,  # noqa: F401
                        NullTelemetry, SpanRecord, Telemetry,
                        TelemetryConfig, build_timing, learning_trace, of)
from .export import (chrome_trace, summary, write_chrome_trace,  # noqa: F401
                     write_jsonl)

__all__ = [
    "Telemetry", "TelemetryConfig", "NullTelemetry", "NULL", "of",
    "Counter", "Gauge", "SpanRecord", "TIMING_KEYS",
    "build_timing", "learning_trace",
    "write_jsonl", "chrome_trace", "write_chrome_trace", "summary",
]
