"""Telemetry exporters: JSONL event log, Chrome/Perfetto trace, summary.

Three consumers, three formats:

* :func:`write_jsonl` — an append-friendly line-per-event log (meta line,
  then one line per span / counter / gauge sample / learning-trace record).
  Greppable, ``jq``-able, and stable enough to diff across runs.
* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome
  ``trace_event`` JSON (the format Perfetto and ``chrome://tracing``
  consume): spans become complete (``"X"``) events keyed by thread, so the
  streaming pipeline's reader/scheduler/writer overlap renders as a flame
  graph; gauges with sample trails become counter (``"C"``) tracks (e.g.
  resident bytes riding under the ledger ceiling).
* :meth:`Telemetry.summary` — the aggregated dict (defined on the handle;
  re-exported here for symmetry).
"""
from __future__ import annotations

import json
import os

from .telemetry import Telemetry

__all__ = ["write_jsonl", "chrome_trace", "write_chrome_trace", "summary"]


def _open_sink(sink, mode: str):
    if isinstance(sink, (str, bytes, os.PathLike)):
        return open(sink, mode), True
    return sink, False


def summary(tel: Telemetry) -> dict:
    return tel.summary()


def write_jsonl(tel: Telemetry, sink) -> int:
    """Write the run's events as JSON lines; returns lines written."""
    f, own = _open_sink(sink, "w")
    n = 0

    def emit(obj) -> None:
        nonlocal n
        f.write(json.dumps(obj, default=float) + "\n")
        n += 1

    try:
        emit({"type": "meta", "epoch_unix_s": tel.epoch,
              "dropped_spans": tel.dropped_spans})
        for s in tel.spans:
            emit({"type": "span", "id": s.id, "parent": s.parent,
                  "name": s.name, "thread": s.thread_name,
                  "t0_s": s.t0, "dur_s": s.dur, "cpu_s": s.cpu,
                  **({"attrs": s.attrs} if s.attrs else {})})
        for name, value in tel.counters.items():
            emit({"type": "counter", "name": name, "value": value})
        for name, g in tel._gauges.items():
            emit({"type": "gauge", "name": name, "last": g.value,
                  "min": g.vmin, "max": g.vmax})
        for field, records in tel.traces.items():
            for rec in records:
                emit({"type": "learning_trace", "field": field, **rec})
    finally:
        if own:
            f.close()
    return n


def chrome_trace(tel: Telemetry) -> dict:
    """The run as a Chrome ``trace_event`` dict (load in Perfetto)."""
    pid = os.getpid()
    events: list[dict] = []
    threads: dict[int, str] = {}
    for s in tel.spans:
        threads.setdefault(s.thread, s.thread_name)
        events.append({
            "ph": "X", "name": s.name, "cat": "neurlz",
            "pid": pid, "tid": s.thread,
            "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
            "args": {**s.attrs, "cpu_ms": round(s.cpu * 1e3, 3)},
        })
    meta = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": tname}} for tid, tname in threads.items()]
    counters = []
    for name, g in tel._gauges.items():
        for ts, value in g.samples:
            counters.append({"ph": "C", "name": name, "cat": "neurlz",
                             "pid": pid, "tid": 0, "ts": ts * 1e6,
                             "args": {name.rsplit(".", 1)[-1]: value}})
    return {"traceEvents": meta + events + counters,
            "displayTimeUnit": "ms",
            "otherData": {"counters": tel.counters,
                          "dropped_spans": tel.dropped_spans}}


def write_chrome_trace(tel: Telemetry, sink) -> int:
    """Serialize :func:`chrome_trace` to ``sink``; returns bytes written."""
    data = json.dumps(chrome_trace(tel), default=float)
    f, own = _open_sink(sink, "w")
    try:
        f.write(data)
    finally:
        if own:
            f.close()
    return len(data)
