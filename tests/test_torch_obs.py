"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``: the same spans, counters and gauges under a patched clock
export to the same Chrome trace, JSONL log and summary; the same loss
history gives the same learning trace.  Then the port's serial engine with
telemetry at 2 epochs on the CPU: entries equal to an untraced run (with and
without the sample-PSNR hook), conv counters equal to ``ConvStats``, one
``train`` span per field under one root, the reference's timing keys.

No wall-time share is asserted here: the CPU tests run in parallel workers,
and the spans' cover of the root is checked at full size on the card
(``chip_smoke.py``).
"""
import io
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import archive as ref_archive
from repro_torch import obs as port_obs
from repro_torch.core import neurlz
from repro_torch.data import fields as port_fields

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)      # the shape of the port's other tests
EPOCHS = 2
FIELDS = port_fields.make_fields("hurricane", SHAPE, seed=1)
PACKAGES = {"port": port_obs, "ref": ref_obs}


def _record(obs, monkeypatch, writer) -> object:
    """One handle of ``obs`` fed a fixed sequence of events on a clock that
    ticks 1 ms a read: nested spans, a span on ``writer``'s thread (parented
    to the root), counters, a gauge trail and a learning trace.  Both
    packages take the same ``writer``, so the second thread's ident, which
    the exports carry, is the same in both records."""
    ticks = iter(range(1, 10_000))
    monkeypatch.setattr(time, "thread_time", lambda: 0.25)
    tel = obs.Telemetry()
    tel.epoch = 1_700_000_000.0
    tel._clock = lambda: next(ticks) * 1e-3
    with tel.span("compress", root=True, engine="serial", fields=2):
        with tel.span("conv", fields=2) as sp:
            tel.counter("conv.groups").add()
            tel.gauge("conv.group_size").set(2)
            sp.set(calls=1)
        for name in ("a", "b"):
            with tel.span("train", field=name):
                tel.counter("conv.dispatches").add(2)
        writer.submit(lambda: tel.span("write").__enter__().__exit__(
            None)).result(timeout=10)
        tel.gauge("conv.group_size").set(1.5)
        tel.counter("faults.degraded").add()
        with tel.span("assemble"):
            pass
    obs.learning_trace(tel, "a", [0.5, 0.25], eb=1e-3, vrange=2.0,
                       base_bytes=1000, n_points=500, mode="strict",
                       sample_psnr=[40.0, 41.5])
    return tel


@pytest.mark.parametrize("export", ["chrome_trace", "write_jsonl", "summary",
                                    "span_tree"])
def test_exports_equal_the_reference(monkeypatch, export):
    got = {}
    with ThreadPoolExecutor(1, thread_name_prefix="writer") as writer:
        tels = {tag: _record(obs, monkeypatch, writer)
                for tag, obs in PACKAGES.items()}
    for tag, obs in PACKAGES.items():
        tel = tels[tag]
        if export == "write_jsonl":
            buf = io.StringIO()
            assert obs.write_jsonl(tel, buf) == len(buf.getvalue().splitlines())
            got[tag] = buf.getvalue()
        elif export == "span_tree":
            got[tag] = {k: [vars(s) for s in v]
                        for k, v in tel.span_tree().items()}
        else:
            got[tag] = getattr(obs, export)(tel)
    assert got["port"] == got["ref"]
    if export == "chrome_trace":
        spans = [e for e in got["port"]["traceEvents"] if e["ph"] == "X"]
        assert [e["name"] for e in spans].count("train") == 2


@pytest.mark.parametrize("mode", ["strict", "relaxed"])
def test_learning_trace_equals_the_reference(mode):
    history = [2.0, 0.5, 0.0, -1e-9, 1e-30]
    traces = []
    for obs in PACKAGES.values():
        tel = obs.Telemetry()
        obs.learning_trace(tel, "f", history, eb=1e-3, vrange=3.5,
                           base_bytes=12345.0, n_points=4321, mode=mode,
                           sample_psnr=[50.0, 51.0, 52.0])
        traces.append(tel.trace("f"))
    assert traces[0] == traces[1]
    assert [r.get("sample_psnr") for r in traces[0]] == [50.0, 51.0, 52.0,
                                                         None, None]


def test_disabled_telemetry_is_shared_singletons():
    null = port_obs.NULL
    assert not null.enabled and port_obs.of(None) is null
    assert null.span("a") is null.span("b", root=True, x=1)
    assert null.counter("a") is null.counter("b")
    assert null.gauge("a") is null.gauge("b")
    assert null.summary() == {} and null.counters == {}
    assert port_obs.build_timing(null, total_s=1.0, conv_s=0.5, train_s=0.25,
                                 conv_stage={}) == ref_obs.build_timing(
        ref_obs.NULL, total_s=1.0, conv_s=0.5, train_s=0.25, conv_stage={})


def _compress(telemetry=None):
    cfg = neurlz.NeurLZConfig(epochs=EPOCHS, telemetry=telemetry)
    return neurlz.compress_impl(FIELDS, 1e-3, config=cfg, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """The port's archive untraced, traced, and traced with sample PSNR."""
    traced = port_obs.Telemetry()
    sampled = port_obs.Telemetry(port_obs.TelemetryConfig(sample_psnr=True,
                                                          sample_slices=3))
    return {"off": (None, _compress()),
            "on": (traced, _compress(traced)),
            "sample_psnr": (sampled, _compress(sampled))}


@pytest.mark.parametrize("kind", ["on", "sample_psnr"])
def test_telemetry_leaves_the_archive_unchanged(runs, kind):
    assert (ref_archive.dumps(runs[kind][1]["fields"])
            == ref_archive.dumps(runs["off"][1]["fields"]))


def test_conv_counters_equal_conv_stats(runs):
    tel, arc = runs["on"]
    cs = arc["timing"]["conv_stage"]
    c = tel.counters
    assert (c["conv.dispatches"], c["conv.groups"]) == (cs["calls"],
                                                        cs["groups"])
    assert c.get("conv.batched_fields", 0) == cs["batched_fields"]
    assert c.get("conv.fallback_fields", 0) == cs["fallback_fields"]
    assert tel.gauges["conv.group_size"]["max"] == len(FIELDS)


def test_one_train_span_per_field_under_one_root(runs):
    tel, _ = runs["on"]
    roots = [s for s in tel.spans if s.name == "compress"]
    assert len(roots) == 1 and roots[0].parent is None
    kids = [s for s in tel.spans if s.parent == roots[0].id]
    assert [s.name for s in kids] == ["conv", "train", "train", "train",
                                      "assemble"]
    assert [s.attrs["field"] for s in kids if s.name == "train"] == list(FIELDS)
    assert all(s.t0 + s.dur <= roots[0].t0 + roots[0].dur for s in kids)
    trace = json.loads(json.dumps(tel.chrome_trace()))
    assert [e["name"] for e in trace["traceEvents"]].count("train") == len(FIELDS)


def test_timing_keys_cover_the_reference(runs):
    for kind, (tel, arc) in runs.items():
        timing = arc["timing"]
        assert set(ref_obs.TIMING_KEYS) <= set(timing)
        assert timing["degraded_fields"] == []
        assert ("spans" in timing) == (tel is not None)
        assert {"predict_s", "enhance_s", "pack_s", "device"} <= set(timing)
    _, arc = runs["on"]
    assert arc["timing"]["spans"]["train"]["count"] == len(FIELDS)


def test_learning_traces_one_record_per_epoch(runs):
    for kind in ("on", "sample_psnr"):
        tel, arc = runs[kind]
        assert sorted(tel.traces) == sorted(FIELDS)
        for name in FIELDS:
            recs = tel.trace(name)
            assert [r["epoch"] for r in recs] == list(range(EPOCHS))
            assert [r["loss"] for r in recs] == pytest.approx(
                arc["fields"][name]["loss_history"])
            assert ("sample_psnr" in recs[0]) == (kind == "sample_psnr")
    tel, _ = runs["sample_psnr"]
    assert all(np.isfinite(r["sample_psnr"]) for n in FIELDS
               for r in tel.trace(n))
