"""The port's fault tolerance (``repro_torch.faults``) against the JAX
package's ``repro.faults``: injector plans fire at the same invocations,
retries take the same attempts, backoff and counters; a degraded aux
producer leaves its consumer unchanged, and without degradation the
failure is raised.  That a field degraded by injection or by a non-finite
loss packs to the same bytes as the reference's degraded entry, at 2
epochs on the 9×20×24 snapshot, is held in ``test_torch_e2e.py``, beside
the reference's main-path run whose compiles it shares.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import faults as ref_faults
from repro import obs as ref_obs
from repro.core import archive as ref_archive
from repro.data import fields as ref_fields
from repro_torch import faults as port_faults
from repro_torch import obs as port_obs
from repro_torch.core import neurlz
from repro_torch.core import online_trainer as port_trainer

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)      # the shape of the port's other tests
EPOCHS, REL_EB = 2, 1e-3
FIELDS = ref_fields.make_fields("hurricane", SHAPE, seed=1)
PACKAGES = {"port": (port_faults, port_obs), "ref": (ref_faults, ref_obs)}


def _fire_pattern(faults, plan, sites):
    inj = faults.FaultInjector(plan)
    fired = []
    for site in sites:
        try:
            inj.check(site)
        except faults.InjectedFault as e:
            fired.append((e.site, e.invocation, str(e)))
    return fired, inj.hits, {s: inj.count(s) for s in set(sites)}


@pytest.mark.parametrize("plan", [{"writer.add_entry": 1}, {"train.*": 0},
                                  {"s": [0, 2], "train.w": 3},
                                  {"decode.entry": range(1, 4)}])
def test_injector_plans_fire_as_the_reference(plan):
    sites = (["writer.add_entry", "s", "train.cloud", "train.w", "decode.entry"]
             * 5)
    got = [_fire_pattern(f, plan, sites) for f, _ in PACKAGES.values()]
    assert got[0] == got[1]
    assert port_faults.NULL_INJECTOR.check("s") is None
    assert port_faults.NULL_INJECTOR.count("s") == 0


def _retry(faults, obs, fails: int, exc, attempts: int):
    """Run a call that raises ``exc`` ``fails`` times under a policy of
    ``attempts``; returns what a caller observes."""
    tel = obs.Telemetry()
    sleeps, calls = [], []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc("transient")
        return "ok"

    policy = faults.RetryPolicy(attempts=attempts, backoff_s=0.01,
                                multiplier=3.0, max_backoff_s=0.05)
    try:
        out = faults.retry_with_backoff(fn, policy, site="io", tel=tel,
                                        sleep=sleeps.append)
    except exc as e:
        out = f"raised {type(e).__name__}"
    return out, len(calls), sleeps, tel.counters


@pytest.mark.parametrize("fails,exc,attempts", [
    (0, OSError, 3), (2, OSError, 3), (3, OSError, 3), (4, OSError, 6),
    (1, TypeError, 3)])
def test_retry_matches_the_reference(fails, exc, attempts):
    got = [_retry(f, o, fails, exc, attempts) for f, o in PACKAGES.values()]
    assert got[0] == got[1]
    out, ncalls, sleeps, counters = got[0]
    if exc is TypeError:           # not in retry_on: the first raise escapes
        assert (out, ncalls, counters) == ("raised TypeError", 1, {})
    else:
        assert ncalls == min(fails + 1, attempts)
        assert sleeps == pytest.approx([min(0.01 * 3 ** i, 0.05)
                                        for i in range(ncalls - 1)])
        assert counters.get("faults.retries", 0) == len(sleeps)


def test_fault_config_run_heals_an_injected_transient():
    results = []
    for faults, obs in PACKAGES.values():
        tel = obs.Telemetry()
        fc = faults.FaultConfig(injector=faults.FaultInjector({"x": 0}),
                                retry=faults.RetryPolicy(backoff_s=0.0))
        results.append((fc.run(lambda: 7, site="x", tel=tel), tel.counters,
                        fc.injector.hits))
        with pytest.raises(faults.InjectedFault):
            faults.FaultConfig(injector=faults.FaultInjector({"x": 0})).run(
                lambda: 7, site="x")
        assert faults.of(None) is faults.DEFAULT and faults.DEFAULT.degrade
    assert results[0] == results[1]
    assert results[0][1] == {"faults.retries": 1, "faults.retries.x": 1}


def test_is_degradable_takes_cuda_out_of_memory_by_type():
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
    assert port_faults.is_degradable(oom)
    assert port_faults.degrade_reason(oom) == "error:OutOfMemoryError"
    for exc in (MemoryError(), FloatingPointError(),
                port_faults.InjectedFault("train.w", 0)):
        assert port_faults.is_degradable(exc)
    for exc in (TypeError("bug"), ValueError("shape"), RuntimeError("other")):
        assert not port_faults.is_degradable(exc)
    for faults, _ in PACKAGES.values():
        assert faults.degrade_reason() == "non-finite-loss"
        assert faults.degrade_reason(faults.InjectedFault("s", 0)) == "injected"
        assert faults.degrade_reason(MemoryError()) == "error:MemoryError"


def _port(fields=FIELDS, **kw):
    cfg = neurlz.NeurLZConfig(epochs=EPOCHS, **kw)
    return neurlz.compress_impl(fields, REL_EB, config=cfg, device="cpu")


def _decode(arc):
    return repro_torch.Archive.from_dict(arc, device="cpu").decode_all()


def test_without_degradation_the_failure_is_raised(monkeypatch):
    with pytest.raises(port_faults.InjectedFault):
        _port(faults=port_faults.FaultConfig(
            injector=port_faults.FaultInjector({"train.precip": 0}),
            degrade=False))

    def bug(*args, **kw):
        raise TypeError("a bug, not a fault")

    monkeypatch.setattr(port_trainer, "train", bug)
    with pytest.raises(TypeError, match="a bug"):
        _port()


def test_a_degraded_aux_producer_leaves_its_consumer_unchanged():
    sub = {k: FIELDS[k] for k in ("cloud", "w")}
    cross = {"cloud": ("w",)}
    base = _port(sub, cross_field=cross)
    arc = _port(sub, cross_field=cross, faults=port_faults.FaultConfig(
        injector=port_faults.FaultInjector({"train.w": 0})))
    assert arc["fields"]["w"]["degraded"] == "injected"
    assert arc["fields"]["cloud"]["aux"] == ["w"]
    assert (ref_archive.dumps(arc["fields"]["cloud"])
            == ref_archive.dumps(base["fields"]["cloud"]))
    assert np.array_equal(_decode(arc)["cloud"], _decode(base)["cloud"])
