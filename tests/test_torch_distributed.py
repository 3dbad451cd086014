"""The port's distributed layer over ``torch.distributed`` on the CPU (gloo).

One 2-rank and one 4-rank world are spawned (``tests/torch_dist_worker.py``,
which imports no JAX); every multi-rank check runs inside them and the
assertions run here, against the JAX package's arithmetic computed in this
process:

* ``compressed_psum`` on 2 ranks with equal ``max|g|`` equals the JAX
  package's formula (its ``quantize_ef`` per rank, the int32 sum, ``·
  scale / n``) bit for bit, mean and error-feedback carry; with scales 10×
  apart the port's mean stays within half a shared step of the true mean,
  where the JAX package's formula misses by more than 1.0; three steps of
  error feedback keep the running error within one step; the wire bytes
  are the int32 payload and one float32 a leaf;
* ``bf16_psum`` equals ``bf16(bf16(a) + bf16(b))``;
* the batched engine's stacked group split over a 2-rank field mesh;
* elastic: save from a 1×1 mesh, ``rescale`` onto 2×2 over 4 ranks and
  back, every shard its spec's slice, every tensor bit for bit, the
  moments placed as the params;
* ``constrain`` with and without a mesh, and the reduced qwen3-4b forward
  with and without its call sites;
* the batched engine's device choice for ``field_shard`` on a list of
  devices, its archive equal to the serial engine's.

NCCL takes one rank a device, so the card (one) runs these at world size 1
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``dist`` phase).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
import torch_dist_worker as W
from repro.optim import grad_compress as ref_gc
from repro_torch.core import archive as arc_io
from repro_torch.core import batched_engine, neurlz
from repro_torch.data import fields as port_fields

torch.set_num_threads(1)

SHAPE = (9, 20, 24)
EPOCHS = 2


def _inputs():
    rng = np.random.default_rng(0)
    # Equal max|g| on both ranks: draws clipped below 3, one entry at 3.
    equal = np.clip(rng.standard_normal((2, 64, 64)), -2.5, 2.5).astype(np.float32)
    equal[:, 0, 0] = 3.0
    bias = np.clip(rng.standard_normal((2, 3, 5)), -0.9, 0.9).astype(np.float32)
    bias[:, 1, 2] = -1.0
    mixed = np.stack([rng.standard_normal((64, 64)),
                      10 * rng.standard_normal((64, 64))]).astype(np.float32)
    steps = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    steps[1] *= 4
    fields = port_fields.make_fields("hurricane", SHAPE, seed=1)
    return {"equal": {"w": equal, "b": bias}, "mixed": mixed,
            "steps": [list(s) for s in steps],
            "bf16": rng.standard_normal((2, 50)).astype(np.float32),
            "fields": {"cloud": fields["cloud"], "w": fields["w"]},
            "epochs": EPOCHS}


INPUTS = _inputs()


def _ref_psum(gs):
    """The JAX package's compressed_psum arithmetic on per-rank gradients:
    ``quantize_ef`` on each rank, the int32 sum, the largest scale, ``/ n``
    (``src/repro/optim/grad_compress.py:57-72``).  ``(mean, [ef per rank],
    [scale per rank])``."""
    outs = [ref_gc.quantize_ef({"w": jnp.asarray(g)},
                               ref_gc.init_ef({"w": jnp.asarray(g)})) for g in gs]
    summed = sum(q["w"].astype(jnp.int32) for q, _, _ in outs)
    gmax = jnp.max(jnp.stack([s["w"] for _, s, _ in outs]))
    mean = (summed.astype(jnp.float32) * gmax) / len(gs)
    return (np.asarray(mean), [np.asarray(e["w"]) for _, _, e in outs],
            [float(s["w"]) for _, s, _ in outs])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return W.spawn(2, str(tmp_path_factory.mktemp("world2")),
                   ["psum_equal", "psum_mixed", "psum_ef_steps", "bf16",
                    "field_stacked"], INPUTS)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("world4")
    return W.spawn(4, str(d), ["elastic", "constrain", "forward_bits"],
                   {"ckpt_dir": str(d / "ckpt")})


def test_two_rank_world(two_ranks):
    # compressed_psum, equal scales: the JAX package's arithmetic bit for bit.
    for k, gs in INPUTS["equal"].items():
        mean, efs, scales = _ref_psum(gs)
        assert scales[0] == scales[1]
        for r, res in enumerate(two_ranks):
            got = res["psum_equal"]
            assert got["mean"][k].numpy().tobytes() == mean.tobytes(), k
            assert got["ef"][k].numpy().tobytes() == efs[r].tobytes(), k
    # The wire: the int32 sum (4 B a value) and one float32 maximum a leaf.
    stats = two_ranks[0]["psum_equal"]["stats"]
    assert stats["values"] == 64 * 64 + 3 * 5
    assert stats["wire_bytes"] == 4 * stats["values"] + 4 * 2

    # Scales 10x apart: within half a shared step of the true mean; the
    # JAX package's formula misses by more than 1.0.
    gs = INPUTS["mixed"]
    true = gs.astype(np.float64).mean(0)
    step = float(np.abs(gs).max()) / 127
    port = two_ranks[0]["psum_mixed"]["mean"].numpy()
    assert np.array_equal(port, two_ranks[1]["psum_mixed"]["mean"].numpy())
    assert np.abs(port - true).max() <= 0.5 * step
    ref_mean, _, scales = _ref_psum(gs)
    assert scales[1] > 5 * scales[0]
    assert np.abs(ref_mean - true).max() > 1.0

    # Three steps of error feedback: the running error within one step.
    res = [r["psum_ef_steps"] for r in two_ranks]
    steps = np.asarray(INPUTS["steps"], np.float64)          # [rank, t, ...]
    run_true = steps.mean(0).cumsum(0)
    run_port = np.cumsum([m.numpy() for m in res[0]["means"]], 0)
    for t in range(3):
        prev = [np.zeros((64, 64)) if t == 0 else r["efs"][t - 1].numpy()
                for r in res]
        shared = max(float(np.abs(steps[r, t] + prev[r]).max()) for r in range(2)) / 127
        assert np.abs(run_port[t] - run_true[t]).max() <= shared, t

    # bf16_psum: bf16(bf16(a) + bf16(b)) as float32, 2 B a value.
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in INPUTS["bf16"])
    want = (a + b).float()
    for r in two_ranks:
        assert torch.equal(r["bf16"]["sum"], want)
        assert r["bf16"]["stats"]["wire_bytes"] == 2 * 50

    # A stacked group over the 2-rank field mesh: each rank trains one of
    # the two fields; the archive equals one-field stacked groups'.
    cfg = neurlz.NeurLZConfig(epochs=EPOCHS, seed=0, engine="batched",
                              field_batching="vmap", group_size=1)
    alone = batched_engine.compress(INPUTS["fields"], rel_eb=1e-3, config=cfg,
                                    device="cpu")
    for r in two_ranks:
        got = r["field_stacked"]
        assert got["mesh"] == ("field",) and got["trained"] == [1]
        assert got["strategies"] == {"cloud,w": "vmap"}
        assert got["fields"] == arc_io.dumps(alone["fields"])


def test_four_rank_world(four_ranks):
    for res in four_ranks:
        el = res["elastic"]
        assert "bad" not in el, el.get("bad")
        assert el["host_mesh"] == (1, 1)
        assert el["step"] == (1, 1) and el["back_step"] == 1
        for name in ("params", "mu", "nu", "back_params", "back_mu", "back_nu"):
            assert el[f"{name}_leaves"] == 13
        # On 2x2 the matrices shard; on 1x1 every shard is the whole leaf.
        assert el["params_sharded"] == el["mu_sharded"] == el["nu_sharded"] == 8
        assert el["moments_follow"]

        c = res["constrain"]
        assert c["no_mesh_is_x"] and c["plain_is_x"]
        assert c["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
        assert c["full_equal"] and c["local_equal"]
        assert c["odd_placements"] == ["Replicate()", "Replicate()"]

        f = res["forward_bits"]
        assert f["same_bits"]
        # embed; per layer q, k, v, the attention output and its merged
        # heads, the MLP hidden, and the residual stream's three (the
        # layer's input, the attention and MLP outputs before they join it)
        assert f["calls"] == 1 + 2 * (6 + 3)
        assert f["specs"] == ["('batch', None, 'model')",
                              "('batch', None, 'model', None)",
                              "('batch', None, None)"]


# ---- field_shard's device choice ------------------------------------------

def test_field_shard_device_choice():
    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    # Two devices without prefetch: both train, groups alternate.
    assert batched_engine.conv_device(two, prefetch=False) is None
    train = batched_engine.training_devices(two, None)
    assert train == two
    assert [batched_engine.group_device(gi, train, "unroll", True, "d")
            for gi in range(5)] == [train[gi % 2] for gi in range(5)]
    # With prefetch the conventional stage takes the last device.
    assert batched_engine.conv_device(two, prefetch=True) == two[1]
    assert batched_engine.training_devices(two, two[1]) == two[:1]
    three = two + [torch.device("cpu", 2)]
    assert batched_engine.training_devices(three, three[2]) == two
    assert batched_engine.conv_device(two[:1], prefetch=True) is None
    # Stacked groups, field_shard off, or one device: the session's device.
    assert batched_engine.group_device(1, train, "vmap", True, "d") == "d"
    assert batched_engine.group_device(1, train, "unroll", False, "d") == "d"
    assert batched_engine.group_device(1, two[:1], "unroll", True, "d") == "d"
    assert batched_engine.session_devices(torch.device("cpu")) == [torch.device("cpu")]


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("field_shard", [True, False])
def test_field_shard_over_devices_equals_serial(monkeypatch, field_shard, prefetch):
    # Two CPU devices stand for two cards: without prefetch both train,
    # groups alternating; with it the conventional stage takes the second.
    monkeypatch.setattr(batched_engine, "session_devices",
                        lambda device: [torch.device("cpu")] * 2)
    fields = port_fields.make_fields("hurricane", SHAPE, seed=1)
    cfg = neurlz.NeurLZConfig(epochs=EPOCHS, seed=0, engine="batched",
                              field_batching="unroll", group_size=1,
                              field_shard=field_shard, prefetch=prefetch)
    arc = batched_engine.compress(fields, rel_eb=1e-3, config=cfg, device="cpu")
    serial = repro_torch.NeurLZ(epochs=EPOCHS, seed=0, device="cpu").compress(
        fields, rel_eb=1e-3)
    assert arc_io.dumps(arc["fields"]) == arc_io.dumps(serial["fields"])
