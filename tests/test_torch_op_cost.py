"""The port's operation counter (``launch.op_cost``) against the JAX
package's loop-aware HLO analyzer (``repro.launch.hlo_cost``).

The analyzer's three graphs (a matmul, a scan of 12, a scan of 3 over a
scan of 4) run here as eager torch: the matmul's FLOPs equal the
reference's exactly; the loops' within 1% (the reference's test accepts
0.95–1.3 of the products' count for its own).  Bytes: ``x + y`` of N
float32 moves 12·N, a view 0.  Per device under DTensor (a fake 4×4 world
in a process of its own, ``tests/torch_dryrun_worker.py``): the sharded
matmul of ``x [M,K]`` rows over ``data`` by ``w`` over both axes counts
2·M·K·N / 16 on the first call and the second (DTensor's sharding
propagation runs the product once more at the global shape on the first,
which the counter leaves out), and its all-gather with its group size and
ring factor; ``torch.distributed.all_reduce`` (a ``c10d`` operation) with
the world's.  A fake call of the grouped conv counts the kernel's work,
not its plain version's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_cost
from repro_torch.kernels import conv2d3x3 as conv
from repro_torch.launch import op_cost, roofline

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
LOOP_TOL = 0.01


def _ref(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(f).lower(*args).compile().as_text())["flops"]


def test_matmul_flops_equal_the_reference():
    a, b = torch.randn(128, 256), torch.randn(256, 64)
    got = op_cost.analyze(lambda: a @ b)
    assert got["flops"] == _ref(lambda a, b: a @ b, (128, 256), (256, 64))
    assert got["flops"] == 2 * 128 * 256 * 64
    assert got["bytes"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_scan_flops_within_tolerance_of_the_reference():
    def jax_g(x, ws):
        def step(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(step, x, ws)[0]

    def torch_g(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    ref = _ref(jax_g, (64, 64), (12, 64, 64))
    got = op_cost.analyze(torch_g, torch.randn(64, 64), torch.randn(12, 64, 64))
    assert abs(got["flops"] - ref) <= LOOP_TOL * ref, (got["flops"], ref)
    assert got["product_flops"] == 12 * 2 * 64 ** 3
    assert got["transcendentals"] == 12 * 64 * 64


def test_nested_scan_flops_within_tolerance_of_the_reference():
    def jax_g(x, ws):
        def outer(x, w):
            def inner(x, _):
                return jnp.sin(x) @ w, None
            return jax.lax.scan(inner, x, None, length=4)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    def torch_g(x, ws):
        for w in ws:
            for _ in range(4):
                x = torch.sin(x) @ w
        return x

    ref = _ref(jax_g, (32, 32), (3, 32, 32))
    got = op_cost.analyze(torch_g, torch.randn(32, 32), torch.randn(3, 32, 32))
    assert abs(got["flops"] - ref) <= LOOP_TOL * ref, (got["flops"], ref)
    assert got["product_flops"] == 3 * 4 * 2 * 32 ** 3


@pytest.mark.parametrize("n", [1000, 4096])
def test_elementwise_bytes_and_views(n):
    x, y = torch.randn(n), torch.randn(n)
    got = op_cost.analyze(lambda: x + y)
    assert got["bytes"] == 12 * n and got["flops"] == n
    assert got["peak_bytes"] == 4 * n
    view = op_cost.analyze(lambda: x.view(2, n // 2).t())
    assert view["bytes"] == 0 and view["flops"] == 0 and view["peak_bytes"] == 0


def test_peak_counts_live_storages_only():
    x = torch.randn(1000)

    def f():
        a = x * 2          # 4 kB live
        b = a + 1          # 8 kB live
        del a              # 4 kB
        return b * 3       # 8 kB again, never 12
    got = op_cost.analyze(f)
    assert got["peak_bytes"] == 8000


def test_fake_grouped_conv_counts_the_kernel():
    nf, n, side, cin, cout = 2, 3, 24, 2, 4
    with torch.device("meta"):
        x = torch.empty(nf * n, side, side, cin, requires_grad=True)
        w = torch.empty(nf, 3, 3, cin, cout, requires_grad=True)
        b = torch.empty(nf, cout, requires_grad=True)

    def step():
        y = conv.conv3x3_grouped(x, w, b, stride=2)
        y.sum().backward()
        return y
    got = op_cost.analyze(step)
    y = got["out"]
    assert y.shape == (nf * n, side // 2, side // 2, cout)
    fwd = 2.0 * y.numel() * 9 * cin
    k = got["by_kernel"]
    assert k["conv2d3x3_grouped"] == {
        "calls": 1, "flops": fwd,
        "bytes": 4.0 * (x.numel() + w.numel() + b.numel() + y.numel())}
    assert k["conv2d3x3_grouped_bwd"]["calls"] == 1
    assert k["conv2d3x3_grouped_bwd"]["flops"] == 2 * fwd      # dgrad + wgrad
    # x, w, g, y read; dx, dw, db written
    assert k["conv2d3x3_grouped_bwd"]["bytes"] == 4.0 * (
        2 * x.numel() + 2 * w.numel() + 2 * y.numel() + b.numel())
    # Only the kernels' products: the plain version's nine GEMMs a layer
    # would be bmm/mm operations.
    assert got["product_flops"] == 3 * fwd
    assert got["product_flops_by_dtype"] == {"float32": 3 * fwd}


def test_products_by_operand_dtype():
    """Products are kept by their operands' dtype, for the roofline's
    float32 rate; an elementwise operation is in no product count."""
    a16, b16 = torch.randn(32, 64, dtype=torch.bfloat16), torch.randn(
        64, 16, dtype=torch.bfloat16)
    a32, b32 = a16.float(), b16.float()
    got = op_cost.analyze(lambda: (a16 @ b16, torch.bmm(a32[None], b32[None]) + 1))
    mm = 2.0 * 32 * 64 * 16
    assert got["product_flops_by_dtype"] == {"bfloat16": mm, "float32": mm}
    assert got["product_flops"] == 2 * mm
    assert got["flops"] == 2 * mm + 32 * 16


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    p = subprocess.run([sys.executable, str(HERE / "torch_dryrun_worker.py"),
                        str(out), "sharded_matmul"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(out.read_text())["sharded_matmul"]


def test_fake_world_counts_one_device(fake_world):
    """One test for the subprocess's results: a module fixture runs once
    per xdist worker, so its tests stay together."""
    for c in fake_world["calls"]:                 # the first call and the next
        assert c["product_flops"] == fake_world["global_flops"] / 16
        assert c["flops"] == c["product_flops"]
    first, second = fake_world["calls"]
    assert first["collectives"] == second["collectives"]
    gathers = [c for c in first["collectives"] if c["kind"] == "all-gather"]
    assert gathers, first["collectives"]
    for c in gathers:
        assert c["group_size"] == 4
        assert c["wire_bytes"] == c["result_bytes"] * roofline.wire_factor(
            "all-gather", 4)
    # torch.distributed.all_reduce: a c10d operation on the world's group.
    (c,) = fake_world["c10d"]
    assert c["kind"] == "all-reduce" and c["group_size"] == 16
    assert c["result_bytes"] == 4000 and c["link"] == "net"
    assert c["wire_bytes"] == 4000 * roofline.wire_factor("all-reduce", 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_train_step_products(early_stop, dtype):
    """The reduced qwen3-4b's train step under full remat counts four
    forwards' products (the run, its recomputation, the backward's two a
    product), less what torch's checkpoint does not recompute: with its
    early stop (the default) a layer's recomputation ends at the last
    tensor the backward needs, before the MLP's down projection.  In
    bfloat16 only attention's scores and their gradients are float32
    products: the probabilities meet V in the model's dtype."""
    import dataclasses

    import torch.utils.checkpoint as ck

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"), dtype=dtype)
    b, s = 2, 32
    model = M.build_model(cfg, model_axis=1)
    params, opt = M.init_train_state(model, seed=0, device="cpu")
    step = M.make_train_step(model, remat_policy="nothing")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32)}
    with ck.set_checkpoint_early_stop(early_stop):
        res = op_cost.analyze(step, params, opt, batch, 0)
    got = res["product_flops"]
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    layer = 2 * b * s * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f)
    attn = 4 * b * h * s * s * hd
    head = 2 * b * (s - 1) * d * cfg.vocab_size
    want = 4 * (cfg.n_layers * (layer + attn) + head)
    if early_stop:
        want -= cfg.n_layers * 2 * b * s * d * f
    assert got == want
    f32 = 4 * cfg.n_layers * 2 * b * h * s * s * hd
    assert res["product_flops_by_dtype"] == (
        {"float32": want} if dtype == "float32"
        else {"bfloat16": want - f32, "float32": f32})


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_train_step_products(arch):
    """The reduced MoE train steps (bfloat16, full remat) count four
    forwards' products: attention, the float32 router over every expert,
    every capacity slot of every expert through its FFN (the batched
    products run empty slots too), the shared experts, the dense first
    layers and the head over the padded vocabulary; less the dense layers'
    down projection, which the checkpoint does not recompute.  A MoE
    layer's recomputation runs to its aux loss, after its last product."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.transformer import pad_vocab

    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16")
    b, s = 2, 32
    model = M.build_model(cfg, model_axis=1)
    params, opt = M.init_train_state(model, seed=0, device="cpu")
    step = M.make_train_step(model, remat_policy="nothing")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32)}
    res = op_cost.analyze(step, params, opt, batch, 0)
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    t, f, nd = b * s, cfg.d_ff_expert, cfg.first_dense_layers
    attn = 2 * t * (d * h * hd + 2 * d * kv * hd + h * hd * d)
    scores = 2 * b * h * s * s * hd
    g_sz = min(cfg.moe_group_size, s)
    slots = t // g_sz * cfg.n_experts * moe.capacity(cfg, g_sz)
    experts = 2 * slots * 3 * d * f + 2 * t * 3 * d * cfg.n_shared_experts * f
    router = 2 * t * d * cfg.n_experts
    dense = attn + 2 * t * 3 * d * cfg.d_ff_dense
    head = 2 * b * (s - 1) * d * pad_vocab(cfg.vocab_size)
    f32 = 4 * ((cfg.n_layers - nd) * (scores + router) + nd * scores)
    bf16 = 4 * ((cfg.n_layers - nd) * (attn + scores + experts)
                + nd * (dense + scores) + head) - nd * 2 * t * d * cfg.d_ff_dense
    assert res["product_flops_by_dtype"] == {"bfloat16": bf16, "float32": f32}
