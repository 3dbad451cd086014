"""The port's dry run (``launch.dryrun``) on small fake worlds, and the
model on DTensors against the plain model.

* On a fake 2×2 world (a process of its own, ``tests/torch_dryrun_worker.py``)
  the reduced qwen3-4b's ``train`` and ``decode`` cells lower with
  ``status: ok``, their records carry the JAX package's keys (less the
  XLA-only ones) and the H100 roofline terms, and their ``argument_bytes``
  equal the local shard bytes that the JAX package's ``sharding`` rules
  give on the same mesh shape (params, AdamW's float32 moments, inputs,
  cache; the port's step count is a host integer).  A small
  ``neurlz_enhance`` (4 blocks, side 24, 2 slices) counts one block a
  device, the grouped conv kernels as kernels, and one float32 all-reduce.
  Then, in the same process, on a fake {data: 2, model: 16} world (a model
  axis that splits none of the reduced presets' heads and pads their 8
  experts to 16), the reduced granite-moe and deepseek-moe (train,
  decode), xlstm-350m (train, decode) and zamba2-7b (train, prefill, and
  decode at batch 1, its KV cache split over its sequence) lower ``ok``
  with the JAX package's ``argument_bytes``, and the perf flags lower on
  them (``inert_flags`` names those that mean nothing for a cell).
* On a 4-rank gloo world of spawned CPU ranks (``tests/torch_dist_worker.py``)
  the reduced qwen3-4b's loss and gradients on DTensor-placed parameters
  over 2×2, one train step at microbatch 2, and (with one kv head, whose
  decode cache splits its head dim) two decode steps equal the plain
  single-process ones within DTENSOR_TOL of each tensor's largest value:
  the model changes the dry run needs change no numbers.  So do the
  reduced MoE, xLSTM and zamba2 models (``torch_dist_worker.FAMILY_CASES``:
  experts padded 6 → 8 over ``model`` 4, heads that do not split, a
  sequence-split decode cache at batch 1).
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
import torch_dryrun_worker as DW
from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.distributed import sharding as ref_sh
from repro.models import model as ref_M
from repro_torch.models import model as M
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_items, tree_leaves, tree_unflatten

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
MESH = {"data": 2, "model": 2}
# Float32 sums split over two ranks and reduced in another order.
DTENSOR_TOL = 1e-5
# An updated parameter, in steps of the learning rate, where its gradient
# is at least 1e-5 of its leaf's largest: Adam's first step is
# g / (|g| + eps), which a gradient's last bits move where |g| is at its
# rounding noise (chip_smoke.py's card-vs-CPU update gate, the same).
STEP_TOL = 1e-2
LR = 1e-3
XLA_ONLY = {"compile_s"}
RECORD_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "remat", "seq_shard",
               "microbatch", "skip_uncausal", "moe_group", "sp_residual",
               "lower_s", "memory", "cost", "collectives", "roofline",
               "model_flops_per_device", "useful_compute_ratio",
               "n_active_params", "n_params", "inert_flags"}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    p = subprocess.run([sys.executable, str(HERE / "torch_dryrun_worker.py"),
                        str(out), "cells"], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(out.read_text())["cells"]


def _ref_local_bytes(tree, specs, sizes=MESH) -> int:
    """Bytes one device holds of a ``jax.eval_shape`` tree under the
    reference's specs on a mesh of ``sizes``."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n //= sizes[a]
        total += n
    return total


def _ref_args(kind: str, arch: str = "qwen3-4b", seq: int = 64, batch: int = 8,
              sizes=MESH) -> int:
    """The local bytes of a cell's arguments under the JAX package's rules:
    params, inputs, and AdamW's float32 moments (train) or the cache
    (decode)."""
    cfg = ref_configs.get_reduced(arch)
    model = ref_M.build_model(cfg, model_axis=sizes["model"])
    mesh = SimpleNamespace(shape=sizes)
    params = ref_M.abstract_params(model)
    pspecs = ref_sh.param_pspecs(params, mesh)
    shape = RefShape("s", seq, batch, kind)
    specs = ref_M.input_specs(cfg, shape)
    total = (_ref_local_bytes(params, pspecs, sizes)
             + _ref_local_bytes(specs, ref_sh.input_pspecs(specs, mesh), sizes))
    if kind == "train":     # the float32 moments, placed as the params
        f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32),
                           params)
        total += 2 * _ref_local_bytes(f32, pspecs, sizes)
    elif kind == "decode":
        cache = ref_M.abstract_cache(model, batch, seq)
        total += _ref_local_bytes(cache, ref_sh.cache_pspecs(cache, mesh, batch),
                                  sizes)
    return total


def test_fake_world_cells(cells):
    """One test for the subprocess's results (a module fixture runs once
    per xdist worker, so its checks stay together)."""
    for kind in ("train", "decode"):
        rec = cells[kind]
        assert rec["status"] == "ok", (kind, rec.get("error"))
        assert RECORD_KEYS <= set(rec) and not XLA_ONLY & set(rec)
        assert rec["mesh"] == MESH and rec["n_chips"] == 4
        mem = rec["memory"]
        assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                            "alias_bytes", "peak_hbm_bytes"}
        assert mem["peak_hbm_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert mem["argument_bytes"] == _ref_args(kind), kind
        r, cost = rec["roofline"], rec["cost"]
        f32 = cost["product_flops_by_dtype"].get("float32", 0.0)
        assert f32 > 0, kind     # the float32 attention scores
        assert r["compute_s"] == pytest.approx(
            (cost["flops_per_device"] - f32) / 989e12 + f32 / 67e12)
        assert r["memory_s"] * 3.35e12 == pytest.approx(cost["bytes_per_device"])
        assert r["dominant"] in ("compute", "memory", "collective")
        assert cost["flops_per_device"] > 0 and rec["collectives"]["wire_bytes"] > 0

    # Every product of the 2x2 train step is split four ways: no device
    # repeats another's (a partial gradient handed to a row-parallel
    # product's backward made it gather the weight and repeat the product).
    plain = cells["train_plain"]
    assert plain["status"] == "ok", plain.get("error")
    assert plain["n_chips"] == 1 and plain["collectives"]["wire_bytes"] == 0
    assert {k: 4 * v for k, v in
            cells["train"]["cost"]["product_flops_by_dtype"].items()} == \
        plain["cost"]["product_flops_by_dtype"]

    rec = cells["enhance"]
    assert rec["n_chips"] == 4 and rec["blocks_per_device"] == 1
    assert rec["collectives"]["per_kind_count"] == {"all-reduce": 1}
    assert rec["collectives"]["per_kind_result_bytes"] == {"all-reduce": 4}
    k = rec["cost"]["kernels"]
    # conv_in, down1-4 and conv_out: six grouped forwards and backwards.
    assert k["conv2d3x3_grouped"]["calls"] == 6
    assert k["conv2d3x3_grouped_bwd"]["calls"] == 6

    # The MoE, xLSTM and zamba2 cells on a model axis that splits none of
    # their heads and pads their experts.
    for case, arch, kind, seq, batch, _ in DW.WIDE_CELLS:
        rec = cells[case]
        assert rec["status"] == "ok", (case, rec.get("error"))
        assert rec["mesh"] == DW.WIDE_MESH and rec["n_chips"] == 32
        assert rec["memory"]["argument_bytes"] == _ref_args(
            kind, arch, seq, batch, DW.WIDE_MESH), case
        coll = rec["collectives"]["per_kind_count"]
        if "granite" in case or "deepseek" in case:
            # the experts' partial outputs summed over model
            assert coll.get("all-reduce", 0) > 0, (case, coll)
    # --moe-group, --seq-shard, --sp-residual on the new families: ok;
    # where a flag means nothing for the cell, the record says so.
    rec = cells["granite_prefill_flags"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["moe_group"] == 16 and rec["inert_flags"] == []
    rec = cells["xlstm_decode_flags"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["inert_flags"] == ["moe_group", "seq_shard", "skip_uncausal"]


# ---- the model on DTensors, over gloo ----------------------------------------

@pytest.fixture(scope="module")
def dtensor_ranks(tmp_path_factory):
    return W.spawn(4, str(tmp_path_factory.mktemp("dtensor")),
                   ["dtensor_steps", "dtensor_families"], {})


def _close(got, want, what, atol=None):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-12)
    tol = DTENSOR_TOL * scale if atol is None else atol
    err = float((got - want).abs().max())
    assert err <= tol, (what, err, tol)


def _close_tree(got, want, what, atol=None):
    want = dict(tree_items(want))
    for path, g in tree_items(got):
        _close(g, want[path], f"{what} {'/'.join(path)}", atol)


def test_dtensor_model_equals_plain(dtensor_ranks):
    """One test for the spawned world's results (see above)."""
    for kv in (2, 1):
        cfg, model, params, batch = W.dtensor_model(kv)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = model.loss(params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        for res in dtensor_ranks:
            r = res["dtensor_steps"][f"kv{kv}"]
            _close(r["loss"], loss, f"loss kv{kv}")
            _close_tree(r["grads"], grads, f"grad kv{kv}")
    _check_train_step(dtensor_ranks)
    _check_decode(dtensor_ranks)
    _check_families(dtensor_ranks)


def _check_train_step(dtensor_ranks):
    cfg, model, params, batch = W.dtensor_model(2)
    leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
    grads = torch.autograd.grad(model.loss(tree_unflatten(params, leaves), batch),
                                leaves)
    params = model.load_params(params)
    step = M.make_train_step(model, lr=LR, microbatch=2)
    new, _, met = step(params, adamw_init(params), batch, 0)
    new = tree_leaves(new)
    for res in dtensor_ranks:
        r = res["dtensor_steps"]["kv2"]
        _close(r["step_loss"], met["loss"], "step loss")
        # chip_smoke.update_err's gate: entries whose gradient is at least
        # 1e-5 of its leaf's largest, where one Adam step is sign(g).
        for got, want, g in zip(tree_leaves(r["step_params"]), new, grads,
                                strict=True):
            g = g.abs()
            keep = g >= 1e-5 * float(g.max())
            gap = (got.float() - want.detach().float()).abs()[keep]
            assert float(gap.max()) <= STEP_TOL * LR


def _check_decode(dtensor_ranks):
    cfg, model, params, batch = W.dtensor_model(1)
    cache = model.init_cache(4, 8, device="cpu")
    with torch.no_grad():
        logits = [model.decode_step(params, cache, batch["tokens"][:, :1], pos)[0]
                  for pos in (0, 1)]
    for res in dtensor_ranks:
        r = res["dtensor_steps"]["kv1"]
        # One kv head over a 2-wide model axis: the cache splits head_dim.
        assert "Shard(dim=4)" in r["cache_placements"]   # [L, B, T, KV, D]
        for got, want in zip(r["decode_logits"], logits, strict=True):
            _close(got, want, "decode logits")
        _close_tree(r["decode_cache"], cache, "cache")


def _check_families(dtensor_ranks):
    """The MoE (experts padded over ``model``, shared experts), xLSTM
    (heads that do not split over ``model``) and zamba2 models on DTensors:
    loss, gradients, two decode steps and the caches they write equal the
    plain model's; at batch 1 the KV cache splits its sequence over
    ``data``, and each step writes on the device that holds its
    position."""
    for case, *_ in W.FAMILY_CASES:
        _, model, params, batch, _ = W.family_model(case)
        b = batch["tokens"].shape[0]
        if b > 1:
            leaves = [p.requires_grad_() for p in tree_leaves(params)]
            loss = model.loss(params, batch)
            grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        cache = model.init_cache(b, W.FAMILY_CACHE, device="cpu")
        with torch.no_grad():
            logits = [model.decode_step(params, cache, batch["tokens"][:, :1],
                                        pos)[0] for pos in W.FAMILY_POS]
        for res in dtensor_ranks:
            r = res["dtensor_families"][case]
            if b > 1:
                _close(r["loss"], loss, f"{case} loss")
                _close_tree(r["grads"], grads, f"{case} grad")
            for got, want in zip(r["decode_logits"], logits, strict=True):
                _close(got, want, f"{case} decode logits")
            _close_tree(r["decode_cache"], cache, f"{case} cache")
        placed = dtensor_ranks[0]["dtensor_families"][case]["cache_placements"]
        if b == 1:      # [units, B, T, KV, D]: the sequence over data
            assert placed["attn/k"].startswith("(Shard(dim=2)"), placed
