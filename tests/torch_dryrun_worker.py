"""Fake-world checks of the dry run, each in a process of its own.

    PYTHONPATH=src python tests/torch_dryrun_worker.py OUT.json CHECK...

A fake world (``launch.mesh.make_fake_world``) is the process's default
group and cannot live beside a real one, so ``tests/test_torch_op_cost.py``
and ``tests/test_torch_dryrun.py`` run these checks here and assert on the
JSON they write.  Each check makes its world and destroys it.  Imports
torch and ``repro_torch`` only (no JAX).
"""
from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist


def _world(sizes):
    from repro_torch.launch import mesh as mesh_lib

    return mesh_lib.make_fake_world(sizes=sizes)


M_, K_, N_ = 512, 256, 1024     # the sharded matmul's global shape


def sharded_matmul():
    """``x [M,K] @ w [K,N]`` with x's rows over ``data`` and w over both
    axes, twice, each call counted on its own."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import op_cost

    mesh = _world({"data": 4, "model": 4})
    try:
        x = DTensor.from_local(torch.empty(M_ // 4, K_, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(K_ // 4, N_ // 4, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        calls = []
        for _ in range(2):
            with op_cost.OpCounter() as c:
                y = x @ w
            r = c.result()
            calls.append({"flops": r["flops"], "product_flops": r["product_flops"],
                          "collectives": c.collectives,
                          "peak_bytes": r["peak_bytes"],
                          "local_shape": list(y.to_local().shape)})
        # torch.distributed's own collective (a c10d operation on a
        # ProcessGroup, not a functional one on a group name).
        with op_cost.OpCounter() as c:
            dist.all_reduce(torch.ones(1000))
        return {"calls": calls, "global_flops": 2.0 * M_ * K_ * N_,
                "c10d": c.collectives}
    finally:
        dist.destroy_process_group()


# The new families' cells on a fake {data: 2, model: 16} world: a model
# axis that splits none of the reduced presets' 2 or 4 heads and pads their
# 8 experts to 16.  (case, arch, kind, seq, batch, microbatch)
WIDE_MESH = {"data": 2, "model": 16}
WIDE_CELLS = (
    ("granite_train", "granite-moe-3b-a800m", "train", 32, 4, 2),
    ("granite_decode", "granite-moe-3b-a800m", "decode", 64, 8, 1),
    ("deepseek_train", "deepseek-moe-16b", "train", 32, 4, 2),
    ("deepseek_decode", "deepseek-moe-16b", "decode", 64, 8, 1),
    ("xlstm_train", "xlstm-350m", "train", 32, 4, 2),
    ("xlstm_decode", "xlstm-350m", "decode", 64, 8, 1),
    ("zamba2_train", "zamba2-7b", "train", 32, 4, 2),
    ("zamba2_prefill", "zamba2-7b", "prefill", 32, 4, 1),
    ("zamba2_decode_b1", "zamba2-7b", "decode", 64, 1, 1),
)
# The perf flags on the new families: (case, arch, kind, flags); each cell
# at seq 32, batch 4.
FLAG_CELLS = (
    ("granite_prefill_flags", "granite-moe-3b-a800m", "prefill",
     {"moe_group": 16, "seq_shard": True, "sp_residual": True}),
    ("xlstm_decode_flags", "xlstm-350m", "decode",
     {"moe_group": 16, "seq_shard": True, "skip_uncausal": True}),
)


def _lower(dryrun, cfg, shape, mesh, mb, **flags):
    try:
        rec = dryrun.lower_cell(cfg, shape, mesh, microbatch=mb, **flags)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — the test reports it
        rec = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
    return rec


class _OneDevice:
    """A 1x1 mesh's names and sizes: ``lower_cell`` places nothing on it,
    so it needs no world."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)


def cells():
    """The reduced qwen3-4b's train and decode cells and a small
    ``neurlz_enhance`` on a fake 2x2 world, and the train cell's plain step
    (one device); then, on a fake WIDE_MESH world, the WIDE_CELLS and
    FLAG_CELLS."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    cfg = configs.get_reduced("qwen3-4b")
    train = ShapeConfig("train_small", 64, 8, "train")
    out = {"train_plain": _lower(dryrun, cfg, train, _OneDevice(), 2)}
    mesh = _world({"data": 2, "model": 2})
    try:
        for name, shape, mb in (("train", train, 2),
                                ("decode", ShapeConfig("decode_small", 64, 8, "decode"), 1)):
            out[name] = _lower(dryrun, cfg, shape, mesh, mb)
        out["enhance"] = dryrun.lower_neurlz_enhance(mesh, n_blocks=4, side=24,
                                                     batch_slices=2)
    finally:
        dist.destroy_process_group()
    mesh = _world(WIDE_MESH)
    try:
        for case, arch, kind, seq, batch, mb in WIDE_CELLS:
            out[case] = _lower(dryrun, configs.get_reduced(arch),
                               ShapeConfig(case, seq, batch, kind), mesh, mb)
        for case, arch, kind, flags in FLAG_CELLS:
            out[case] = _lower(dryrun, configs.get_reduced(arch),
                               ShapeConfig(case, 32, 4, kind), mesh, 1, **flags)
    finally:
        dist.destroy_process_group()
    return dryrun._jsonable(out)


CHECKS = {f.__name__: f for f in (sharded_matmul, cells)}


def main() -> None:
    torch.set_num_threads(1)
    out_path, names = sys.argv[1], sys.argv[2:]
    with open(out_path, "w") as f:
        json.dump({n: CHECKS[n]() for n in names}, f)


if __name__ == "__main__":
    main()
