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


def cells():
    """The reduced qwen3-4b's train and decode cells and a small
    ``neurlz_enhance`` on a fake 2x2 world."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    mesh = _world({"data": 2, "model": 2})
    cfg = configs.get_reduced("qwen3-4b")
    out = {}
    try:
        for name, shape, mb in (("train", ShapeConfig("train_small", 64, 8, "train"), 2),
                                ("decode", ShapeConfig("decode_small", 64, 8, "decode"), 1)):
            try:
                rec = dryrun.lower_cell(cfg, shape, mesh, microbatch=mb)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — the test reports it
                rec = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
            out[name] = rec
        out["enhance"] = dryrun.lower_neurlz_enhance(mesh, n_blocks=4, side=24,
                                                     batch_slices=2)
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
