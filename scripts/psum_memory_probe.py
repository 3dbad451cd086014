#!/usr/bin/env python3
"""Device memory around ``compressed_psum`` and ``bf16_psum`` over NCCL.

    python3 scripts/psum_memory_probe.py

At world size 1 over NCCL, on a tree of qwen3-4b's full-width bf16 leaf
shapes (4.02 B values of ``N(0, 1) · 1e-3``), each reduce runs twice,
the first ``compressed_psum`` with ``dist.all_reduce`` as it is and then
with each all-reduce made ``async_op=True`` and waited for.  After each
call it prints the wall time, the bytes allocated before the call, after
it, right after ``del`` of its result, and after a second's sleep and
``gc.collect()``, and the call's peak.  A result that stays allocated
after ``del`` until the collector runs is held by a reference cycle; one
that stays until the sleep, by NCCL.  Needs one CUDA card.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

GB = 1e9


def main() -> int:
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    from repro_torch.optim import grad_compress as gc_mod
    from repro_torch.optim.adamw import tree_map

    dev = device_lib.resolve("cuda")
    mesh_lib.init_world(dev)
    shapes = M.abstract_params(M.build_model(configs.get_config("qwen3-4b"),
                                             model_axis=1))
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = tree_map(lambda a: (torch.randn(a.shape, generator=gen, device=dev)
                                * 1e-3).to(a.dtype), shapes)
    print(f"gradients {torch.cuda.memory_allocated() / GB:.2f} GB", flush=True)
    real = dist.all_reduce

    def waited(t, *args, **kwargs):
        real(t, *args, **dict(kwargs, async_op=True)).wait()

    def probe(label, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = torch.cuda.memory_allocated()
        del out
        dropped = torch.cuda.memory_allocated()
        time.sleep(1.0)
        gc.collect()
        later = torch.cuda.memory_allocated()
        print(f"{label}: {ms:.1f} ms; allocated before {before / GB:.2f}, after "
              f"{after / GB:.2f}, after del {dropped / GB:.2f}, after 1 s and gc "
              f"{later / GB:.2f} GB; peak {torch.cuda.max_memory_allocated() / GB:.2f} GB",
              flush=True)

    try:
        for variant in ("as is", "waited"):
            dist.all_reduce = real if variant == "as is" else waited
            for i in range(2):
                probe(f"compressed_psum, all_reduce {variant}, call {i}",
                      lambda: gc_mod.compressed_psum(grads, None))
        dist.all_reduce = real
        for i in range(2):
            probe(f"bf16_psum, call {i}", lambda: gc_mod.bf16_psum(grads))
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
