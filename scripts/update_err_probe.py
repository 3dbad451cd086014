#!/usr/bin/env python3
"""Card against CPU, step by step: where a reduced model's update differs.

    python3 scripts/update_err_probe.py [--archs zamba2-7b,xlstm-350m,qwen3-4b]
                                         [--steps 5] [--full-width]

For each arch at its reduced preset (float32, the port's init from seed 0,
``demo_batch(4, 32, seed=1)``), ``make_train_step(lr=1e-3)`` runs ``--steps``
steps on the card and on the CPU from the same parameters.  For each step
it prints ``chip_smoke.update_err``'s worst update gap in units of the
rate (over the entries whose CPU gradient is at least 1e-5 of its leaf's
largest) and the three worst entries: the leaf, the CPU's and the card's
gradient there, the leaf's largest gradient, the two updates (in units of
the rate) and the leaf's gradient gap relative to its largest.  An entry
whose |g| is a few times Adam's ε (1e-8) moves its first update
g / (|g| + ε) by a share of a step for a share of its own rounding.

``--full-width`` then runs ``chip_smoke._train_full_width`` for xlstm-350m
and zamba2-7b (its time, device time, kernels a step and the time to read
back its device-only trace).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="zamba2-7b,xlstm-350m,qwen3-4b")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--full-width", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("update_err_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_items

    print(cs.nvidia_smi_line(), flush=True)
    dev = device_lib.resolve("cuda")
    lr = 1e-3

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.detach().to(d, copy=True)
                for k, v in tree.items()}

    for arch in args.archs.split(","):
        cfg = configs.get_reduced(arch)
        init = M.init_params(M.build_model(cfg, model_axis=1), seed=0, device="cpu")
        batch = M.demo_batch(cfg, 4, 32, seed=1, device="cpu")
        runs = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            m = M.build_model(cfg, model_axis=1)
            params = m.load_params(to(init, d))
            b = to(batch, d)
            items = list(tree_items(params))
            leaves = [p for _, p in items]
            opt = adamw_init(params)
            step_fn = M.make_train_step(m, lr=lr)
            grads, updates = [], []
            for i in range(args.steps):
                grads.append([g.cpu() for g in
                              torch.autograd.grad(m.loss(params, b), leaves)])
                before = [p.detach().clone() for p in leaves]
                params, opt, _ = step_fn(params, opt, b, i)
                updates.append([(p.detach() - q).cpu() for p, q in zip(leaves, before)])
            runs[where] = (["/".join(k) for k, _ in items], grads, updates)
        names, gc, uc = runs["cpu"]
        _, gg, ug = runs["card"]
        for i in range(args.steps):
            rows = []
            for n, a, b, g, g2 in zip(names, ug[i], uc[i], gc[i], gg[i]):
                ga = g.abs()
                keep = ga >= 1e-5 * float(ga.max())
                gap = (a - b).abs() / lr
                gap[~keep] = 0
                j = int(gap.argmax())
                rows.append((float(gap.flatten()[j]), n, float(g.flatten()[j]),
                             float(g2.flatten()[j]), float(ga.max()),
                             float(a.flatten()[j]) / lr, float(b.flatten()[j]) / lr,
                             float((g2 - g).abs().max() / ga.max())))
            rows.sort(reverse=True)
            print(f"{arch} step {i + 1}: update_err {cs.update_err(ug[i], uc[i], gc[i], lr):.4g}"
                  " (gap, leaf, g_cpu, g_card, leaf max |g|, update card, update cpu,"
                  " leaf gradient gap)", flush=True)
            for r in rows[:3]:
                print("   ", [f"{x:.4g}" if isinstance(x, float) else x for x in r],
                      flush=True)

    if args.full_width:
        def check(ok, what):
            if not ok:
                raise AssertionError(what)
        for arch in ("xlstm-350m", "zamba2-7b"):
            t = time.perf_counter()
            r = cs._train_full_width(dev, check, arch)
            print(f"train {arch}: step {r['step_ms_median_2_8']:.1f} ms, device "
                  f"{r['device_ms_per_step']:.1f} ms, {r['device_kernels_per_step']} "
                  f"kernels a step, trace read back in {r['trace_s']:.1f} s, peak "
                  f"{r['max_memory_allocated']:,} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            cs._lm_free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
