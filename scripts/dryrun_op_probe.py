#!/usr/bin/env python3
"""Where a dry-run cell's products and collectives come from, by site.

    PYTHONPATH=src python3 scripts/dryrun_op_probe.py --arch deepseek-moe-16b \\
        --shape train_4k [--layers 2] [--seq 512] [--multi-pod] --out probe.json
    python3 scripts/dryrun_op_probe.py --diff a.json b.json

Lowers one cell as ``launch.dryrun.lower_cell`` does (rank 0 of a fake
16×16 or 2×16×16 world, meta tensors), with autograd's anomaly mode on, so
that an operation run by the backward pass knows the forward line that
made its graph node.  Every product and every collective is put under its
site: the innermost line of ``repro_torch`` (models, distributed) on the
Python stack (prefixed ``re`` inside the backward: the checkpoint's
recomputation), or for an operation of the backward itself the forward
line of its node (the innermost model line), prefixed ``bwd`` and the
node's name.  Writes ``{"torch": version, "record": the cell's record
(cost, collectives, roofline), "sites": {site: {op: [calls, product
flops, result bytes of collectives]}}}``.  ``--layers N`` cuts the depth
(the per-layer sites are the same), ``--seq N`` the sequence.  ``--diff`` prints the sites whose
numbers differ between two such files, largest first: run it on the
files of two torch versions to find the operations whose strategy
differs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _stack_sites() -> tuple:
    """The innermost ``repro_torch`` line on the stack and whether a model
    line lies beneath it, up to the autograd engine (an operation of the
    backward itself has neither)."""
    site, model = None, False
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if f.f_code.co_name == "_engine_run_backward":
            break
        if "repro_torch" in fn and "/launch/" not in fn:
            site = site or f"{Path(fn).name}:{f.f_lineno} {f.f_code.co_name}"
            model = model or "/models/" in fn
        f = f.f_back
    return site, model


def _site_of_node(node) -> str:
    tb = node.metadata.get("traceback_") if node is not None else None
    if not tb:
        return f"bwd {type(node).__name__} ?"
    lines = tb if isinstance(tb, list) else [tb]
    best = model = None
    for block in lines:
        for m in _FRAME.finditer(block):
            fn, line, name = m.groups()
            if "repro_torch" in fn and "/launch/" not in fn:
                best = f"{Path(fn).name}:{line} {name}"
                if "/models/" in fn:
                    model = best
    return f"bwd {type(node).__name__} {model or best or '?'}"


def probe(args) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.mesh import make_fake_world

    sites: dict = {}

    def add(site, op, flops=0.0, rbytes=0):
        ent = sites.setdefault(site, {}).setdefault(op, [0, 0.0, 0])
        ent[0] += 1
        ent[1] += flops
        ent[2] += rbytes

    def current_site():
        node = torch._C._current_autograd_node()
        site, model = _stack_sites()
        if node is None:
            return site or "?"
        # a model line on the stack inside the backward: the checkpoint's
        # recomputation, run when a node unpacks what it saved
        return "re " + site if model else _site_of_node(node)

    orig_product = op_cost.OpCounter._product
    orig_collective = op_cost.OpCounter._collective

    def product(self, flops, dtype):
        add(current_site(), f"product[{str(dtype).removeprefix('torch.')}]", flops)
        return orig_product(self, flops, dtype)

    def collective(self, name, a, ins, outs):
        n = len(self.collectives)
        orig_collective(self, name, a, ins, outs)
        for c in self.collectives[n:]:
            add(current_site(), f"{c['kind']}/{c['group_size']}",
                0.0, c["result_bytes"])

    op_cost.OpCounter._product = product
    op_cost.OpCounter._collective = collective
    from repro_torch.configs.base import SHAPES

    cfg = configs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = SHAPES[args.shape]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    mesh = make_fake_world(multi_pod=args.multi_pod)
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        rec = dryrun.lower_cell(cfg, shape, mesh)
    return {"torch": torch.__version__, "arch": args.arch, "shape": args.shape,
            "layers": cfg.n_layers, "multi_pod": args.multi_pod,
            "record": {k: rec.get(k) for k in ("cost", "collectives", "roofline",
                                               "memory", "status")},
            "sites": sites}


def diff(a_path, b_path) -> None:
    a, b = (json.loads(Path(p).read_text()) for p in (a_path, b_path))
    print(f"A torch {a['torch']}  B torch {b['torch']}")
    rows = []
    for site in sorted(set(a["sites"]) | set(b["sites"])):
        sa, sb = a["sites"].get(site, {}), b["sites"].get(site, {})
        for op in sorted(set(sa) | set(sb)):
            va, vb = sa.get(op, [0, 0.0, 0]), sb.get(op, [0, 0.0, 0])
            if va != vb:
                rows.append((abs(va[1] - vb[1]) + abs(va[2] - vb[2]), site, op,
                             va, vb))
    for _, site, op, va, vb in sorted(rows, reverse=True):
        print(f"{site:60s} {op:22s} A {va[0]} calls {va[1]:.4e} fl {va[2]:.4e} B"
              f" | B {vb[0]} calls {vb[1]:.4e} fl {vb[2]:.4e} B")
    ca, cb = a["record"]["cost"], b["record"]["cost"]
    print("product flops", ca["product_flops_per_device"],
          cb["product_flops_per_device"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0, help="cut the sequence")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--diff", nargs=2)
    args = ap.parse_args(argv)
    if args.diff:
        diff(*args.diff)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    res = probe(args)
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    c = res["record"]["cost"]
    print(json.dumps({"torch": res["torch"], "arch": args.arch,
                      "shape": args.shape, "layers": res["layers"],
                      "product_flops": c["product_flops_per_device"],
                      "wire_bytes": res["record"]["collectives"]["wire_bytes"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
