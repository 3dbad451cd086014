"""Multi-pod dry run: one step of every (architecture × shape × mesh) cell,
run as one device of the production mesh, and its per-device cost.

The port of the JAX package's ``repro/launch/dryrun.py``, which forces 512
XLA host devices, lowers and compiles each cell against the 16×16 and
2×16×16 meshes and reads the compiled module.  PyTorch compiles nothing:
here the step itself runs, eagerly, as rank 0 of a fake world of 256 or
512 ranks (``launch.mesh.make_fake_world``: collectives return at once),
on meta tensors (shapes and dtypes, no data, no device).  Parameters,
AdamW's moments, inputs and the decode cache are DTensors placed by the
port's rules (``distributed.sharding.{param,opt,input,cache}_pspecs``),
each device's shard a meta tensor of the local shape; the step is the
port's own ``make_train_step`` / ``make_prefill_step`` /
``make_encode_step`` / ``make_decode_step``, counted by
``launch.op_cost`` (per-device operations, bytes, collectives and the peak
of live bytes), with the H100 roofline terms of ``launch.roofline``.  On a
mesh of one device nothing is placed: that step is the plain one.

Each record keeps the JAX package's keys, less the XLA-only ones
(``compile_s``, ``xla_flops_loops_once``, ``xla_bytes_loops_once``: there
is no compiled module), and adds ``inert_flags``, the perf flags set that
mean nothing for the cell (``--moe-group`` on a family with no experts,
``--skip-uncausal`` with no attention or in decode, ``--seq-shard`` and
``--sp-residual`` in decode):
``memory.argument_bytes`` is the local shard bytes of params, optimizer
state, inputs and cache; ``temp_bytes`` the peak of live bytes the step
allocates beyond them; ``peak_hbm_bytes`` their sum; ``lower_s`` the
step's wall time here.

A fake world is the process's default group and cannot live beside a real
one: run this as a process of its own.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --single-pod --out /tmp/dry
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cell neurlz_enhance
Options: --multi-pod / --single-pod (default: both), --out (default
experiments/dryrun), --remat {nothing,dots}, --seq-shard, --microbatch,
--skip-uncausal, --moe-group, --sp-residual, --tag, --resume.  To spread
``--all`` over processes, run one ``--arch A --shape S --single-pod`` (or
``--multi-pod``) a process, e.g. through ``xargs -P 8``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from .. import configs
from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..distributed import sharding as sh
from ..models import model as M
from . import op_cost
from . import roofline as rl
from .mesh import make_fake_world

META = torch.device("meta")


def _jsonable(d):
    if isinstance(d, dict):
        return {k: _jsonable(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_jsonable(v) for v in d]
    if hasattr(d, "item"):
        return d.item()
    return d


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _n_chips(mesh) -> int:
    n = 1
    for v in mesh.shape:
        n *= int(v)
    return n


def _local(shape, placements, mesh) -> list[int]:
    """The shape of one device's shard (the rules split every dim evenly)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return out


def placed(abstract, specs, mesh, *, dtype=None, grad: bool = False):
    """A tree of DTensors on ``mesh`` placed by ``specs``, each device's
    shard an empty meta tensor of the local shape (``dtype`` overrides the
    leaves'); with ``mesh=None``, plain meta tensors of the full shapes."""
    from torch.distributed.tensor import DTensor

    def make(a, spec):
        dt = dtype or a.dtype
        if mesh is None:
            t = torch.empty(tuple(a.shape), dtype=dt, device=META)
        else:
            pl = sh.placements(spec, mesh)
            t = DTensor.from_local(
                torch.empty(_local(a.shape, pl, mesh), dtype=dt, device=META),
                mesh, pl, run_check=False)
        return t.requires_grad_() if grad else t

    if isinstance(abstract, dict):
        return {k: placed(v, None if specs is None else specs[k], mesh,
                          dtype=dtype, grad=grad) for k, v in abstract.items()}
    return make(abstract, specs)


def local_bytes(tree) -> int:
    """Bytes one device holds of a tree of tensors / DTensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def _storages(tree) -> dict:
    from torch.distributed.tensor import DTensor

    out = {}
    for t in op_cost._tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        out[t.untyped_storage()._cdata] = t.numel() * t.element_size()
    return out


def _record(cost: dict, lower_s: float, args_bytes: int, args_tree, out_tree
            ) -> dict:
    arg_st = _storages(args_tree)
    out_st = _storages(out_tree)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    coll = {"wire_bytes": cost["collective_wire_bytes"],
            "per_kind_wire": cost["collective_per_kind"],
            "per_kind_count": cost["collective_count"],
            "per_kind_result_bytes": cost["collective_result_bytes"],
            "wire_by_link": cost["collective_wire_by_link"]}
    flops, nbytes = cost["flops"], cost["bytes"]
    return {
        "lower_s": round(lower_s, 1),
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": sum(out_st.values()) - alias,
            "temp_bytes": cost["peak_bytes"],
            "alias_bytes": alias,
            "peak_hbm_bytes": args_bytes + cost["peak_bytes"],
        },
        "cost": {"flops_per_device": flops, "bytes_per_device": nbytes,
                 "collective_hbm_bytes": cost["collective_hbm_bytes"],
                 "transcendentals": cost["transcendentals"],
                 "product_flops_per_device": cost["product_flops"],
                 "product_flops_by_dtype": cost["product_flops_by_dtype"],
                 "kernels": cost["by_kernel"]},
        "collectives": coll,
        "roofline": rl.roofline_terms(
            flops, nbytes, coll["wire_bytes"],
            nvlink_wire_bytes=coll["wire_by_link"].get("nvlink", 0.0),
            f32_flops=cost["product_flops_by_dtype"].get("float32", 0.0)),
    }


def lower_cell(arch, shape, mesh, *, remat: str = "nothing",
               seq_shard: bool = False, donate: bool = True,
               microbatch: int = 4, skip_uncausal: bool = False,
               moe_group: int | None = None, sp_residual: bool = False):
    """One step of ``arch`` (a name or a ``ModelConfig``) at ``shape`` (a
    name of ``configs.SHAPES`` or a ``ShapeConfig``) as rank 0 of ``mesh``
    (a ``DeviceMesh``, e.g. ``make_fake_world``'s), counted; returns the
    record.  ``donate`` is kept for the JAX package's signature: the
    port's train and decode steps update their state in place."""
    del donate
    cfg = arch if isinstance(arch, ModelConfig) else configs.get_config(arch)
    if skip_uncausal:
        cfg = dataclasses.replace(cfg, attn_skip_uncausal=True)
    if moe_group is not None:
        cfg = dataclasses.replace(cfg, moe_group_size=moe_group)
    if sp_residual:
        cfg = dataclasses.replace(cfg, sp_residual=True)
    shape = shape if isinstance(shape, ShapeConfig) else SHAPES[shape]
    sizes = _mesh_sizes(mesh)
    n_chips = _n_chips(mesh)
    place = mesh if n_chips > 1 else None
    model = M.build_model(cfg, model_axis=sizes.get("model", 1))

    abs_params = M.abstract_params(model)
    pspecs = sh.param_pspecs(abs_params, mesh) if place else None
    specs = M.input_specs(cfg, shape)
    in_specs = (sh.input_pspecs(specs, mesh, seq_shard=seq_shard) if place
                else None)
    batch = placed(specs, in_specs, place)

    sh.set_active_mesh(place)
    try:
        if shape.kind == "train":
            params = placed(abs_params, pspecs, place, grad=True)
            opt = M.AdamWState(
                step=0, mu=placed(abs_params, pspecs, place, dtype=torch.float32),
                nu=placed(abs_params, pspecs, place, dtype=torch.float32))
            args = (params, opt, batch)
            step_fn = M.make_train_step(model, remat_policy=remat,
                                        microbatch=microbatch)
            run = lambda: step_fn(params, opt, batch, 0)   # noqa: E731
            mode = contextlib.nullcontext()
        elif shape.kind == "prefill":
            params = placed(abs_params, pspecs, place)
            args = (params, batch)
            fn = (M.make_encode_step(model) if cfg.family == "audio"
                  else M.make_prefill_step(model))
            run = lambda: fn(params, batch)                # noqa: E731
            mode = torch.no_grad()
        else:  # decode
            params = placed(abs_params, pspecs, place)
            abs_cache = M.abstract_cache(model, shape.global_batch, shape.seq_len)
            cache_specs = (sh.cache_pspecs(abs_cache, mesh, shape.global_batch)
                           if place else None)
            cache = placed(abs_cache, cache_specs, place)
            args = (params, cache, batch)
            step_fn = M.make_decode_step(model)
            run = lambda: step_fn(params, cache, batch["tokens"],  # noqa: E731
                                  shape.seq_len - 1)
            mode = torch.no_grad()
        args_bytes = local_bytes(args)
        t0 = time.time()
        with mode, op_cost.OpCounter() as counter:
            out = run()
        lower_s = time.time() - t0
    finally:
        sh.set_active_mesh(None)

    rec = _record(counter.result(), lower_s, args_bytes, args, out)
    flops = rec["cost"]["flops_per_device"]
    mflops = rl.model_flops(cfg, shape, n_chips)
    inert = {"moe_group": moe_group is not None and cfg.family != "moe",
             "skip_uncausal": skip_uncausal and (cfg.family == "ssm"
                                                 or shape.kind == "decode"),
             "seq_shard": seq_shard and shape.kind == "decode",
             "sp_residual": sp_residual and shape.kind == "decode"}
    rec.update({
        "arch": cfg.name, "shape": shape.name, "mesh": sizes, "n_chips": n_chips,
        "kind": shape.kind, "remat": remat, "seq_shard": seq_shard,
        "microbatch": microbatch if shape.kind == "train" else None,
        "skip_uncausal": skip_uncausal, "moe_group": moe_group,
        "sp_residual": sp_residual,
        # flags set that change nothing in this cell: no experts to route,
        # no attention chunks to skip, one position a row to split
        "inert_flags": sorted(k for k, v in inert.items() if v),
        "param_bytes": local_bytes(params),
        "model_flops_per_device": mflops,
        "useful_compute_ratio": (mflops / flops) if flops else None,
        "n_active_params": cfg.n_active_params(),
        "n_params": cfg.n_params_estimate(),
    })
    return rec


# ---------------------------------------------------------------------------
# the paper's cell: pod-scale batched online enhancer training
# ---------------------------------------------------------------------------

ENHANCE_LR = 1e-2


def enhance_state(n_blocks: int, side: int, batch_slices: int, device,
                  *, seed: int = 0):
    """``(params, opt, inputs, targets)`` of ``n_blocks`` stacked
    skipping-DNN enhancers (``c_in=2``, cross-field) on ``device``: on the
    meta device, shapes only; elsewhere He-normal weights from ``seed`` and
    inputs and targets drawn from it."""
    from ..core import skipping_dnn
    from ..optim import adamw_init

    cfg = skipping_dnn.SkippingDNNConfig(c_in=2)
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    if dev.type == "meta":
        params = {name: {"b": torch.empty((n_blocks, cout), device=dev),
                         "w": torch.empty((n_blocks, 3, 3, cin, cout), device=dev)}
                  for name, (cin, cout) in skipping_dnn.layer_channels(cfg).items()}
        x = torch.empty((n_blocks, batch_slices, side, side, 2), device=dev)
        y = torch.empty((n_blocks, batch_slices, side, side, 1), device=dev)
    else:
        params = skipping_dnn.stack_params(
            [skipping_dnn.init_params(cfg, gen) for _ in range(n_blocks)])
        params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
        x = torch.randn((n_blocks, batch_slices, side, side, 2), generator=gen).to(dev)
        y = torch.randn((n_blocks, batch_slices, side, side, 1),
                        generator=gen).mul_(0.1).to(dev)
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_()
    return params, adamw_init(params), x, y


def enhance_step(params, opt, inputs, targets, *, reduce=None):
    """One training step of stacked enhancers, each block its own: MSE of
    each block (``skipping_dnn.forward_stacked``, regulated, skip, through
    the grouped conv kernels), each block's gradients of its own loss, the
    port's AdamW at ENHANCE_LR; the blocks' mean loss, then ``reduce(loss)``
    (the mean over every device, the JAX package's ``pmean``) where given.
    Returns ``(params, opt, loss)``, params and moments updated in place."""
    from ..core import online_trainer, skipping_dnn
    from ..optim import adamw_update

    losses = online_trainer.stacked_batch_loss(params, inputs, targets,
                                               regulated=True, skip=True)
    leaves = skipping_dnn.tree_leaves(params)
    grads = torch.autograd.grad(losses.sum(), leaves)
    tree = {name: {"b": grads[2 * i], "w": grads[2 * i + 1]}
            for i, name in enumerate(skipping_dnn.LAYERS)}
    params, opt = adamw_update(tree, opt, params, lr=ENHANCE_LR)
    loss = losses.detach().mean()
    if reduce is not None:
        loss = reduce(loss)
    return params, opt, loss


def world_mean(loss):
    """``loss`` averaged over every rank of the default group: one
    all-reduce of one float32, nothing else."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    return funcol.all_reduce(loss, "avg", dist.group.WORLD)


def lower_neurlz_enhance(mesh, *, n_blocks: int = 512, side: int = 512,
                         batch_slices: int = 10):
    """The paper-technique cell: one train step of ``n_blocks`` per-block
    skipping-DNN enhancers (``c_in=2``) spread over every device of
    ``mesh``, as one device's share: ``n_blocks / n_chips`` stacked
    enhancers on meta tensors, each with its own AdamW moments, and the
    loss averaged over the world, the step's only collective (the JAX
    package's ``shard_map`` over every axis with one ``pmean``)."""
    n_chips = _n_chips(mesh)
    if n_blocks % n_chips:
        raise ValueError(f"{n_blocks} blocks do not split over {n_chips} devices")
    n_local = n_blocks // n_chips
    params, opt, x, y = enhance_state(n_local, side, batch_slices, META)
    args = (params, opt, x, y)
    args_bytes = local_bytes(args)
    t0 = time.time()
    with op_cost.OpCounter() as counter:
        out = enhance_step(params, opt, x, y, reduce=world_mean)
    rec = _record(counter.result(), time.time() - t0, args_bytes, args, out)
    rec.update({"arch": "neurlz_enhance", "shape": f"{n_blocks}x{side}x{side}",
                "mesh": _mesh_sizes(mesh), "n_chips": n_chips, "kind": "train",
                "blocks_per_device": n_local, "batch_slices": batch_slices,
                "param_bytes": local_bytes(params)})
    return rec


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def summary(rec: dict) -> str:
    """The JAX package's one line a cell."""
    r = rec["roofline"]
    return (f"lower={rec.get('lower_s', '?')}s "
            f"peak_hbm={rec['memory']['peak_hbm_bytes'] / 2**30:.2f}GiB "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms "
            f"coll={r['collective_s'] * 1e3:.2f}ms "
            f"dominant={r['dominant']}")


def _run_one(args, mesh, mesh_name, arch, shape, path) -> bool:
    """Lower one cell on ``mesh``; write its JSON to ``path``; True if ok."""
    try:
        if arch == "neurlz_enhance":
            rec = lower_neurlz_enhance(mesh)
        else:
            rec = lower_cell(arch, shape, mesh, remat=args.remat,
                             seq_shard=args.seq_shard,
                             microbatch=args.microbatch,
                             skip_uncausal=args.skip_uncausal,
                             moe_group=args.moe_group,
                             sp_residual=args.sp_residual)
        rec["status"] = "ok"
        print(f"  {summary(rec)}", flush=True)
        ok = True
    except Exception as e:  # noqa: BLE001 — record and continue
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "fail", "error": f"{type(e).__name__}: {e}"[:2000],
               "traceback": traceback.format_exc()[-2000:]}
        print(f"  FAIL: {rec['error'][:300]}", flush=True)
        ok = False
    with open(path, "w") as f:
        json.dump(_jsonable(rec), f, indent=1)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--cell", default=None, help="special cell: neurlz_enhance")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--remat", default="nothing", choices=["nothing", "dots"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--skip-uncausal", action="store_true")
    ap.add_argument("--moe-group", type=int, default=None,
                    help="override MoE routing group size (perf lever)")
    ap.add_argument("--sp-residual", action="store_true",
                    help="sequence-parallel residual stream (perf lever)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists with status ok")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(("single", False))
    if args.multi_pod or not args.single_pod:
        meshes.append(("multi", True))

    if args.cell == "neurlz_enhance":
        cells = [("neurlz_enhance", None)]
    elif args.all:
        cells = configs.cells() + [("neurlz_enhance", None)]
    elif args.arch:
        shapes = [args.shape] if args.shape else [
            s for a, s in configs.cells() if a == args.arch]
        cells = [(args.arch, s) for s in shapes]
    else:
        ap.error("pass --all, --arch, or --cell")

    todo = []
    for mesh_name, multi in meshes:
        for arch, shape in cells:
            tag = f"{arch}_{shape or 'na'}_{mesh_name}" + (
                f"_{args.tag}" if args.tag else "")
            path = os.path.join(args.out, tag + ".json")
            if args.resume and os.path.exists(path):
                try:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            print(f"=== {tag} === (cached)", flush=True)
                            continue
                except (OSError, ValueError):
                    pass
            todo.append((mesh_name, multi, arch, shape, tag, path))

    import torch.distributed as dist

    failures = 0
    by_mesh: dict = {}
    for item in todo:
        by_mesh.setdefault((item[0], item[1]), []).append(item)
    for (mesh_name, multi), items in by_mesh.items():
        mesh = make_fake_world(multi_pod=multi)
        try:
            for _, _, arch, shape, tag, path in items:
                print(f"=== {tag} ===", flush=True)
                failures += not _run_one(args, mesh, mesh_name, arch, shape, path)
        finally:
            dist.destroy_process_group()
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
