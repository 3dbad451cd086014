"""The ranks of ``tests/test_torch_distributed.py``'s gloo worlds.

Spawned by ``torch.multiprocessing.spawn``: each rank joins a gloo
process group through a ``FileStore``, runs the named checks and saves
what they return to ``<out>/rank<r>.pt`` for the parent to assert on.
This module imports torch and ``repro_torch`` only (no JAX): the JAX
package's numbers are computed in the parent and passed in.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, to compare two tensors bit for bit."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# 2-rank checks
# ---------------------------------------------------------------------------

def psum_equal(rank, inputs):
    """``compressed_psum`` of this rank's gradients (equal ``max|g|`` on
    both ranks), and the wire bytes it reports."""
    from repro_torch.optim import grad_compress as gc

    g = {k: torch.from_numpy(v[rank]) for k, v in inputs["equal"].items()}
    stats = {}
    mean, ef = gc.compressed_psum(g, gc.init_ef(g), stats=stats)
    return {"mean": mean, "ef": ef, "stats": stats}


def psum_mixed(rank, inputs):
    """Scales 10x apart: the port's mean."""
    from repro_torch.optim import grad_compress as gc

    g = {"w": torch.from_numpy(inputs["mixed"][rank])}
    mean, _ = gc.compressed_psum(g, None)
    return {"mean": mean["w"]}


def psum_ef_steps(rank, inputs):
    """Three steps of error feedback: each step's mean and carry."""
    from repro_torch.optim import grad_compress as gc

    ef = None
    means, efs = [], []
    for g in inputs["steps"][rank]:
        mean, ef = gc.compressed_psum({"w": torch.from_numpy(g)}, ef)
        means.append(mean["w"])
        efs.append(ef["w"])
    return {"means": means, "efs": efs}


def bf16(rank, inputs):
    from repro_torch.optim import grad_compress as gc

    stats = {}
    out = gc.bf16_psum({"w": torch.from_numpy(inputs["bf16"][rank])}, stats=stats)
    return {"sum": out["w"], "stats": stats}


def field_stacked(rank, inputs):
    """The batched engine's stacked group over a 2-rank field mesh: each
    rank trains one of the two fields; the archive's entries."""
    from repro_torch.core import archive as arc_io
    from repro_torch.core import batched_engine, neurlz, online_trainer
    from repro_torch.distributed import sharding as sh

    fields = inputs["fields"]
    devs = [torch.device("cpu")] * 2          # one a rank, as CUDA ranks hold
    mesh = sh.field_mesh(devs)
    batched_engine.session_devices = lambda device: devs
    trained = []                  # the fields each stacked call trains here
    real = online_trainer.train_stacked

    def counting(params, inputs, *args, **kwargs):
        trained.append(int(inputs.shape[0]))
        return real(params, inputs, *args, **kwargs)
    online_trainer.train_stacked = counting
    cfg = neurlz.NeurLZConfig(epochs=inputs["epochs"], seed=0, engine="batched",
                              field_batching="vmap", group_size=0,
                              prefetch=False)
    arc = batched_engine.compress(fields, rel_eb=1e-3, config=cfg, device="cpu")
    return {"mesh": None if mesh is None else tuple(mesh.mesh_dim_names),
            "fields": arc_io.dumps(arc["fields"]), "trained": trained,
            "strategies": arc["timing"]["strategies"]}


# ---------------------------------------------------------------------------
# 4-rank checks
# ---------------------------------------------------------------------------

def _reduced_state():
    """The reduced qwen3-4b's parameters and AdamW state after one step
    (moments not zero), the same on every rank."""
    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get_reduced("qwen3-4b")
    model = M.build_model(cfg, model_axis=1)
    params, opt = M.init_train_state(model, seed=0, device="cpu")
    step = M.make_train_step(model, lr=1e-3)
    params, opt, _ = step(params, opt, M.demo_batch(cfg, 4, 16, seed=1,
                                                    device="cpu"), 0)
    return model, _plain(params), type(opt)(step=opt.step, mu=_plain(opt.mu),
                                   nu=_plain(opt.nu))


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree.detach().clone()


def _expected_local(full, dt):
    """The slice of ``full`` that ``dt``'s placements give this rank:
    each sharded mesh dim, in the mesh's order, cuts its chunk."""
    from torch.distributed.tensor import Shard

    mesh = dt.device_mesh
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(dt.placements):
        if isinstance(pl, Shard):
            out = out.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return out


def _check_placed(tree, ref, out, name):
    """Every leaf: the local shard is its spec's slice and the gathered
    tensor equals the reference bit for bit."""
    from repro_torch.optim.adamw import tree_items

    refs = dict(tree_items(ref))
    n_sharded = 0
    for path, dt in tree_items(tree):
        full = refs[path]
        local_ok = same_bits(dt.to_local(), _expected_local(full, dt))
        full_ok = same_bits(dt.full_tensor(), full)
        n_sharded += any(p.is_shard() for p in dt.placements)
        if not (local_ok and full_ok):
            out.setdefault("bad", []).append((name, "/".join(path), local_ok, full_ok))
    out[f"{name}_sharded"] = n_sharded
    out[f"{name}_leaves"] = len(refs)


def elastic(rank, inputs):
    """Save from a 1x1 mesh, ``rescale`` onto 2x2 over the four ranks,
    then back onto 1x1: shards, full tensors, the moments' placements."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import elastic as el
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import tree_items, tree_map

    _, params, opt = _reduced_state()
    root = inputs["ckpt_dir"]
    host = make_host_mesh("cpu")
    on_host = el.reshard_to_mesh(params, host)
    opt_host = type(opt)(step=opt.step, mu=el.reshard_to_mesh(opt.mu, host),
                         nu=el.reshard_to_mesh(opt.nu, host))
    if rank == 0:
        CheckpointManager(root, device="cpu").save(1, on_host, opt_host)
    dist.barrier()
    out = {"host_mesh": tuple(host.shape)}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mgr = CheckpointManager(root, device="cpu")
    p2, o2, meta = el.rescale(mgr, 1, params, opt, mesh)
    out["step"] = (o2.step, meta["step"])
    _check_placed(p2, params, out, "params")
    _check_placed(o2.mu, opt.mu, out, "mu")
    _check_placed(o2.nu, opt.nu, out, "nu")
    places = {p: tuple(d.placements) for p, d in tree_items(p2)}
    out["moments_follow"] = all(
        tuple(d.placements) == places[p]
        for tr in (o2.mu, o2.nu) for p, d in tree_items(tr))
    # Back to 1x1: the 2x2 state gathered by every rank, saved by one.
    full_p = tree_map(lambda d: d.full_tensor(), p2)
    full_o = type(o2)(step=o2.step, mu=tree_map(lambda d: d.full_tensor(), o2.mu),
                      nu=tree_map(lambda d: d.full_tensor(), o2.nu))
    if rank == 0:
        mgr.save(2, full_p, full_o)
    dist.barrier()
    host2 = make_host_mesh("cpu")
    p1, o1, _ = el.rescale(mgr, 2, params, opt, host2)
    _check_placed(p1, params, out, "back_params")
    _check_placed(o1.mu, opt.mu, out, "back_mu")
    _check_placed(o1.nu, opt.nu, out, "back_nu")
    out["back_step"] = o1.step
    return out


def constrain(rank, inputs):
    """``constrain`` with no mesh, on a plain tensor, and on DTensors under
    an active 2x2 mesh (one divisible, one not)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed import sharding as sh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = torch.arange(4 * 6 * 4 * 3, dtype=torch.float32).reshape(4, 6, 4, 3)
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    odd = distribute_tensor(torch.ones(3, 6, 5, 3), mesh, [Replicate(), Replicate()])
    spec = ("batch", None, "model", None)
    out = {}
    sh.set_active_mesh(None)
    out["no_mesh_is_x"] = sh.constrain(dx, spec) is dx
    sh.set_active_mesh(mesh)
    try:
        out["plain_is_x"] = sh.constrain(x, spec) is x
        y = sh.constrain(dx, spec)
        out["placements"] = [repr(p) for p in y.placements]
        out["full_equal"] = same_bits(y.full_tensor(), x)
        out["local_equal"] = same_bits(y.to_local(), _expected_local(x, y))
        out["odd_placements"] = [repr(p) for p in sh.constrain(odd, spec).placements]
    finally:
        sh.set_active_mesh(None)
    return out


def forward_bits(rank, inputs):
    """The reduced qwen3-4b forward with the constrain call sites under an
    active 2x2 mesh, and with them replaced by the identity: the same bits,
    and the call sites reached."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import attention, mlp, transformer
    from repro_torch.models import model as M

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = configs.get_reduced("qwen3-4b")
    model = M.build_model(cfg, model_axis=1)
    params = M.init_params(model, seed=0, device="cpu")
    batch = M.demo_batch(cfg, 4, 16, seed=3, device="cpu")
    mods = (attention, mlp, transformer)
    real = {m: m.constrain for m in mods}
    calls = []

    def counting(x, spec):
        calls.append(spec)
        return real[attention](x, spec)

    with torch.no_grad():
        try:
            for m in mods:
                m.constrain = lambda x, spec: x
            without = model.forward(params, batch)
            for m in mods:
                m.constrain = counting
            sh.set_active_mesh(mesh)
            with_sites = model.forward(params, batch)
        finally:
            sh.set_active_mesh(None)
            for m in mods:
                m.constrain = real[m]
    return {"same_bits": same_bits(with_sites, without), "calls": len(calls),
            "specs": sorted({str(s) for s in calls})}


def dtensor_model(kv_heads):
    """The reduced qwen3-4b (``kv_heads`` kv heads: 2, or 1 for a head
    count the 2-wide model axis does not split), its seeded parameters and
    a batch, the same on every rank (and in the parent)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"), n_kv_heads=kv_heads)
    model = M.build_model(cfg, model_axis=2)
    params = _plain(M.init_params(model, seed=0, device="cpu"))
    batch = M.demo_batch(cfg, 4, 16, seed=3, device="cpu")
    return cfg, model, params, batch


def _placed(params, batch, mesh):
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import tree_map

    dparams = tree_map(lambda t: t.requires_grad_(),
                       sh.distribute(params, sh.param_pspecs(params, mesh), mesh))
    dbatch = sh.distribute(batch, sh.input_pspecs(batch, mesh), mesh)
    return dparams, dbatch


def _full(tree):
    from repro_torch.optim.adamw import tree_map

    return tree_map(lambda t: t.detach().full_tensor(), tree)


def dtensor_steps(rank, inputs):
    """The reduced qwen3-4b on DTensors over 2x2 (params by
    ``param_pspecs``, the batch by ``input_pspecs``, the active mesh set):
    the loss and its gradients, one ``make_train_step`` at microbatch 2;
    and with one kv head, the loss, gradients and two decode steps on a
    cache placed by ``cache_pspecs``.  Every result gathered whole."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    out = {}
    for kv in (2, 1):
        cfg, model, params, batch = dtensor_model(kv)
        dparams, dbatch = _placed(params, batch, mesh)
        sh.set_active_mesh(mesh)
        try:
            loss = model.loss(dparams, dbatch)
            grads = torch.autograd.grad(loss, tree_leaves(dparams))
            res = {"loss": loss.detach().full_tensor(),
                   "grads": _full(tree_unflatten(dparams, grads))}
            if kv == 2:
                step = M.make_train_step(model, lr=1e-3, microbatch=2)
                new, opt, met = step(dparams, adamw_init(dparams), dbatch, 0)
                res["step_params"] = _full(new)
                res["step_loss"] = met["loss"].full_tensor()
            else:
                cache = model.init_cache(4, 8, device="cpu")
                dcache = sh.distribute(cache, sh.cache_pspecs(cache, mesh, 4), mesh)
                tokens = sh.distribute(batch["tokens"][:, :1],
                                       sh.input_pspecs({"t": batch["tokens"]},
                                                       mesh)["t"], mesh)
                with torch.no_grad():
                    logits = [model.decode_step(dparams, dcache, tokens, pos)[0]
                              .full_tensor() for pos in (0, 1)]
                res["decode_logits"] = logits
                res["decode_cache"] = _full(dcache)
                res["cache_placements"] = str(dcache["layers"]["k"].placements)
        finally:
            sh.set_active_mesh(None)
        out[f"kv{kv}"] = res
    return out


# The new families on DTensors: (case, arch, mesh shape (data, model),
# config overrides, batch).  "moe_pad" pads 6 experts to 8 over model 4
# and splits 2 kv heads 4 ways; "xlstm" splits its 2 heads 4 ways;
# "zamba2_b1" decodes at batch 1, whose KV cache splits its sequence over
# data.  The recurrent archs run in float64 (their float32 rounding grows
# through the layers past DTENSOR_TOL).
FAMILY_CASES = (
    ("moe_pad", "granite-moe-3b-a800m", (1, 4), {"n_experts": 6}, 4),
    ("moe_shared", "deepseek-moe-16b", (2, 2), {}, 4),
    ("xlstm", "xlstm-350m", (1, 4), {"dtype": "float64"}, 4),
    ("zamba2", "zamba2-7b", (2, 2), {"dtype": "float64"}, 4),
    ("zamba2_b1", "zamba2-7b", (2, 2), {"dtype": "float64"}, 1),
)
FAMILY_SEQ, FAMILY_CACHE, FAMILY_POS = 16, 8, (0, 5)


def family_model(case):
    """One FAMILY_CASES case: ``(cfg, model, params, batch, mesh shape)``,
    the same on every rank (and in the parent)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M

    _, arch, shape, over, batch = next(c for c in FAMILY_CASES if c[0] == case)
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    model = M.build_model(cfg, model_axis=shape[1])
    params = _plain(M.init_params(model, seed=0, device="cpu"))
    return cfg, model, params, M.demo_batch(cfg, batch, FAMILY_SEQ, seed=3,
                                            device="cpu"), shape


def dtensor_families(rank, inputs):
    """Each FAMILY_CASES case on DTensors over its mesh (params by
    ``param_pspecs``, the batch by ``input_pspecs``, the cache by
    ``cache_pspecs``, the active mesh set): the loss and its gradients
    (not at batch 1) and two decode steps at FAMILY_POS; every result
    gathered whole."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import tree_items, tree_leaves, tree_unflatten

    out = {}
    for case, *_ in FAMILY_CASES:
        _, model, params, batch, shape = family_model(case)
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "model"))
        dparams, dbatch = _placed(params, batch, mesh)
        b = batch["tokens"].shape[0]
        sh.set_active_mesh(mesh)
        try:
            res = {}
            if b > 1:
                loss = model.loss(dparams, dbatch)
                grads = torch.autograd.grad(loss, tree_leaves(dparams))
                res["loss"] = loss.detach().full_tensor()
                res["grads"] = _full(tree_unflatten(dparams, grads))
            cache = model.init_cache(b, FAMILY_CACHE, device="cpu")
            dcache = sh.distribute(cache, sh.cache_pspecs(cache, mesh, b), mesh)
            tokens = sh.distribute(batch["tokens"][:, :1],
                                   sh.input_pspecs({"t": batch["tokens"]},
                                                   mesh)["t"], mesh)
            with torch.no_grad():
                res["decode_logits"] = [
                    model.decode_step(dparams, dcache, tokens, pos)[0].full_tensor()
                    for pos in FAMILY_POS]
            res["decode_cache"] = _full(dcache)
            res["cache_placements"] = {"/".join(k): str(v.placements)
                                       for k, v in tree_items(dcache)}
        finally:
            sh.set_active_mesh(None)
        out[case] = res
    return out


CHECKS = {f.__name__: f for f in (psum_equal, psum_mixed, psum_ef_steps, bf16,
                                  field_stacked, elastic, constrain, forward_bits,
                                  dtensor_steps, dtensor_families)}


def run(rank: int, world: int, store_path: str, out_dir: str, checks: list,
        inputs: dict) -> None:
    """One rank: join the gloo group, run ``checks`` in order, save the
    results."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {name: CHECKS[name](rank, inputs) for name in checks}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(world: int, tmp_dir: str, checks: list, inputs: dict) -> list:
    """Run ``checks`` on a ``world``-rank gloo group; each rank's results."""
    import torch.multiprocessing as mp

    os.makedirs(tmp_dir, exist_ok=True)
    mp.spawn(run, args=(world, os.path.join(tmp_dir, "store"), tmp_dir, checks,
                        inputs), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

