"""Logical-axis sharding rules: param / cache / input trees -> specs, and
specs -> DTensor placements.

The port of the JAX package's ``repro/distributed/sharding.py``, with the
same rules, regexes and fallbacks.  Conventions (``models.layers``):
  * ``*_in``   [d_in, d_out], d_out tensor-parallel      -> P(fsdp, tp)
  * ``*_out``  [d_in, d_out], d_in  tensor-parallel      -> P(tp, fsdp)
  * ``embed``  [vocab, d]                                 -> P(tp, fsdp)
  * ``w_experts_{gate,up}`` [E, d, f]  (expert parallel)  -> P(tp, fsdp, ·)
  * ``w_experts_down``      [E, f, d]                     -> P(tp, ·, fsdp)
  * 1-D scales/biases                                     -> replicated

Rules apply to the TRAILING dims; leading stack dims are never sharded.
Every dim is guarded by a divisibility check: a dim that does not divide
its mesh axis is replicated rather than failing, so one rule set serves
every arch.  Weights are FSDP-sharded within a pod (``data``) and
replicated across pods; the batch spans ("pod", "data").

A spec is :class:`P`, a tuple with one entry per tensor dim: an axis
name, a tuple of names (one dim over several axes, in the mesh's order),
or ``None``.  A mesh is anything with ``.shape``: a dict of axis sizes
(``launch.mesh.MeshShape``) or a ``DeviceMesh`` (sizes by
``mesh_dim_names``).  :func:`to_named` turns specs into per-leaf DTensor
placements (``Shard(dim)`` or ``Replicate()`` for each mesh dim),
:func:`distribute` places a tree by them.
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)


class P(tuple):
    """A partition spec: ``P("data", None)``; ``P()`` replicates.  As in
    JAX, a one-axis tuple is that axis and an empty one ``None``."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, tuple) and len(a) <= 1:
                return a[0] if a else None
            return a
        return super().__new__(cls, (norm(a) for a in axes))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh shape or a ``DeviceMesh``."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= int(sizes[a])
        return n
    return int(sizes[axis])


def _guard(spec: tuple, shape: tuple, mesh) -> P:
    """Replicate any dim that doesn't divide its mesh axis; trim/extend."""
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec[-len(shape):] if spec else ())
    out = []
    for dim, ax in zip(shape, spec):
        out.append(ax if ax is not None and dim % _axis_size(mesh, ax) == 0 else None)
    return P(*out)


# trailing-name -> trailing-dims spec (applied to the last len(spec) dims)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("model", "data")),
    (r"w_experts_(gate|up)$", ("model", "data", None)),
    (r"w_experts_down$", ("model", None, "data")),
    (r"r_gates$", ("model", None, None)),
    (r"conv_w$", (None, "model")),
    (r".*_in$", ("data", "model")),
    (r".*_out$", ("model", "data")),
]

_CACHE_RULES: list[tuple[str, tuple, tuple]] = [
    # (name, primary trailing spec, fallback trailing spec)
    (r"^(k|v)$", ("batch", None, "model", None), ("batch", None, None, "model")),
    (r"^state$", ("batch", "model", None, None), ("batch", None, None, None)),
    (r"^conv$", ("batch", None, "model"), ("batch", None, None)),
    (r"^S$", ("batch", "model", None, None), ("batch", None, None, None)),
    (r"^(n|c|h)$", ("batch", "model", None), ("batch", None, None)),
    (r"^m$", ("batch", "model"), ("batch", None)),
]

BATCH_AXES = ("pod", "data")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict's leaves, keys kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(abstract_params, mesh):
    """Spec tree for a param tree (by path-name rules)."""

    def assign(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return P()
        for pat, spec in _PARAM_RULES:
            if re.search(pat, name):
                return _guard(spec, shape, mesh)
        return P()  # replicate anything unmatched

    return _map_with_path(assign, abstract_params)


def batch_axes_for(mesh, batch_size: int):
    """Largest batch sharding the mesh supports for this batch size."""
    sizes = mesh_sizes(mesh)
    full = tuple(a for a in BATCH_AXES if a in sizes)
    if full and batch_size % _axis_size(mesh, full) == 0:
        return full
    for a in reversed(full):
        if batch_size % _axis_size(mesh, (a,)) == 0:
            return (a,)
    return None


def cache_pspecs(abstract_cache, mesh, batch_size: int):
    batch = batch_axes_for(mesh, batch_size)

    def assign(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        for pat, spec, fallback in _CACHE_RULES:
            if re.search(pat, name):
                primary = list(batch if a == "batch" else a for a in spec)
                fb = list(batch if a == "batch" else a for a in fallback)
                # Long-context decode with unshardable batch (e.g. B=1 at
                # 500k): sequence-parallel KV cache over the data axis.
                if re.match(r"^(k|v)$", name) and batch is None:
                    primary[1] = "data"
                    fb[1] = "data"
                cand = _guard(tuple(primary), shape, mesh)
                # If the model-parallel dim was dropped by the guard, try the
                # fallback (e.g. shard head_dim when KV heads don't divide).
                if "model" in spec and "model" not in cand:
                    return _guard(tuple(fb), shape, mesh)
                return cand
        return P()

    return _map_with_path(assign, abstract_cache)


def input_pspecs(specs: dict, mesh, *, seq_shard: bool = False):
    """Input batch shardings: batch over (pod, data); optional SP on seq."""

    def assign(leaf):
        shape = tuple(leaf.shape)
        batch = batch_axes_for(mesh, shape[0])
        rest = [None] * (len(shape) - 1)
        if seq_shard and len(shape) >= 2 and shape[1] % _axis_size(mesh, "model") == 0:
            rest[0] = "model"
        return P(batch, *rest)

    return {k: assign(v) for k, v in specs.items()}


def opt_pspecs(param_specs):
    """AdamW state: moments follow the params; step is replicated."""
    from ..optim.adamw import AdamWState

    return AdamWState(step=P(), mu=param_specs,
                      nu=_map_with_path(lambda _, s: s, param_specs))


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """One placement per dim of the ``DeviceMesh``: ``Shard(d)`` where the
    spec puts tensor dim ``d`` on that axis, else ``Replicate()``.  A dim
    over several axes (``("pod", "data")``) is split in the mesh's order, as
    DTensor splits it; another order raises."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec} lists its axes out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def to_named(tree_specs, mesh):
    """The spec tree as a tree of placements on ``mesh`` (a ``DeviceMesh``)."""
    return _map_specs(lambda s: placements(s, mesh), tree_specs)


def distribute(tree, tree_specs, mesh):
    """``distribute_tensor`` of every leaf of a tensor tree by its spec;
    every rank passes the same full tensors."""
    def put(path, leaf):
        node = tree_specs
        for k in path:
            node = node[k]
        return distribute_tensor(leaf, mesh, placements(node, mesh))

    return _map_with_path(put, tree)


# ---------------------------------------------------------------------------
# Activation sharding constraints.
#
# Model code calls ``constrain(x, ("batch", None, "model"))`` at key points
# (embedding output, q/k/v, MLP hidden).  Under an active mesh a DTensor is
# redistributed to the guarded spec there; a plain tensor, or any tensor
# with no active mesh, passes through as itself.
# ---------------------------------------------------------------------------

class _Active:
    mesh = None


# ---------------------------------------------------------------------------
# Field-axis sharding for the batched NeurLZ compression engine.
#
# The engine stacks per-field enhancer params/slices on a leading "field"
# axis (``core.skipping_dnn.stack_params``); placing that axis on a 1-D
# device mesh makes each rank train its own subset of a snapshot's fields —
# enhancers are independent, so no collective runs until the trained
# weights are gathered for the archive.  DTensor puts one shard on each
# rank of a process group: a mesh exists where the world is one rank a
# device over those devices.
# ---------------------------------------------------------------------------

FIELD_AXIS = "field"


def field_mesh(devices=None):
    """1-D ``DeviceMesh`` (``field``) over the process group's ranks, one a
    device of ``devices`` (every CUDA device unless given); ``None`` on one
    device, or where no process group holds one rank for each device (one
    process over several cards: the engine then spreads unrolled groups
    over the cards instead)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    devs = (list(devices) if devices is not None else
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    if len(devs) <= 1:
        return None
    if not dist.is_initialized() or dist.get_world_size() != len(devs):
        return None
    return init_device_mesh(torch.device(devs[0]).type, (len(devs),),
                            mesh_dim_names=(FIELD_AXIS,))


def field_sharding(mesh, num_fields: int) -> tuple:
    """Placements for a leading-``F``-axis tensor, guarded: a field count
    that doesn't divide the mesh replicates instead of failing."""
    ax = FIELD_AXIS if num_fields % _axis_size(mesh, FIELD_AXIS) == 0 else None
    return placements(P(ax), mesh)


def shard_fields(tree, mesh):
    """``distribute_tensor`` of every leading-``F``-axis leaf of a stacked
    tree (a tensor or a nested dict of them)."""
    def put(_, leaf):
        return distribute_tensor(leaf, mesh, field_sharding(mesh, leaf.shape[0]))
    return _map_with_path(put, tree)


def join(t, ref):
    """``t``, a plain tensor the step makes (positions, a mask, rotary
    frequencies, a count), joined to ``ref``'s DTensor arithmetic as a
    replicated DTensor on ``ref``'s mesh; ``t`` itself where ``ref`` is a
    plain tensor (or ``t`` a DTensor already)."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gather_fsdp(w):
    """A DTensor weight gathered over every mesh axis but ``model`` (the
    FSDP all-gather before its use; its gradient is reduce-scattered back),
    so a product keeps the batch's rows where they are and splits only
    over ``model`` (tensor parallel); any other ``w`` as it is."""
    if not isinstance(w, DTensor):
        return w
    names = list(w.device_mesh.mesh_dim_names)
    want = [p if n == "model" else Replicate()
            for n, p in zip(names, w.placements)]
    return w if want == list(w.placements) else w.redistribute(w.device_mesh, want)


def rows_like(make, ref):
    """``make(n)``, a tensor of ``n`` equal rows (positions), with ``ref``'s
    rows: ``n = ref.shape[0]`` for a plain ``ref``; for a DTensor, each
    device makes its own rows, split over the axes that split ``ref``'s
    rows and replicated over the rest."""
    if not isinstance(ref, DTensor):
        return make(ref.shape[0])
    if any(isinstance(p, Shard) and p.dim == 1 for p in ref.placements):
        raise NotImplementedError("rows of a tensor split over its sequence")
    pl = [p if p == Shard(0) else Replicate() for p in ref.placements]
    return DTensor.from_local(make(ref.to_local().shape[0]), ref.device_mesh,
                              pl, run_check=False)


class ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: DTensor describes a
    shard by the global tensor's strides, and a permuted local gradient
    (an einsum's) would not view as the next operation asks."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _LocalOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grad_placements):
        ctx.mesh, ctx.own = t.device_mesh, tuple(t.placements)
        ctx.grad_placements = tuple(grad_placements)
        local = t.to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        gd = DTensor.from_local(g.contiguous(), ctx.mesh, ctx.grad_placements,
                                run_check=False)
        return gd.redistribute(ctx.mesh, ctx.own), None


def local_of(t, grad_placements):
    """``t.to_local()`` for a local computation whose gradient on each
    device is placed as ``grad_placements`` says (partial over an axis
    where each device saw part of the work); the gradient is redistributed
    to ``t``'s own placements right there.  ``to_local(grad_placements=)``
    would leave a partial gradient to the next operation's backward,
    whose choice of reduction differs between torch versions."""
    return _LocalOf.apply(t, grad_placements)


class _PlacedAs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, placements, grad_placements):
        ctx.mesh, ctx.grad_placements = mesh, tuple(grad_placements)
        return DTensor.from_local(t, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(ctx.mesh, ctx.grad_placements).to_local()
        return g.contiguous(), None, None, None


def placed_as(t, mesh, placements, grad_placements):
    """``DTensor.from_local(t, mesh, placements)`` whose gradient comes
    back to ``t`` placed as ``grad_placements``: for an output partial over
    an axis, the whole gradient of each device's rows (the gradient of a
    sum is every addend's), on every torch version alike."""
    return _PlacedAs.apply(t, mesh, placements, grad_placements)


def column_products(x, ws) -> list:
    """``[x @ w for w in ws]``: ``x`` 2-D rows, each ``w`` [k, n].  On
    DTensors, the ``w`` split over their columns (tensor parallel, after
    :func:`gather_fsdp`) multiply ``x``'s local rows on each device, and
    their partial gradients of ``x`` are added there and reduced once
    (:func:`local_of`); a ``w`` split over nothing multiplies as a
    DTensor.  DTensor itself may reduce each product's gradient on its own
    (torch 2.11) or add them first (torch 2.13)."""
    if not isinstance(x, DTensor):
        return [x @ w for w in ws]
    mesh = x.device_mesh
    split = [w for w in ws if Shard(1) in w.placements]
    if not split:
        return [x @ w for w in ws]
    axes = {i for w in split for i, pl in enumerate(w.placements) if pl == Shard(1)}
    if any({i for i, pl in enumerate(w.placements) if pl == Shard(1)} != axes
           for w in split):
        raise NotImplementedError("weights split over different axes")
    rows = tuple(x.placements)
    xl = local_of(x, [Partial() if i in axes else pl for i, pl in enumerate(rows)])
    out_pl = [Shard(1) if i in axes else pl for i, pl in enumerate(rows)]
    outs = []
    for w in ws:
        if Shard(1) not in w.placements:
            outs.append(x @ w)
            continue
        wl = ContiguousGrad.apply(w.to_local(grad_placements=[
            pl if i in axes else Partial() if rows[i] == Shard(0) else Replicate()
            for i, pl in enumerate(w.placements)]))
        outs.append(placed_as(xl @ wl, mesh, out_pl, out_pl))
    return outs


def _row_placements(t) -> tuple:
    """``t``'s placements of its rows alone: split where it splits dim 0,
    replicated over every other axis."""
    return tuple(p if p == Shard(0) else Replicate() for p in t.placements)


def whole_rows(t):
    """A DTensor placed as its rows alone (:func:`_row_placements`: a
    sequence split over ``model`` gathered whole); any other ``t`` as it
    is."""
    if not isinstance(t, DTensor):
        return t
    pl = _row_placements(t)
    return t if tuple(t.placements) == pl else t.redistribute(t.device_mesh, pl)


def on_rows(fn, rows, weights=()):
    """``fn(*rows, *weights)`` on each device's rows, for a computation
    that mixes nothing across a batch row (a recurrence over time, a
    convolution along the sequence, a chunked scan).

    Plain tensors go to ``fn`` as they are.  DTensor ``rows`` (batch
    first) are placed as the first one's rows (split where it splits dim
    0, gathered and replicated over every other axis), each ``weights``
    DTensor is replicated, and ``fn`` runs on the local tensors; its
    result (a tensor or a tuple) comes back placed as the rows.  A row's
    gradient is placed as the row, a weight's is partial over the axes
    that split the rows (each device saw its own rows)."""
    ref = next((t for t in rows if isinstance(t, DTensor)), None)
    if ref is None:
        return fn(*rows, *weights)
    mesh = ref.device_mesh
    pl = _row_placements(ref)
    wgrad = [Partial() if p == Shard(0) else Replicate() for p in pl]
    rep = (Replicate(),) * mesh.ndim

    def row(t):
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        return ContiguousGrad.apply(t.to_local(grad_placements=pl))

    def weight(w):
        if not isinstance(w, DTensor):
            return w
        if tuple(w.placements) != rep:
            w = w.redistribute(mesh, rep)
        return ContiguousGrad.apply(w.to_local(grad_placements=wgrad))

    out = fn(*(row(t) for t in rows), *(weight(w) for w in weights))

    def place(o):
        return placed_as(o.contiguous(), mesh, pl, pl)
    return tuple(place(o) for o in out) if isinstance(out, tuple) else place(out)


def assign(dst, src) -> None:
    """``dst.copy_(src)`` in place; a DTensor ``dst`` (a decode cache) is
    written on each device's shard, ``src`` first placed as ``dst``."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def set_active_mesh(mesh) -> None:
    _Active.mesh = mesh


def active_mesh():
    return _Active.mesh


def constrain(x, spec: tuple):
    """Redistribute a DTensor to the guarded spec under the active mesh;
    ``x`` itself without a mesh or for a plain tensor.

    ``"batch"`` resolves to the (pod, data) axes that divide the dim;
    any other axis name is kept only if the dim divides it.
    """
    mesh = _Active.mesh
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        return x
    resolved = []
    for dim, ax in zip(x.shape, spec):
        if ax == "batch":
            ax = batch_axes_for(mesh, dim)
        if ax is None:
            resolved.append(None)
        elif dim % _axis_size(mesh, ax) == 0:
            resolved.append(ax)
        else:
            resolved.append(None)
    want = placements(P(*resolved), mesh)
    if tuple(x.placements) == want and x.device_mesh == mesh:
        return x
    if any(p.is_partial() for p in x.placements):
        # A row-parallel product's sums reduced into the residual stream:
        # every addend's gradient is the sum's, so the gradient comes back
        # placed as ``x`` with each partial axis replicated.  DTensor's own
        # backward may hand a partial gradient on to the product instead,
        # whose backward then gathers the weight and repeats the product on
        # every device of that axis.
        return pinned(x, want, tuple(Replicate() if p.is_partial() else p
                                     for p in x.placements))
    return x.redistribute(mesh, want)


class _Pinned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, want, grad_placements):
        ctx.mesh, ctx.grad_placements = x.device_mesh, tuple(grad_placements)
        if tuple(x.placements) == tuple(want):
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.grad_placements), None, None


def pinned(x, want, grad_placements):
    """``x.redistribute(x.device_mesh, want)`` whose gradient is
    redistributed to ``grad_placements`` right there, whatever placement it
    arrives in: the backward's collectives are then the port's choice, the
    same on every torch version, not DTensor's."""
    return _Pinned.apply(x, want, grad_placements)


def grad_like(t):
    """A DTensor ``t`` whose gradient is placed as ``t`` (see
    :func:`pinned`); any other ``t`` as it is."""
    if not isinstance(t, DTensor):
        return t
    return pinned(t, t.placements, t.placements)
