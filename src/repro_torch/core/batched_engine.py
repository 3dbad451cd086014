"""The batched engine (``engine="batched"``): the JAX package's
``repro/core/batched_engine.py`` on the CUDA devices.

The serial engine trains one field at a time.  This engine plans the
snapshot's fields into **groups** of one slice geometry, channel count and
regulation mode (``NeurLZConfig.group_size`` fields at most; 0 puts every
such field in one group) and trains each group by one of two strategies:

* ``field_batching="unroll"`` — each field of the group with the serial
  trainer (:func:`~repro_torch.core.online_trainer.train_epochs`), one after
  another, the per-epoch losses left on the device until the group
  finishes.  Weights and archives are the serial engine's, byte for byte.
* ``field_batching="vmap"`` — the group **stacked**: parameters and Adam's
  state carry a leading field axis and each step is one stacked forward and
  backward (:func:`~repro_torch.core.online_trainer.train_stacked`), its
  convs one grouped ``conv2d3x3`` launch a layer for all fields.  Slice
  counts may differ: the group pads to its largest, every field takes that
  many steps and resamples its own slices modulo its count.
* ``field_batching="auto"`` (default) — ``vmap`` for a group of more than
  one field with equal slice counts where :func:`stacked_bit_parity` finds
  the stacked loss and gradients byte-identical to the single-field ones
  at the group's signature on the session's device; else ``unroll``.  So
  ``auto`` archives equal the serial engine's.

A field's enhancer always predicts with the single-field graph
(``predict_residual``), so the strict outlier mask and every decode are the
serial engine's whatever the strategy.  ``vmap`` on a CUDA device runs the
grouped kernels or raises: a failed build or launch is an error, never a
switch to ``unroll``.

The conventional stage runs lazily, group by group, when ``prefetch`` is
on and no field takes another as an aux channel; a group is finalized
(waited for, enhanced, packed) once the next one has been dispatched.  A
field whose enhancer fails degrades to the serial engine's conv-only entry,
with its reason.

``field_shard`` spreads the work over devices, as the JAX package does:
with several devices the conventional stage runs on the last one
(``prefetch`` on), and unrolled groups go round-robin over the others
(:func:`training_devices`, :func:`group_device`); a stacked group is
split over a ``field`` mesh (``distributed.sharding.field_mesh``), one
shard of its fields a rank, where the process group holds one rank a
device.  On one device nothing moves, and the archives are the same bytes
either way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback
from typing import Mapping

import numpy as np
import torch

from .. import device as device_lib
from .. import faults as faults_lib
from ..compressors import outliers as outlier_codec
from ..distributed import sharding as shardlib
from ..obs import telemetry as obs_lib
from . import bounds as bounds_lib
from . import conv_stage as conv_stage_lib
from . import neurlz, online_trainer, skipping_dnn


# ---------------------------------------------------------------------------
# Group planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FieldGroup:
    names: list[str]                 # fields, input order
    slice_hw: tuple[int, int]        # per-slice spatial shape
    c_in: int                        # input channels (1 + aux fields)
    mode: str | None = None          # the group's regulation mode (None:
    #   the session's); one group shares one network signature


def group_config(config, group: FieldGroup):
    """The :class:`~repro_torch.core.neurlz.NeurLZConfig` of one group
    under its regulation mode."""
    return neurlz.field_config(config, group.mode)


def sliced_shape(shape: tuple, slice_axis: int) -> tuple:
    """``np.moveaxis(x, slice_axis, 0).shape`` from the shape alone."""
    axis = slice_axis % len(shape)
    return (shape[axis],) + tuple(s for i, s in enumerate(shape) if i != axis)


def plan_groups_from_meta(shapes: Mapping[str, tuple],
                          c_ins: Mapping[str, int], config,
                          modes: Mapping[str, str] | None = None
                          ) -> list[FieldGroup]:
    """Group fields by slice geometry, channel count and mode, from their
    metadata alone, in input order; ``config.group_size > 0`` cuts each
    group into chunks of that many fields."""
    groups: dict[tuple, FieldGroup] = {}
    for name, shape in shapes.items():
        sshape = sliced_shape(tuple(shape), config.slice_axis)
        mode = modes.get(name) if modes is not None else None
        key = (sshape[1:], c_ins[name], mode)
        if key not in groups:
            groups[key] = FieldGroup(names=[], slice_hw=tuple(sshape[1:]),
                                     c_in=c_ins[name], mode=mode)
        groups[key].names.append(name)
    out = []
    for g in groups.values():
        size = config.group_size if config.group_size > 0 else len(g.names)
        for i in range(0, len(g.names), size):
            out.append(FieldGroup(names=g.names[i:i + size],
                                  slice_hw=g.slice_hw, c_in=g.c_in,
                                  mode=g.mode))
    return out


def plan_groups(fields: Mapping[str, np.ndarray], config,
                modes: Mapping[str, str] | None = None) -> list[FieldGroup]:
    """:func:`plan_groups_from_meta` of the fields' arrays."""
    shapes = {name: np.asarray(x).shape for name, x in fields.items()}
    c_ins = {name: 1 + len(neurlz._aux_names(config, name, fields))
             for name in fields}
    return plan_groups_from_meta(shapes, c_ins, config, modes=modes)


def resolve_batching(strategy: str, slice_counts: list[int]) -> str:
    """The strategy a group is proposed: ``auto`` proposes ``vmap`` for a
    group of more than one field with equal slice counts (ragged ones would
    train padded, resampled steps, off the serial trajectory), else
    ``unroll``.  An ``auto`` proposal of ``vmap`` still needs
    :func:`stacked_bit_parity`."""
    if strategy not in ("auto", "unroll", "vmap"):
        raise ValueError(f"unknown field_batching {strategy!r} "
                         "(want 'auto', 'unroll' or 'vmap')")
    if strategy != "auto":
        return strategy
    uniform = len(set(slice_counts)) == 1
    return "vmap" if uniform and len(slice_counts) > 1 else "unroll"


# ---------------------------------------------------------------------------
# The stacked strategy's parity check
# ---------------------------------------------------------------------------

# (network config, slice_hw, batch, fields, device type) -> bool
_stacked_parity: dict[tuple, bool] = {}


def stacked_bit_parity(net_cfg, slice_hw: tuple, batch: int, num_fields: int,
                       device) -> bool:
    """Whether one stacked step's loss and gradients equal, byte for byte,
    the single-field step's on each field, at this training signature on
    ``device``: on canary inputs and ``num_fields`` distinct initial
    weights, each field's ``batch_loss`` and its gradients against
    :func:`~repro_torch.core.online_trainer.stacked_batch_loss` and its
    gradients.  The result depends on shapes, not values, so it is cached
    per signature (the network config and the device's type included)."""
    device = torch.device(device)
    # The whole network config: its widths set every layer's channels, so
    # which kernel instantiation runs and whether dgrad runs apart.
    key = (dataclasses.astuple(net_cfg), tuple(slice_hw), batch, num_fields,
           device.type)
    if key in _stacked_parity:
        return _stacked_parity[key]
    h, w = slice_hw
    gen = torch.Generator().manual_seed(0)
    trees = [skipping_dnn.init_params(net_cfg, gen) for _ in range(num_fields)]
    xs = torch.randn((num_fields, batch, h, w, net_cfg.c_in), generator=gen)
    ys = torch.randn((num_fields, batch, h, w, 1), generator=gen).clamp_(-1, 1)
    xs, ys = xs.to(device), ys.to(device)
    singles = []
    for f, tree in enumerate(trees):
        model = skipping_dnn.SkippingDNN(net_cfg, tree, device=device)
        # Fresh tensors, as the trainer's batch gathers give them.
        loss = online_trainer.batch_loss(model, xs[f].clone(), ys[f].clone())
        singles.append((loss, torch.autograd.grad(
            loss, skipping_dnn.tree_leaves(model.tree()))))
    stacked = {n: {k: v.to(device).requires_grad_() for k, v in p.items()}
               for n, p in skipping_dnn.stack_params(trees).items()}
    leaves = skipping_dnn.tree_leaves(stacked)
    losses = online_trainer.stacked_batch_loss(
        stacked, xs, ys, regulated=net_cfg.regulated, skip=net_cfg.skip)
    grads = torch.autograd.grad(losses.sum(), leaves)

    def same(a, b):
        return a.detach().cpu().numpy().tobytes() == b.detach().cpu().numpy().tobytes()
    ok = all(same(loss, losses[f])
             and all(same(g1, gs[f]) for g1, gs in zip(g, grads))
             for f, (loss, g) in enumerate(singles))
    _stacked_parity[key] = ok
    return ok


# ---------------------------------------------------------------------------
# A group through the pipeline: prepare, dispatch, finalize
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _GroupState:
    group: FieldGroup
    config: object                  # the group's NeurLZConfig
    net_cfg: skipping_dnn.SkippingDNNConfig
    inputs: list                    # per-field host arrays [N_f, H, W, C]
    targets: list
    stats: list                     # per-field normalization stats
    params: list                    # per-field trees of device tensors
    schedules: list                 # per-field batch orders (or None)
    strategy: str = ""
    failed: dict = dataclasses.field(default_factory=dict)  # name -> exc
    trained: list = dataclasses.field(default_factory=list)  # field indices
    losses: torch.Tensor | None = None    # [epochs, len(trained)], device
    resids: list = dataclasses.field(default_factory=list)   # per trained
    device: torch.device | None = None    # where the group trains


def _prepare_group(group: FieldGroup, fields, recs, ebs, config, tcfg,
                   device, init_params=None, batch_schedules=None
                   ) -> _GroupState:
    """Host side of a group: each field's dataset and initial weights (the
    serial engine's: a fresh ``Generator(seed)``, or ``init_params``)."""
    config = group_config(config, group)
    net_cfg = config.net_config(group.c_in)
    init_params = init_params or {}
    batch_schedules = batch_schedules or {}
    inputs, targets, stats, params = [], [], [], []
    for name in group.names:
        aux = [recs[a] for a in neurlz._aux_names(config, name, fields)]
        inp, tgt, st = neurlz.build_dataset(
            np.asarray(fields[name]), recs[name], ebs[name], aux, config)
        inputs.append(inp)
        targets.append(tgt)
        stats.append(st)
        init = init_params.get(name)
        tree = (skipping_dnn.params_from_jax(init) if init is not None else
                skipping_dnn.init_params(
                    net_cfg, torch.Generator().manual_seed(tcfg.seed)))
        params.append({n: {k: v.to(device) for k, v in p.items()}
                       for n, p in tree.items()})
    return _GroupState(group=group, config=config, net_cfg=net_cfg,
                       inputs=inputs, targets=targets, stats=stats,
                       params=params,
                       schedules=[batch_schedules.get(n) for n in group.names],
                       device=torch.device(device))


def _dispatch_group(state: _GroupState, config, tcfg, device, fc,
                    mesh=None) -> None:
    """Train the group by its strategy and queue each trained field's
    inference behind it; no wait for the device.  ``mesh``: the field
    mesh a stacked group is split over, or None."""
    names = state.group.names
    for f, name in enumerate(names):
        try:
            fc.check(f"train.{name}")
            state.trained.append(f)
        except Exception as exc:
            if not (fc.degrade and faults_lib.is_degradable(exc)):
                raise
            state.failed[name] = exc
    counts = [int(state.inputs[f].shape[0]) for f in state.trained]
    strategy = resolve_batching(config.field_batching, counts)
    if strategy == "vmap" and config.field_batching == "auto":
        batch = min(tcfg.batch, max(counts))
        if not stacked_bit_parity(state.net_cfg, state.group.slice_hw, batch,
                                  len(counts), device):
            strategy = "unroll"
    state.strategy = strategy
    # A failure degrades what it reaches, as in the serial engine: one
    # field of an unrolled group, every field of a stacked one.
    # A stacked group with no field left to train has no unit at all.
    units = (([state.trained] if state.trained else []) if strategy == "vmap"
             else [[f] for f in state.trained])
    losses, trained = [], []
    for fs in units:
        try:
            if strategy == "vmap":
                hist = _train_stacked(state, fs, tcfg, device, mesh)
            else:
                hist = _train_unrolled(state, fs[0], tcfg, device)[:, None]
            resids = []
            for f in fs:
                model = skipping_dnn.SkippingDNN(state.net_cfg,
                                                 state.params[f], device=device)
                resids.append(online_trainer.predict_residual(
                    neurlz.archived_model(model, state.config, device),
                    state.inputs[f]))
        except Exception as exc:
            if not (fc.degrade and faults_lib.is_degradable(exc)):
                raise
            # The failed fields' device tensors are held by the frames.
            traceback.clear_frames(exc.__traceback__)
            state.failed.update({names[f]: exc for f in fs})
            continue
        losses.append(hist)
        trained.extend(fs)
        state.resids.extend(resids)
    state.trained = trained
    if losses:
        state.losses = torch.cat(losses, dim=1)


def _train_unrolled(state: _GroupState, f: int, tcfg, device) -> torch.Tensor:
    """``unroll``: field ``f`` with the serial trainer; its per-epoch
    losses ``[epochs]`` on the device."""
    model = skipping_dnn.SkippingDNN(state.net_cfg, state.params[f],
                                     device=device)
    hist = online_trainer.train_epochs(model, state.inputs[f],
                                       state.targets[f], tcfg,
                                       schedule=state.schedules[f])
    state.params[f] = model.tree()
    return hist


def _train_stacked(state: _GroupState, fs: list, tcfg, device, mesh=None
                   ) -> torch.Tensor:
    """``vmap``: fields ``fs`` stacked, padded to their largest slice
    count, one shared batch order; their per-epoch losses ``[epochs, F]``
    on the device.  Over a field ``mesh`` each rank trains its shard of the
    fields (all of them where their count does not divide the mesh), and
    the weights and losses are gathered after."""
    n_max = max(int(state.inputs[f].shape[0]) for f in fs)

    def pad(a):
        short = n_max - a.shape[0]
        return a if short == 0 else np.pad(
            a, ((0, short),) + ((0, 0),) * (a.ndim - 1))
    xs = torch.from_numpy(np.stack([pad(state.inputs[f]) for f in fs])).to(device)
    ys = torch.from_numpy(np.stack([pad(state.targets[f]) for f in fs])).to(device)
    scheds = [state.schedules[f] for f in fs]
    if any(s is not None for s in scheds) and not all(
            s is not None and np.array_equal(s, scheds[0]) for s in scheds):
        raise ValueError("a stacked group shares one batch order: give its "
                         "fields one batch schedule")
    stacked = skipping_dnn.stack_params([state.params[f] for f in fs])
    n_valid = [int(state.inputs[f].shape[0]) for f in fs]
    if mesh is not None:
        xs, ys, stacked = (_local(shardlib.shard_fields(t, mesh))
                           for t in (xs, ys, stacked))
        lo = (mesh.get_local_rank(shardlib.FIELD_AXIS) * xs.shape[0]
              if xs.shape[0] < len(fs) else 0)
        n_valid = n_valid[lo:lo + xs.shape[0]]
    for v in skipping_dnn.tree_leaves(stacked):
        v.requires_grad_()
    hist = online_trainer.train_stacked(
        stacked, xs, ys, tcfg, n_valid=n_valid,
        regulated=state.net_cfg.regulated, skip=state.net_cfg.skip,
        schedule=scheds[0])
    if mesh is not None:
        stacked = {n: {k: _gather(v.detach(), mesh, len(fs), 0)
                       for k, v in p.items()} for n, p in stacked.items()}
        hist = _gather(hist, mesh, len(fs), 1)
    for f, tree in zip(fs, skipping_dnn.unstack_params(stacked, len(fs))):
        state.params[f] = {n: {k: v.detach() for k, v in p.items()}
                           for n, p in tree.items()}
    return hist


def _local(tree):
    """This rank's shard of a distributed tensor or tree, as plain tensors."""
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree.to_local().detach().contiguous()


def _gather(local: torch.Tensor, mesh, num_fields: int, dim: int) -> torch.Tensor:
    """The full tensor of the ranks' field shards along ``dim``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    sharded = shardlib.field_sharding(mesh, num_fields)[0] != Replicate()
    return DTensor.from_local(local.contiguous(), mesh,
                              [Shard(dim) if sharded else Replicate()]
                              ).full_tensor()


def group_results(state: _GroupState):
    """The wait for the group's device work: ``(f, name, history, resid)``
    for each trained field (``history`` the per-epoch losses as floats)."""
    if not state.trained:
        return
    history = state.losses.cpu().numpy()
    for j, f in enumerate(state.trained):
        yield (f, state.group.names[f],
               [float(v) for v in history[:, j].tolist()], state.resids[j])


def _finalize_group(state: _GroupState, fields, recs, ebs, conv_arcs,
                    collect_stats: bool, out_fields: dict, *, tel, fc,
                    degraded: list) -> None:
    """Wait for the group, then each field's enhance, outlier mask and
    entry; a failed field packs the serial engine's conv-only entry."""
    config = state.config
    with tel.span("finalize", group=",".join(state.group.names)):
        done = {}
        for f, name, hist, resid in group_results(state):
            x = np.asarray(fields[name])
            aux_names = neurlz._aux_names(config, name, fields)
            try:
                if fc.degrade and not neurlz.history_is_finite(hist):
                    done[name] = (None, faults_lib.degrade_reason(), hist)
                    continue
                entry = neurlz.pack_entry(
                    config, conv_arcs[name], state.params[f], state.stats[f],
                    aux_names, ebs[name], state.net_cfg, hist, collect_stats)
                _, mask = neurlz.enhance_and_mask(x, recs[name], resid,
                                                  ebs[name], config,
                                                  state.stats[f])
                if mask is not None:
                    entry["outliers"] = outlier_codec.encode_outliers(
                        mask.cpu().numpy())
                done[name] = (entry, None, hist)
            except Exception as exc:
                if not (fc.degrade and faults_lib.is_degradable(exc)):
                    raise
                traceback.clear_frames(exc.__traceback__)
                done[name] = (None, faults_lib.degrade_reason(exc), hist)
        for name, exc in state.failed.items():
            done[name] = (None, faults_lib.degrade_reason(exc), [])
        for name in state.group.names:
            entry, reason, hist = done[name]
            x = np.asarray(fields[name])
            if reason is not None:
                entry = neurlz.pack_degraded_entry(config, conv_arcs[name],
                                                   ebs[name], reason)
                degraded.append(name)
                tel.counter("faults.degraded").add()
            elif tel.enabled and tel.config.learning_traces:
                obs_lib.learning_trace(
                    tel, name, hist, eb=ebs[name],
                    vrange=neurlz.field_vrange(x),
                    base_bytes=neurlz.entry_base_bytes(entry),
                    n_points=int(x.size), mode=config.mode)
            out_fields[name] = entry


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def session_devices(device: torch.device) -> list:
    """The devices a session on ``device`` may use: every CUDA device for
    ``cuda`` without an index, else ``device`` alone."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def conv_device(devices: list, prefetch: bool):
    """The conventional stage's device: the last one, so that it never
    queues behind enhancer training; None on one device or without
    ``prefetch``."""
    return devices[-1] if prefetch and len(devices) > 1 else None


def training_devices(devices: list, conv_dev=None) -> list:
    """The devices unrolled groups go round-robin over: every device but
    the conventional stage's, when there is more than one."""
    devs = list(devices)
    if conv_dev is not None and len(devs) > 1:
        devs = devs[:-1]
    return devs


def group_device(gi: int, train_devs: list, strategy: str, field_shard: bool,
                 default):
    """Group ``gi``'s training device: ``train_devs[gi % len(train_devs)]``
    for an unrolled group under ``field_shard`` on several devices, else
    ``default``."""
    if field_shard and len(train_devs) > 1 and strategy == "unroll":
        return train_devs[gi % len(train_devs)]
    return default


def _on(device):
    """The current CUDA device set to ``device`` (its kernels launch
    there); nothing for the CPU."""
    if device.type == "cuda" and device.index is not None:
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Engine entry points
# ---------------------------------------------------------------------------

def compress(fields: Mapping[str, np.ndarray], rel_eb: float | None = None, *,
             abs_eb: float | None = None, config=None,
             collect_stats: bool = True, device=None,
             init_params: Mapping | None = None,
             batch_schedules: Mapping | None = None, bounds=None) -> dict:
    """Compress one snapshot with the batched engine on ``device`` (``cuda``
    unless given); the serial engine's archive contract, arguments and
    entries (``init_params`` / ``batch_schedules`` as there; a stacked
    group takes its fields' one shared schedule).  ``field_shard`` spreads
    the work over :func:`session_devices`."""
    config = config or neurlz.NeurLZConfig(engine="batched")
    config.check()
    device = device_lib.resolve(device)
    devices = session_devices(device)
    conv_dev = conv_device(devices, config.prefetch)
    train_devs = training_devices(devices, conv_dev)
    mesh = shardlib.field_mesh(train_devs) if config.field_shard else None
    tel = obs_lib.of(config)
    fc = faults_lib.of(config)
    t0 = time.perf_counter()
    with tel.span("compress", root=True, engine="batched",
                  fields=len(fields)):
        tcfg = config.train_config()
        resolved = (bounds_lib.resolve_bounds(list(fields), bounds, rel_eb,
                                              abs_eb, default_mode=config.mode)
                    if bounds is not None else None)
        modes = ({n: b.mode for n, b in resolved.items()}
                 if resolved is not None else None)
        groups = plan_groups(fields, config, modes=modes)
        stage_dev = conv_dev if conv_dev is not None else device
        stage = conv_stage_lib.ConvStage(config.compressor, rel_eb, abs_eb,
                                         batch=config.conv_batch,
                                         bounds=resolved, device=stage_dev,
                                         telemetry=tel)
        conv_arcs, recs, ebs = {}, {}, {}

        def conv_compress(names):
            todo = {n: fields[n] for n in names if n not in conv_arcs}
            if todo:
                with _on(stage_dev):
                    done = stage.run(todo)
                for name, (arc, rec) in done.items():
                    conv_arcs[name], recs[name], ebs[name] = \
                        arc, rec, arc["abs_eb"]

        # An aux channel may name a field of a later group: then the whole
        # conventional stage runs first; else it runs group by group.
        if config.cross_field or not config.prefetch:
            conv_compress(list(fields))
        t_train0 = time.perf_counter()
        conv_before = stage.stats.conv_s
        finalize_s = 0.0
        out_fields: dict = {}
        degraded: list[str] = []
        strategies: dict[str, str] = {}
        states: list[_GroupState] = []

        def finalize(state):
            nonlocal finalize_s
            ts = time.perf_counter()
            with _on(state.device):
                _finalize_group(state, fields, recs, ebs, conv_arcs,
                                collect_stats, out_fields, tel=tel, fc=fc,
                                degraded=degraded)
            finalize_s += time.perf_counter() - ts

        for gi, group in enumerate(groups):
            conv_compress(group.names)
            counts = [sliced_shape(np.shape(fields[n]), config.slice_axis)[0]
                      for n in group.names]
            dev = (device if mesh is not None else group_device(
                gi, train_devs, resolve_batching(config.field_batching, counts),
                config.field_shard, device))
            with tel.span("train", group=",".join(group.names)), _on(dev):
                state = _prepare_group(group, fields, recs, ebs, config,
                                       tcfg, dev, init_params,
                                       batch_schedules)
                _dispatch_group(state, config, tcfg, dev, fc, mesh)
            strategies[",".join(group.names)] = state.strategy
            states.append(state)
            # Depth 2: a group finalizes once the next one is dispatched.
            if len(states) >= 2:
                finalize(states.pop(0))
        for state in states:
            finalize(state)
        # Conventional work inside the loop belongs to conv_s, not train_s.
        train_s = (time.perf_counter() - t_train0 - finalize_s
                   - (stage.stats.conv_s - conv_before))
        timing = obs_lib.build_timing(
            tel, total_s=time.perf_counter() - t0, conv_s=stage.stats.conv_s,
            train_s=train_s, conv_stage=stage.stats.as_dict(),
            degraded_fields=degraded, finalize_s=finalize_s,
            strategies=strategies, device=str(device))
        with tel.span("assemble"):
            return neurlz.assemble_archive(fields, out_fields, config, timing)


def decompress(arc, device=None) -> dict[str, np.ndarray]:
    """Batched decode on ``device`` (``cuda`` unless given): the serial
    decode.  Each field infers by its single-field graph, so there is
    nothing to fuse across fields, and the bytes are the serial engine's."""
    return neurlz.decompress_impl(arc, device)
