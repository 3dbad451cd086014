"""NeurLZ end to end (§3.1, Fig. 3), the serial engine, and the helpers it
shares with the batched engine (:mod:`repro_torch.core.batched_engine`,
``engine="batched"``).

Compression:
  1. the conventional stage (:class:`~repro_torch.core.conv_stage.ConvStage`)
     compresses every field with the configured compressor (``szlike``,
     ``szlike-lorenzo`` or ``zfplike``), same-shape fields that share a
     bound in one batched call, keeping the encoder-side reconstruction
     ``X'``;
then, one field at a time:
  2. online training of a skipping-DNN enhancer on the residual ``X − X'``
     (cross-field aux channels optional),
  3. enhancement and regulation in one pass (the ``fused_enhance`` kernel);
     strict mode stores the outlier coordinates, found with the weights as
     archived (rounded to ``weight_dtype``), the ones the decoder runs,
  4. conventional payload + weights + outliers packed into one archive.

Decode mirrors it: conventional decode (archives that share a decode key
in one stacked call) → enhancer inference → the same
``fused_enhance`` arithmetic with ``orig := X'`` → the stored outliers
patched back to ``X'``.  Encoder and decoder run one arithmetic on one
device, so the decoder reproduces the encoder's final field bit for bit.

A field whose enhancer fails — a non-finite loss, an injected fault, host
or CUDA out-of-memory — degrades to a conv-only entry that still holds its
bound, and the rest of the snapshot goes on (``NeurLZConfig.faults``,
:mod:`repro_torch.faults`).  ``NeurLZConfig.telemetry`` records the spans
``compress`` (root), ``conv``, ``train`` (one per field) and ``assemble``,
the conv and fault counters, and per-epoch learning traces
(:mod:`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Mapping

import numpy as np
import torch

from .. import compressors
from .. import device as device_lib
from .. import faults as faults_lib
from ..compressors import outliers as outlier_codec
from ..compressors import registry
from ..obs import telemetry as obs_lib
from . import archive as arc_io
from . import bounds as bounds_lib
from . import conv_stage as conv_stage_lib
from . import metrics, online_trainer, regulation, skipping_dnn


@dataclasses.dataclass(frozen=True)
class NeurLZConfig:
    compressor: str = "szlike"          # szlike | szlike-lorenzo | zfplike
    mode: str = "strict"                # strict | relaxed | unregulated
    epochs: int = 100
    batch: int = 10
    lr: float = 1e-2
    seed: int = 0
    slice_axis: int = 0
    skip: bool = True                   # skipping vs plain DNN (ablation)
    learn_residual: bool = True         # residual vs direct learning
    #   (ablation, Fig. 4: False trains on the normalized original)
    cross_field: Mapping[str, tuple] = dataclasses.field(default_factory=dict)
    weight_dtype: str = "float32"       # archive precision of the weights
    widths: tuple = (4, 4, 6, 6, 8)
    engine: str = "serial"              # serial | batched | streaming
    conv_batch: bool = True             # batched conventional stage
    # The batched engine (repro_torch.core.batched_engine):
    field_batching: str = "auto"        # auto | unroll | vmap (stacked)
    group_size: int = 2                 # fields per group (0 = all)
    prefetch: bool = True               # conventional stage lazily a group
    field_shard: bool = True            # spread groups over devices: the
    #   session has one device, so nothing to spread (ROADMAP item 6)
    max_resident_bytes: int = 0         # streaming residency budget (0: off)
    telemetry: object | None = None     # repro_torch.obs.Telemetry (None:
    #   disabled, every instrumentation point a shared no-op singleton)
    faults: object | None = None        # repro_torch.faults.FaultConfig
    #   (None: no injection, no retries, conv-only degradation on)

    def check(self) -> None:
        """Raise for a setting out of range."""
        if self.mode not in regulation.MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.engine not in ("serial", "batched", "streaming"):
            raise ValueError(f"unknown engine {self.engine!r} "
                             "(want 'serial', 'batched' or 'streaming')")
        if self.field_batching not in ("auto", "unroll", "vmap"):
            raise ValueError(f"unknown field_batching {self.field_batching!r} "
                             "(want 'auto', 'unroll' or 'vmap')")
        if self.group_size < 0:
            raise ValueError(f"group_size must be >= 0, got {self.group_size}")
        registry.get(self.compressor)   # an unknown name raises

    def net_config(self, c_in: int) -> skipping_dnn.SkippingDNNConfig:
        return skipping_dnn.SkippingDNNConfig(
            c_in=c_in, widths=tuple(self.widths),
            regulated=(self.mode != "unregulated"), skip=self.skip)

    def train_config(self) -> online_trainer.TrainConfig:
        return online_trainer.TrainConfig(
            epochs=self.epochs, batch=self.batch, lr=self.lr, seed=self.seed)


def field_config(config: NeurLZConfig, mode: str | None) -> NeurLZConfig:
    """The config of one field under its own regulation mode (``None`` or
    the session's mode: the session config unchanged)."""
    if mode is None or mode == config.mode:
        return config
    return dataclasses.replace(config, mode=mode)


def _aux_names(cfg: NeurLZConfig, name: str, fields) -> list[str]:
    aux = list(cfg.cross_field.get(name, ()))
    missing = [a for a in aux if a not in fields]
    if missing:
        raise KeyError(f"cross-field aux {missing} not in input fields")
    return aux


def _sync(device: torch.device) -> None:
    """Wait for the device, so a stage's wall time holds its own work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_dataset(x: np.ndarray, rec: np.ndarray, eb: float,
                  aux: list[np.ndarray], config: NeurLZConfig):
    """One field's training tensors ``(inputs, targets, stats)``.  With
    ``learn_residual=False`` (the paper's direct-learning ablation, Fig. 4)
    the target is the original normalized by the decompressed field's
    stats, not the residual over ``eb``."""
    inputs, targets, stats = online_trainer.make_dataset(
        rec, x, eb, aux=aux, slice_axis=config.slice_axis)
    if not config.learn_residual:
        mu, sd = stats[0]
        o = np.moveaxis(np.asarray(x, np.float64), config.slice_axis, 0)
        targets = (((o - mu) / sd).astype(np.float32))[..., None]
    return inputs, targets, stats


def pack_entry(config: NeurLZConfig, conv_arc: dict, params, stats,
               aux: list[str], eb: float, net_cfg, history,
               collect_stats: bool) -> dict:
    return {
        "conv": conv_arc,
        "weights": arc_io.pack_weights(params, config.weight_dtype),
        "stats": [list(s) for s in stats],
        "aux": aux,
        "mode": config.mode,
        "abs_eb": eb,
        "net": {"c_in": net_cfg.c_in, "widths": list(config.widths),
                "regulated": net_cfg.regulated, "skip": net_cfg.skip},
        "learn_residual": config.learn_residual,
        "loss_history": history if collect_stats else [],
    }


def archived_model(model: skipping_dnn.SkippingDNN, config: NeurLZConfig,
                   device) -> skipping_dnn.SkippingDNN:
    """The enhancer as the decoder rebuilds it from the archive: ``model``
    itself at float32 weights, else a copy with its weights rounded to
    ``weight_dtype`` and back.  The encoder predicts and takes the strict
    outlier mask with it, so a rounded weight cannot push a point past the
    bound unseen.  (The JAX package masks with the float32 weights.)"""
    if config.weight_dtype == "float32":
        return model
    like = {name: {"b": None, "w": None} for name in skipping_dnn.LAYERS}
    params = arc_io.unpack_weights(
        arc_io.pack_weights(model.tree(), config.weight_dtype), like)
    return skipping_dnn.SkippingDNN(
        model.cfg, skipping_dnn.params_from_jax(params), device=device)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # a read-only memmap of an .npy source
        a = a.copy()
    return torch.from_numpy(a).to(device)


def direct_enhance(resid_norm: torch.Tensor, stats, dtype: torch.dtype
                   ) -> torch.Tensor:
    """The direct-learning ablation's field: the network's output
    de-normalized by the decompressed field's stats, ``out·sd + mu`` in
    float64 (two roundings, no FMA), then cast to ``dtype``."""
    mu, sd = stats[0]
    return (resid_norm.to(torch.float64) * sd + mu).to(dtype)


def enhance_and_mask(x: np.ndarray, rec: np.ndarray, resid_norm: torch.Tensor,
                     eb: float, config: NeurLZConfig, stats=None):
    """Encoder-side enhancement on ``resid_norm``'s device:
    ``(field_rec, mask)`` tensors, ``mask`` None unless strict.
    ``resid_norm`` is slice-axis-first, as :func:`predict_residual` gives it.
    The residual path is the ``fused_enhance`` kernel; the direct path
    (``learn_residual=False``, which needs the field's ``stats``) is plain
    tensor ops, as the JAX package runs it outside Pallas."""
    device = resid_norm.device
    resid = torch.movedim(resid_norm, 0, config.slice_axis).contiguous()
    dec, orig = _to_device(rec, device), _to_device(x, device)
    if config.learn_residual:
        return regulation.fused_enhance(dec, resid, orig, eb,
                                        mode=config.mode)
    out = direct_enhance(resid, stats, orig.dtype)
    if config.mode != "strict":
        return out, None
    mask = regulation.outlier_mask(orig, out, eb)
    return regulation.apply_strict(out, dec, mask), mask


def pack_degraded_entry(config: NeurLZConfig, conv_arc: dict, eb: float,
                        reason: str) -> dict:
    """Conv-only entry of a field whose enhancer failed.  No weights: decode
    returns the conventional reconstruction, which already holds ``abs_eb``.
    ``reason`` is :func:`repro_torch.faults.degrade_reason`'s string."""
    return {
        "conv": conv_arc,
        "stats": [],
        "aux": [],
        "mode": config.mode,
        "abs_eb": eb,
        "learn_residual": config.learn_residual,
        "loss_history": [],
        "degraded": reason,
    }


def history_is_finite(history) -> bool:
    """False when the training loss went NaN or infinite: the weights are
    poisoned from that epoch on, so the field degrades."""
    if not history:
        return True
    return bool(np.all(np.isfinite(np.asarray(history, dtype=np.float64))))


def field_vrange(x: np.ndarray) -> float:
    """Finite value range of a field (0.0 when nothing is finite): what the
    learning trace's PSNR predictions are computed against."""
    v = np.asarray(x, dtype=np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return 0.0
    return float(v.max() - v.min())


def entry_base_bytes(entry: dict) -> float:
    """Conventional payload + weight bytes of a packed entry: the
    epoch-independent part of the learning trace's bit-rate prediction."""
    return (compressors.archive_nbytes(entry["conv"])
            + (entry["weights"]["nbytes"] if "weights" in entry else 0))


def assemble_archive(fields: Mapping, out_fields: dict, config: NeurLZConfig,
                     timing: dict) -> dict:
    arc = {
        "kind": "neurlz",
        "fields": {name: out_fields[name] for name in fields},
        "slice_axis": config.slice_axis,
        "compressor": config.compressor,
        "timing": timing,
    }
    arc["bitrate"] = {n: field_bitrate(arc, n, int(np.asarray(fields[n]).size))
                      for n in fields}
    return arc


def assemble_streaming_archive(reader: arc_io.ArchiveReader) -> dict:
    """A streaming container as the whole-dict archive: entries in the
    snapshot's field order (from the footer), so the result packs to the
    bytes the in-memory engine gives."""
    meta = reader.meta
    fields = {name: reader.read_entry(name) for name in meta["field_order"]}
    arc = {
        "kind": "neurlz",
        "fields": fields,
        "slice_axis": meta["slice_axis"],
        "compressor": meta["compressor"],
        "timing": meta.get("timing", {}),
    }
    arc["bitrate"] = {
        n: field_bitrate(arc, n, int(np.prod(meta["shapes"][n])))
        for n in fields}
    return arc


def _sample_psnr_hook(tel, x, rec, inputs, eb, stats, config, device):
    """Per-epoch measured PSNR on a few sampled slices (telemetry
    ``sample_psnr``): after every epoch, predict their residual and score
    the enhancement before the strict patch — ``fused_enhance`` with
    ``orig := rec``, equal to ``enhance``, or the direct path's
    :func:`direct_enhance` — against the original.  It reads the model under
    ``no_grad`` and draws no random numbers, so training is unchanged.
    Returns ``(on_epoch, samples)``, ``(None, None)`` when disabled."""
    if not (tel.enabled and tel.config.sample_psnr):
        return None, None
    n = inputs.shape[0]
    k = max(1, min(int(tel.config.sample_slices), n))
    idx = np.linspace(0, n - 1, k).astype(int)
    x_s = np.moveaxis(np.asarray(x), config.slice_axis, 0)[idx]
    rec_s = _to_device(np.moveaxis(np.asarray(rec), config.slice_axis, 0)[idx],
                       device)
    inp_s = _to_device(inputs[idx], device)
    samples: list[float] = []

    def on_epoch(epoch, model, loss):
        resid = online_trainer.predict_residual(model, inp_s).contiguous()
        if config.learn_residual:
            enh, _ = regulation.fused_enhance(rec_s, resid, rec_s, eb,
                                              mode="relaxed")
        else:
            enh = direct_enhance(resid, stats, rec_s.dtype)
        samples.append(metrics.psnr(x_s, enh.cpu().numpy()))

    return on_epoch, samples


def _enhance_field(x, rec, aux, aux_names, eb, conv_arc, fcfg, net_cfg, init,
                   schedule, device, tel, fc, collect_stats, t):
    """Train one field's enhancer, predict, enhance and pack its entry:
    ``(entry, history, samples)``, ``entry`` None when the loss went
    non-finite and ``fc`` degrades.  Every device tensor of the field is
    local to this frame, so a failure releases them with it."""
    tcfg = fcfg.train_config()
    ts = time.perf_counter()
    inputs, targets, stats = build_dataset(x, rec, eb, aux, fcfg)
    params = skipping_dnn.params_from_jax(init) if init is not None else None
    model = skipping_dnn.SkippingDNN(
        net_cfg, params, generator=torch.Generator().manual_seed(tcfg.seed),
        device=device)
    on_epoch, samples = _sample_psnr_hook(tel, x, rec, inputs, eb, stats,
                                          fcfg, device)
    history = online_trainer.train(model, inputs, targets, tcfg,
                                   schedule=schedule, on_epoch=on_epoch)
    _sync(device)
    t["train_s"] += time.perf_counter() - ts
    if fc.degrade and not history_is_finite(history):
        return None, history, samples

    ts = time.perf_counter()
    resid = online_trainer.predict_residual(
        archived_model(model, fcfg, device), inputs)
    _sync(device)
    t["predict_s"] += time.perf_counter() - ts

    ts = time.perf_counter()
    entry = pack_entry(fcfg, conv_arc, model.tree(), stats, aux_names, eb,
                       net_cfg, history, collect_stats)
    t["pack_s"] += time.perf_counter() - ts

    ts = time.perf_counter()
    _, mask = enhance_and_mask(x, rec, resid, eb, fcfg, stats)
    if mask is not None:
        mask = mask.cpu().numpy()   # waits for the enhance kernel
    elif tel.enabled:
        _sync(device)   # so the field's span closes after its enhance kernel
    t["enhance_s"] += time.perf_counter() - ts

    ts = time.perf_counter()
    if mask is not None:
        entry["outliers"] = outlier_codec.encode_outliers(mask)
    t["pack_s"] += time.perf_counter() - ts
    return entry, history, samples


def compress_impl(fields: Mapping[str, np.ndarray], rel_eb=None, *,
                  abs_eb=None, config: NeurLZConfig = NeurLZConfig(),
                  collect_stats: bool = True, device=None,
                  init_params: Mapping | None = None,
                  batch_schedules: Mapping | None = None,
                  bounds=None) -> dict:
    """Compress one snapshot with the configured engine (``serial``;
    ``batched``: :func:`repro_torch.core.batched_engine.compress`;
    ``streaming``: :func:`repro_torch.streaming.pipeline.compress_dict`) on
    ``device`` (``cuda`` unless given); returns the archive dict.  ``bounds`` optionally gives
    per-field :class:`~repro_torch.core.bounds.ErrorBound` specs (the forms
    of :func:`~repro_torch.core.bounds.resolve_bounds`).  ``init_params``
    (field -> parameter tree of numpy arrays) and ``batch_schedules`` (field
    -> ``[epochs, steps, batch]`` indices) fix the enhancer's start and
    batch order, e.g. to the JAX package's."""
    config.check()
    if config.engine == "streaming":
        if init_params or batch_schedules:
            raise ValueError("the streaming engine starts every enhancer "
                             "from the seed: init_params and "
                             "batch_schedules are the in-memory engines'")
        from ..streaming import pipeline
        return pipeline.compress_dict(
            fields, rel_eb, abs_eb=abs_eb, config=config,
            collect_stats=collect_stats, bounds=bounds, device=device)
    if config.engine == "batched":
        from . import batched_engine
        return batched_engine.compress(
            fields, rel_eb, abs_eb=abs_eb, config=config,
            collect_stats=collect_stats, device=device,
            init_params=init_params, batch_schedules=batch_schedules,
            bounds=bounds)
    device = device_lib.resolve(device)
    tel = obs_lib.of(config)
    fc = faults_lib.of(config)
    init_params = init_params or {}
    batch_schedules = batch_schedules or {}
    t = {k: 0.0 for k in ("conv_s", "train_s", "predict_s", "enhance_s",
                          "pack_s")}
    t0 = time.perf_counter()
    with tel.span("compress", root=True, engine="serial", fields=len(fields)):
        resolved = (bounds_lib.resolve_bounds(list(fields), bounds, rel_eb,
                                              abs_eb, default_mode=config.mode)
                    if bounds is not None else None)
        stage = conv_stage_lib.ConvStage(config.compressor, rel_eb, abs_eb,
                                         batch=config.conv_batch,
                                         bounds=resolved, device=device,
                                         telemetry=tel)
        conv = stage.run(fields)
        t["conv_s"] = time.perf_counter() - t0

        # A reconstruction stays resident until its last consumer (its own
        # entry and every field that lists it as an aux channel) is done.
        conv_arcs = {n: arc for n, (arc, _) in conv.items()}
        recs = {n: rec for n, (_, rec) in conv.items()}
        del conv
        rec_refs = {n: 1 for n in fields}
        for n in fields:
            for a in _aux_names(config, n, fields):
                rec_refs[a] += 1

        out_fields = {}
        degraded: list[str] = []
        for name, x in fields.items():
            x = np.asarray(x)
            conv_arc = conv_arcs[name]
            eb = conv_arc["abs_eb"]
            fcfg = field_config(config,
                                resolved[name].mode if resolved else None)
            aux_names = _aux_names(fcfg, name, fields)
            net_cfg = fcfg.net_config(1 + len(aux_names))

            entry, reason = None, None
            with tel.span("train", field=name):
                try:
                    fc.check(f"train.{name}")
                    entry, history, samples = _enhance_field(
                        x, recs[name], [recs[a] for a in aux_names],
                        aux_names, eb, conv_arc, fcfg, net_cfg,
                        init_params.get(name), batch_schedules.get(name),
                        device, tel, fc, collect_stats, t)
                    if entry is None:
                        reason = faults_lib.degrade_reason()
                except Exception as exc:
                    if not (fc.degrade and faults_lib.is_degradable(exc)):
                        raise
                    reason = faults_lib.degrade_reason(exc)
                    # The traceback's frames hold the failed field's device
                    # tensors (inputs, targets, model, Adam's state): let
                    # them go before the next field allocates its own.
                    traceback.clear_frames(exc.__traceback__)
            if reason is not None:
                entry = pack_degraded_entry(fcfg, conv_arc, eb, reason)
                degraded.append(name)
                tel.counter("faults.degraded").add()
            elif tel.enabled and tel.config.learning_traces:
                obs_lib.learning_trace(
                    tel, name, history, eb=eb, vrange=field_vrange(x),
                    base_bytes=entry_base_bytes(entry), n_points=int(x.size),
                    mode=fcfg.mode, sample_psnr=samples)
            out_fields[name] = entry
            for m in (name, *aux_names):
                rec_refs[m] -= 1
                if rec_refs[m] <= 0:
                    recs.pop(m, None)

        timing = obs_lib.build_timing(
            tel, total_s=time.perf_counter() - t0, conv_s=t.pop("conv_s"),
            train_s=t.pop("train_s"), conv_stage=stage.stats.as_dict(),
            degraded_fields=degraded, **t, device=str(device))
        with tel.span("assemble"):
            return assemble_archive(fields, out_fields, config, timing)


def decode_entry_net(entry: dict, device) -> skipping_dnn.SkippingDNN:
    """The enhancer of one archived field entry."""
    net = entry["net"]
    cfg = skipping_dnn.SkippingDNNConfig(
        c_in=net["c_in"], widths=tuple(net["widths"]),
        regulated=net["regulated"], skip=net["skip"])
    like = {name: {"b": None, "w": None} for name in skipping_dnn.LAYERS}
    params = arc_io.unpack_weights(entry["weights"], like)
    return skipping_dnn.SkippingDNN(
        cfg, skipping_dnn.params_from_jax(params), device=device)


def apply_decoded_entry(entry: dict, rec: np.ndarray, resid_norm: torch.Tensor,
                        slice_axis: int) -> torch.Tensor:
    """Decode-side enhancement + outlier patch, on ``resid_norm``'s device:
    the encoder's arithmetic (``fused_enhance`` with ``orig := rec``, or
    the direct path's :func:`direct_enhance`)."""
    device = resid_norm.device
    resid = torch.movedim(resid_norm, 0, slice_axis).contiguous()
    dec = _to_device(rec, device)
    if entry["learn_residual"]:
        out, _ = regulation.fused_enhance(dec, resid, dec, entry["abs_eb"],
                                          mode="relaxed")
    else:
        out = direct_enhance(resid, entry["stats"], dec.dtype)
    if entry["mode"] == "strict" and "outliers" in entry:
        mask = _to_device(outlier_codec.decode_outliers(entry["outliers"]),
                          device)
        out = regulation.apply_strict(out, dec, mask)
    return out


def decode_field_entry(e: dict, rec: np.ndarray, aux: list, slice_axis: int,
                       device=None) -> np.ndarray:
    """Single-field decode on ``device`` (``cuda`` unless given) from its
    archive entry and the conventional reconstructions (its own and its aux
    fields')."""
    device = device_lib.resolve(device)
    if e.get("degraded"):
        # Conv-only entry: the conventional reconstruction is the decode.
        return np.asarray(rec)
    model = decode_entry_net(e, device)
    stats = [tuple(s) for s in e["stats"]]
    inputs, _, _ = online_trainer.make_dataset(
        rec, None, e["abs_eb"], aux=aux, slice_axis=slice_axis, stats=stats)
    resid = online_trainer.predict_residual(model, inputs)
    return apply_decoded_entry(e, rec, resid, slice_axis).cpu().numpy()


def decompress(arc, device=None, *, engine: str = "serial"
               ) -> dict[str, np.ndarray]:
    """Decode every field of an archive (dict or ``Archive``) on ``device``
    (``cuda`` unless given).  ``engine="batched"`` names
    :func:`repro_torch.core.batched_engine.decompress`, which is this serial
    decode: every field infers by its single-field graph."""
    if engine == "batched":
        from . import batched_engine
        return batched_engine.decompress(arc, device)
    if engine != "serial":
        raise ValueError(f"unknown decode engine {engine!r}")
    device = device_lib.resolve(device)
    slice_axis = arc["slice_axis"]
    recs = compressors.decompress_many(
        {name: e["conv"] for name, e in arc["fields"].items()}, device=device)
    return {name: decode_field_entry(e, recs[name], [recs[a] for a in e["aux"]],
                                     slice_axis, device)
            for name, e in arc["fields"].items()}


def field_bitrate(arc: dict, name: str, num_points: int) -> dict:
    """Paper bit-rate accounting: size(Z) + supplementary, bits/value."""
    e = arc["fields"][name]
    conv_b = compressors.archive_nbytes(e["conv"])
    weight_b = e["weights"]["nbytes"] if "weights" in e else 0.0
    out_b = out_bits_paper = 0.0
    if "outliers" in e:
        out_b = e["outliers"]["nbytes"]
        out_bits_paper = e["outliers"]["packed_bits"]
    total = conv_b + weight_b + out_b
    return {
        "conv_bytes": conv_b,
        "weight_bytes": weight_b,
        "outlier_bytes": out_b,
        "outlier_bits_paper_formula": out_bits_paper,
        "total_bytes": total,
        "bitrate": metrics.bitrate(total, num_points),
        "conv_bitrate": metrics.bitrate(conv_b, num_points),
    }
