"""Prediction-based error-bounded lossy compressor (SZ3-style), in PyTorch.

Two predictors, as in the JAX package:

* ``interp`` -- multilevel spline interpolation: reconstruct a coarse
  lattice first, then refine level by level and axis by axis, predicting
  each midpoint by cubic interpolation of already-reconstructed neighbours.
  A phase has no sequential dependency, so it is a handful of elementwise
  tensor ops over strided views of the field.  A group of same-shape
  fields walks stacked, ``[F, ...]``, one op sequence for the group
  (:func:`compress_batched`, :func:`decompress_batched`).
* ``lorenzo`` -- cuSZ-style dual quantization: pre-quantize the field onto
  the ``2 eb`` lattice, then take the 3-D first-order Lorenzo delta of the
  integer grid.  Encode and decode are the ``lorenzo3d_fwd`` and
  ``lorenzo3d_inv`` kernels (``repro_torch.kernels.lorenzo3d``), one launch
  for a stacked group of same-shape fields.

Determinism contract.  Both walks run in ``torch.float64`` on the given
device, op for op as the JAX package's eager path runs them (divide,
round-half-even, the cubic stencil written out term by term; the Lorenzo
kernels write every float64 operation as a round-to-nearest intrinsic).
Eager PyTorch launches one kernel per op, so no multiply-add is ever
contracted and every value is rounded where the reference rounds it: the
codes, escape masks, literals and reconstruction are byte-identical to the
JAX package's.  The stacked walk divides each field by its own step as a
host scalar, as the one-field walk does (on CUDA PyTorch divides by a
host scalar as a multiply by its reciprocal, by a tensor exactly), so its
payloads equal one :func:`compress` per field on every device.  The
stored ``mean`` and the absolute bound are computed with numpy on the
host, in the reference's summation order.  Encoder and
decoder share the arithmetic, so the encoder's ``rec`` equals the decoder's
output bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import device as device_lib
from ..kernels import lorenzo3d
from . import codec, entropy
from .quantize import CODE_CAP, abs_bound_from_rel

_F64 = torch.float64


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


@dataclasses.dataclass(frozen=True)
class SZLikeConfig:
    predictor: str = "interp"
    max_level: int = 4          # number of refinement levels
    zstd_level: int = 9
    # Shrinks the internal bound so the final cast back to the input dtype
    # cannot push a point past the user bound.
    eb_margin: float = 1e-9


def _pad_to_lattice(x: np.ndarray, level: int) -> tuple[np.ndarray, tuple]:
    """Edge-pad every dim to ``D' ≡ 1 (mod 2^level)`` so all levels align."""
    s = 1 << level
    pads = []
    for d in x.shape:
        if d == 1:
            pads.append((0, 0))
        else:
            target = d if (d - 1) % s == 0 else ((d - 1) // s + 1) * s + 1
            pads.append((0, target - d))
    return np.pad(x, pads, mode="edge"), tuple(x.shape)


def _field_bound(ebs, like: torch.Tensor) -> torch.Tensor:
    """Per-field bounds ``[F, 1, ...]`` to broadcast over a stacked walk."""
    return torch.tensor(ebs, dtype=_F64, device=like.device).reshape(
        (len(ebs),) + (1,) * (like.dim() - 1))


def _quantize_phase(values, pred, eb, out_dtype: torch.dtype):
    """Quantize/reconstruct one phase (both directions share it).  ``eb`` is
    a float, or a tuple of per-field bounds over a stacked ``[F, ...]``
    phase.

    A point becomes a literal when its code overflows, when it or its
    prediction is non-finite, or when rounding the reconstruction to the
    output dtype would push it past the bound.
    """
    if isinstance(eb, tuple):
        diff = values - pred
        q = torch.round(torch.stack([d / (2.0 * e) for d, e in zip(diff, eb)]))
        eb = _field_bound(eb, values)
        step = 2.0 * eb
    else:
        step = 2.0 * eb
        q = torch.round((values - pred) / step)
    unpred = ((torch.abs(q) >= CODE_CAP) | ~torch.isfinite(values)
              | ~torch.isfinite(pred))
    codes = torch.where(unpred, 0, q).to(torch.int32)
    rec = pred + codes.to(pred.dtype) * step
    cast_bad = torch.abs(rec.to(out_dtype).to(rec.dtype) - values) > eb
    unpred = unpred | cast_bad | ~torch.isfinite(rec)
    codes = torch.where(unpred, 0, codes)
    rec = torch.where(unpred, values, rec)
    return codes, rec, unpred


def _encode_mask(mask: np.ndarray, level: int) -> dict:
    payload, cname = codec.compress(np.packbits(mask.ravel()).tobytes(), level)
    return {"count": int(mask.size), "payload": payload, "codec": cname,
            "nbytes": len(payload)}


def _decode_mask(blob: dict) -> np.ndarray:
    raw = codec.decompress(blob["payload"], blob.get("codec", "zstd"))
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))[: blob["count"]]
    return bits.astype(bool)


def _phase_slicers(shape, axis, s):
    """Target/coarse slicers of one (level, axis) phase: axes before
    ``axis`` are already refined to stride ``s//2``, axes after are still at
    stride ``s``."""
    h = s // 2
    tgt, coarse = [], []
    for i, d in enumerate(shape):
        if d == 1:
            tgt.append(slice(0, 1))
            coarse.append(slice(0, 1))
        elif i < axis:
            tgt.append(slice(0, None, h))
            coarse.append(slice(0, None, h))
        elif i == axis:
            tgt.append(slice(h, None, s))
            coarse.append(slice(0, None, s))
        else:
            tgt.append(slice(0, None, s))
            coarse.append(slice(0, None, s))
    return tuple(tgt), tuple(coarse)


def _cubic_midpoint(coarse: torch.Tensor, axis: int) -> torch.Tensor:
    """M+1 coarse points -> M midpoint predictions: the 4-point cubic
    ``(-a + 9b + 9c - d) / 16`` inside, linear at the two ends (SZ3's
    boundary rule)."""
    a = torch.movedim(coarse, axis, 0)
    left1, right1 = a[:-1], a[1:]
    linear = 0.5 * (left1 + right1)
    m = a.shape[0] - 1
    if m >= 3:
        left2 = torch.cat([a[:1], a[:-2]], dim=0)
        right2 = torch.cat([a[2:], a[-1:]], dim=0)
        cubic = (-left2 + 9.0 * left1 + 9.0 * right1 - right2) / 16.0
        idx = torch.arange(m, device=a.device).reshape((-1,) + (1,) * (a.ndim - 1))
        pred = torch.where((idx == 0) | (idx == m - 1), linear, cubic)
    else:
        pred = linear
    return torch.movedim(pred, 0, axis)


def _interp_schedule(shape: tuple, max_level: int) -> tuple[int, list]:
    live = [d for d in shape if d > 1]
    if not live:
        return 1, []
    lmax = max(1, min(max_level, int(math.floor(math.log2(max(min(live) - 1, 2))))))
    phases = []
    for lev in range(lmax, 0, -1):
        s = 1 << lev
        for axis, d in enumerate(shape):
            if d > 1:
                phases.append((s, axis))
    return lmax, phases


def _interp_encode(x: torch.Tensor, eb: float, level: int, phases,
                   mean: float, out_dtype: torch.dtype):
    """Encode walk over the padded float64 field ``x``.  Returns the padded
    reconstruction and the host streams ``(codes, masks, literals)``, each
    concatenated in phase order."""
    rec = torch.full(x.shape, mean, dtype=x.dtype, device=x.device)
    codes_out, masks_out, lits_out = [], [], []

    def step(tvals, pred):
        c, r, u = _quantize_phase(tvals, pred, eb, out_dtype)
        codes_out.append(c.reshape(-1))
        masks_out.append(u.reshape(-1))
        lits_out.append(tvals[u])
        return r

    init = tuple(slice(0, 1) if d == 1 else slice(0, None, 1 << level)
                 for d in x.shape)
    rec[init] = step(x[init], rec[init])
    for s, axis in phases:
        tgt, coarse = _phase_slicers(x.shape, axis, s)
        pred = _cubic_midpoint(rec[coarse], axis)
        if pred.numel() == 0:
            continue
        rec[tgt] = step(x[tgt], pred)
    return rec, (torch.cat(codes_out).cpu().numpy(),
                 torch.cat(masks_out).cpu().numpy(),
                 torch.cat(lits_out).cpu().numpy())


def _interp_decode(pad_shape, eb: float, level: int, phases, mean: float,
                   codes: np.ndarray, masks: np.ndarray, lits: np.ndarray,
                   device) -> torch.Tensor:
    """Decode walk: the encoder's reconstruction, phase by phase, with the
    literal escapes patched in stream order."""
    rec = torch.full(pad_shape, mean, dtype=_F64, device=device)
    codes_t = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    masks_t = torch.from_numpy(np.ascontiguousarray(masks)).to(device)
    lits_t = torch.from_numpy(np.ascontiguousarray(lits, np.float64)).to(device)
    cursor = lit_cursor = 0

    def step(pred):
        nonlocal cursor, lit_cursor
        n = pred.numel()
        c = codes_t[cursor:cursor + n].reshape(pred.shape)
        un = masks_t[cursor:cursor + n].reshape(pred.shape)
        cursor += n
        r = pred + c.to(pred.dtype) * (2.0 * eb)
        k = int(un.sum())
        if k:
            # masked_scatter_ fills in logical row-major order, as the
            # reference's host-side ``rn[un] = lv`` does.
            r = r.contiguous()
            r.masked_scatter_(un, lits_t[lit_cursor:lit_cursor + k])
            lit_cursor += k
        return r

    init = tuple(slice(0, 1) if d == 1 else slice(0, None, 1 << level)
                 for d in pad_shape)
    rec[init] = step(rec[init])
    for s, axis in phases:
        tgt, coarse = _phase_slicers(pad_shape, axis, s)
        pred = _cubic_midpoint(rec[coarse], axis)
        if pred.numel() == 0:
            continue
        rec[tgt] = step(pred)
    return rec


def _interp_encode_batched(xs: torch.Tensor, ebs: tuple, level: int, phases,
                           means: list, out_dtype: torch.dtype):
    """:func:`_interp_encode` over a stacked ``[F, ...]`` group of padded
    float64 fields, each with its own bound and mean: the same op sequence
    with a leading field axis.  Returns the stacked reconstruction and each
    field's host streams ``(codes, masks, literals)`` in phase order."""
    nf, fshape = xs.shape[0], tuple(xs.shape[1:])
    rec = torch.empty(xs.shape, dtype=xs.dtype, device=xs.device)
    for f, m in enumerate(means):
        rec[f].fill_(m)
    codes_out, masks_out, lits_out = [], [], []

    def step(tvals, pred):
        c, r, u = _quantize_phase(tvals, pred, ebs, out_dtype)
        codes_out.append(c.reshape(nf, -1))
        masks_out.append(u.reshape(nf, -1))
        lits_out.append([tvals[f][u[f]] for f in range(nf)])
        return r

    init = (slice(None),) + tuple(slice(0, 1) if d == 1
                                  else slice(0, None, 1 << level)
                                  for d in fshape)
    rec[init] = step(xs[init], rec[init])
    for s, axis in phases:
        tgt, coarse = _phase_slicers(fshape, axis, s)
        tgt, coarse = (slice(None),) + tgt, (slice(None),) + coarse
        pred = _cubic_midpoint(rec[coarse], axis + 1)
        if pred.numel() == 0:
            continue
        rec[tgt] = step(xs[tgt], pred)
    codes = torch.cat(codes_out, dim=1).cpu().numpy()
    masks = torch.cat(masks_out, dim=1).cpu().numpy()
    return rec, [(codes[f], masks[f],
                  torch.cat([p[f] for p in lits_out]).cpu().numpy())
                 for f in range(nf)]


def _interp_decode_batched(pad_shape, ebs: tuple, level: int, phases,
                           means: list, streams: list, device) -> torch.Tensor:
    """:func:`_interp_decode` of a stacked group: each field's host streams
    ``(codes, masks, literals)``, the cursors in lockstep (the fields share
    the phase schedule), each field's literals patched in its own stream
    order.  Returns the stacked padded reconstruction."""
    nf = len(streams)
    rec = torch.empty((nf, *pad_shape), dtype=_F64, device=device)
    for f, m in enumerate(means):
        rec[f].fill_(m)
    codes_t = torch.from_numpy(np.stack([c for c, _, _ in streams])).to(device)
    masks_t = torch.from_numpy(np.stack([m for _, m, _ in streams])).to(device)
    lits_t = [torch.from_numpy(np.ascontiguousarray(lv, np.float64)).to(device)
              for _, _, lv in streams]
    step2 = 2.0 * _field_bound(ebs, rec)
    cursor, lit_cursor = 0, [0] * nf

    def step(pred):
        nonlocal cursor
        n = pred[0].numel()
        c = codes_t[:, cursor:cursor + n].reshape(pred.shape)
        un = masks_t[:, cursor:cursor + n].reshape(pred.shape)
        cursor += n
        r = (pred + c.to(pred.dtype) * step2).contiguous()
        for f in range(nf):
            k = int(un[f].sum())
            if k:
                r[f].masked_scatter_(un[f], lits_t[f][lit_cursor[f]:lit_cursor[f] + k])
                lit_cursor[f] += k
        return r

    init = (slice(None),) + tuple(slice(0, 1) if d == 1
                                  else slice(0, None, 1 << level)
                                  for d in pad_shape)
    rec[init] = step(rec[init])
    for s, axis in phases:
        tgt, coarse = _phase_slicers(pad_shape, axis, s)
        tgt, coarse = (slice(None),) + tgt, (slice(None),) + coarse
        pred = _cubic_midpoint(rec[coarse], axis + 1)
        if pred.numel() == 0:
            continue
        rec[tgt] = step(pred)
    return rec


def _interp_archive(shape, pad_shape, dtype, level, abs_eb, eb_int, mean,
                    codes, masks, lits, zstd_level: int) -> dict:
    arc = {
        "kind": "szlike", "predictor": "interp", "level": level,
        "shape": list(shape), "pad_shape": list(pad_shape),
        "dtype": str(dtype), "abs_eb": abs_eb, "eb_int": eb_int,
        "mean": mean,
        "codes": entropy.encode_codes(codes, zstd_level),
        "unpred": _encode_mask(masks, zstd_level),
        "literals": entropy.encode_floats(lits, zstd_level),
    }
    arc["nbytes"] = archive_nbytes(arc)
    return arc


def _prepare(x, rel_eb, abs_eb, config: SZLikeConfig):
    """``(abs_eb, eb_int, float64 work copy, mean)`` of one field, on the
    host in the reference's order."""
    if abs_eb is None:
        if rel_eb is None:
            raise ValueError("pass rel_eb or abs_eb")
        abs_eb = abs_bound_from_rel(x, rel_eb)
    work = x.astype(np.float64)
    finite = work[np.isfinite(work)]
    mean = float(finite.mean()) if finite.size else 0.0
    return float(abs_eb), float(abs_eb) * (1.0 - config.eb_margin), work, mean


def _lorenzo_archive(shape, dtype, abs_eb, eb_int, mean, codes, unpred, lits,
                     level: int) -> dict:
    arc = {
        "kind": "szlike", "predictor": "lorenzo",
        "shape": list(shape), "dtype": str(dtype),
        "abs_eb": abs_eb, "eb_int": eb_int, "mean": mean,
        "codes": entropy.encode_codes(codes, level),
        "unpred": _encode_mask(unpred.ravel(), level),
        "literals": entropy.encode_floats(lits, level),
    }
    arc["nbytes"] = archive_nbytes(arc)
    return arc


def _lorenzo_encode_group(works: list, eb_ints: list, dtype, device):
    """One ``lorenzo3d_fwd`` over the stacked group: host ``(delta, unpred,
    rec in the fields' dtype)``, each ``[F, *shape]``."""
    stacked = torch.from_numpy(np.stack(works)).to(device)
    d, un, rec = lorenzo3d.lorenzo3d_fwd(stacked, eb_ints, _torch_dtype(dtype))
    return (d.cpu().numpy(), un.cpu().numpy(),
            rec.to(_torch_dtype(dtype)).cpu().numpy())


def _lorenzo_decode_group(arcs: list, device) -> list:
    """One ``lorenzo3d_inv`` over a ``decode_key``-matched group, then each
    field's literals patched back in row-major order and the cast to its
    dtype."""
    shape = tuple(arcs[0]["shape"])
    delta = np.stack([entropy.decode_codes(a["codes"]).reshape(shape)
                      for a in arcs])
    rec = lorenzo3d.lorenzo3d_inv(torch.from_numpy(delta).to(device),
                                  [a["eb_int"] for a in arcs])
    outs = []
    for f, a in enumerate(arcs):
        r = rec[f]
        mask = _decode_mask(a["unpred"]).reshape(shape)
        if mask.any():
            lits = np.asarray(entropy.decode_floats(a["literals"]).ravel(),
                              np.float64)
            # masked_scatter_ fills in row-major order, as the reference's
            # ``out[m] = lits`` does.
            r.masked_scatter_(torch.from_numpy(mask).to(device),
                              torch.from_numpy(lits).to(device))
        outs.append(r.to(_torch_dtype(np.dtype(a["dtype"]))).cpu().numpy())
    return outs


def compress(x: np.ndarray, rel_eb: float | None = None, *,
             abs_eb: float | None = None,
             config: SZLikeConfig = SZLikeConfig(),
             device=None) -> tuple[dict, np.ndarray]:
    """Compress ``x`` on ``device`` (``cuda`` unless given); returns
    ``(archive, reconstruction)``.

    The reconstruction is exactly what :func:`decompress` will produce, so
    the enhancer trains against it without a decode round trip.
    """
    if config.predictor not in ("interp", "lorenzo"):
        raise ValueError(f"unknown predictor {config.predictor!r}")
    device = device_lib.resolve(device)
    x = np.asarray(x)
    if x.ndim not in (2, 3):
        raise ValueError(f"expected 2-D or 3-D field, got shape {x.shape}")
    orig_dtype = x.dtype
    abs_eb, eb_int, work, mean = _prepare(x, rel_eb, abs_eb, config)

    if config.predictor == "lorenzo":
        # A one-field group: the stacked op sequence is the per-field one.
        d, un, rec = _lorenzo_encode_group([work], [eb_int], orig_dtype, device)
        arc = _lorenzo_archive(work.shape, orig_dtype, abs_eb, eb_int, mean,
                               d[0], un[0], work[un[0]], config.zstd_level)
        return arc, rec[0]

    level, phases = _interp_schedule(work.shape, config.max_level)
    padded, orig_shape = _pad_to_lattice(work, level)
    xt = torch.from_numpy(padded).to(device)
    rec, (codes, masks, lits) = _interp_encode(
        xt, eb_int, level, phases, mean, _torch_dtype(orig_dtype))
    rec_np = rec.cpu().numpy()[tuple(slice(0, d) for d in orig_shape)]
    arc = _interp_archive(orig_shape, padded.shape, orig_dtype, level, abs_eb,
                          eb_int, mean, codes, masks, lits, config.zstd_level)
    return arc, rec_np.astype(orig_dtype, copy=False)


def compress_batched(xs, rel_eb: float | None = None, *,
                     abs_eb: float | None = None,
                     config: SZLikeConfig = SZLikeConfig(),
                     device=None) -> list:
    """Compress a group of same-shape, same-dtype fields in one stacked
    pass: the interp walk over ``[F, ...]``, or one ``lorenzo3d_fwd`` launch;
    the host entropy stage stays per field.  Payloads are byte-identical to
    one :func:`compress` call per field: each field's bound and mean are
    derived as that path derives them.  Returns ``[(archive,
    reconstruction), ...]`` in order.
    """
    if config.predictor not in ("interp", "lorenzo"):
        raise ValueError(f"unknown predictor {config.predictor!r}")
    device = device_lib.resolve(device)
    arrs = [np.asarray(x) for x in xs]
    if not arrs:
        return []
    shape, dtype = arrs[0].shape, arrs[0].dtype
    if any(a.shape != shape or a.dtype != dtype for a in arrs):
        raise ValueError("compress_batched needs same-shape/same-dtype fields")
    if len(shape) not in (2, 3):
        raise ValueError(f"expected 2-D or 3-D fields, got shape {shape}")
    if abs_eb is None and rel_eb is None:
        raise ValueError("pass rel_eb or abs_eb")
    prep = [_prepare(a, rel_eb, abs_eb, config) for a in arrs]
    works = [p[2] for p in prep]
    if config.predictor == "interp":
        level, phases = _interp_schedule(shape, config.max_level)
        padded = np.stack([_pad_to_lattice(w, level)[0] for w in works])
        rec, streams = _interp_encode_batched(
            torch.from_numpy(padded).to(device), tuple(p[1] for p in prep),
            level, phases, [p[3] for p in prep], _torch_dtype(dtype))
        recs = rec.cpu().numpy()[(slice(None),)
                                 + tuple(slice(0, d) for d in shape)]
        return [(_interp_archive(shape, padded.shape[1:], dtype, level, ab,
                                 eb_int, mean, *streams[f], config.zstd_level),
                 recs[f].astype(dtype, copy=False))
                for f, (ab, eb_int, _, mean) in enumerate(prep)]
    d, un, rec = _lorenzo_encode_group(works, [p[1] for p in prep], dtype,
                                       device)
    out = []
    for f, (ab, eb_int, work, mean) in enumerate(prep):
        arc = _lorenzo_archive(shape, dtype, ab, eb_int, mean, d[f], un[f],
                               work[un[f]], config.zstd_level)
        out.append((arc, rec[f]))
    return out


def decompress(arc: dict, device=None) -> np.ndarray:
    """Decode on ``device`` (``cuda`` unless given)."""
    if arc["kind"] != "szlike":
        raise ValueError("not an szlike archive")
    device = device_lib.resolve(device)
    if arc["predictor"] == "lorenzo":
        return _lorenzo_decode_group([arc], device)[0]
    level = arc["level"]
    _, phases = _interp_schedule(tuple(arc["shape"]), level)
    rec = _interp_decode(tuple(arc["pad_shape"]), arc["eb_int"], level, phases,
                         arc["mean"],
                         entropy.decode_codes(arc["codes"]).ravel(),
                         _decode_mask(arc["unpred"]),
                         entropy.decode_floats(arc["literals"]).ravel(), device)
    out = rec.cpu().numpy()[tuple(slice(0, d) for d in arc["shape"])]
    return out.astype(np.dtype(arc["dtype"]), copy=False)


def decode_key(arc: dict) -> tuple:
    """Archives agreeing here may share one stacked decode (the registry's
    ``decode_key``).  Per-field bounds are not part of it: they ride along
    as a vector, as on the encode side."""
    return (arc["predictor"], tuple(arc["shape"]), arc["dtype"],
            arc.get("level"), tuple(arc.get("pad_shape", ())))


def decompress_batched(arcs: list, device=None) -> list:
    """Decode a ``decode_key``-matched group; bit-identical to one
    :func:`decompress` per archive.  A Lorenzo group is one stacked
    ``lorenzo3d_inv`` launch, an interp group one stacked walk."""
    if not arcs:
        return []
    if any(a["kind"] != "szlike" for a in arcs):
        raise ValueError("not szlike archives")
    key = decode_key(arcs[0])
    if any(decode_key(a) != key for a in arcs):
        raise ValueError("decompress_batched needs decode_key-matched archives")
    device = device_lib.resolve(device)
    if arcs[0]["predictor"] == "lorenzo":
        return _lorenzo_decode_group(arcs, device)
    a0 = arcs[0]
    level = a0["level"]
    _, phases = _interp_schedule(tuple(a0["shape"]), level)
    streams = [(entropy.decode_codes(a["codes"]).ravel(),
                _decode_mask(a["unpred"]),
                entropy.decode_floats(a["literals"]).ravel()) for a in arcs]
    rec = _interp_decode_batched(tuple(a0["pad_shape"]),
                                 tuple(a["eb_int"] for a in arcs), level,
                                 phases, [a["mean"] for a in arcs], streams,
                                 device)
    out = rec.cpu().numpy()[(slice(None),)
                            + tuple(slice(0, d) for d in a0["shape"])]
    return [o.astype(np.dtype(a0["dtype"]), copy=False) for o in out]


# ---------------------------------------------------------------------------
# N-D Lorenzo (dual-quantization) delta
# ---------------------------------------------------------------------------

def lorenzo_delta(q: torch.Tensor, axes=None) -> torch.Tensor:
    """N-D first-order Lorenzo delta of an integer lattice (zero boundary):
    first differences along every axis of ``axes`` (all unless given; the
    batched stage passes ``range(1, ndim)`` to leave a field axis alone),
    inverted exactly by :func:`lorenzo_undelta`.  Plain tensor ops on any
    device; the 3-D stage's kernel is ``kernels.lorenzo3d``."""
    d = q
    for axis in (range(q.ndim) if axes is None else axes):
        n = q.shape[axis]
        if n == 1:
            continue
        shifted = torch.cat([torch.zeros_like(d.narrow(axis, 0, 1)),
                             d.narrow(axis, 0, n - 1)], dim=axis)
        d = d - shifted
    return d


def lorenzo_undelta(d: torch.Tensor, axes=None) -> torch.Tensor:
    """Inclusive prefix sums along ``axes`` in the lattice's integer type."""
    q = d
    for axis in (range(d.ndim) if axes is None else axes):
        if d.shape[axis] == 1:
            continue
        q = torch.cumsum(q, dim=axis, dtype=q.dtype)
    return q


def archive_nbytes(arc: dict) -> int:
    """Archive size in bytes: payloads plus a small header estimate."""
    n = 64
    for key in ("codes", "unpred", "literals"):
        if key in arc:
            n += arc[key]["nbytes"] + 16
    return n
