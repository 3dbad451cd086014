"""Transform-based error-bounded lossy compressor (ZFP-style), in PyTorch.

Pipeline (Lindstrom, TVCG'14, adapted), as in the JAX package:
  1. partition the field into 4^d blocks (edge-padded),
  2. per-block block-floating-point: scale by 2^(P-2-emax) to int32,
  3. ZFP's exactly invertible integer lifting transform along each axis,
  4. quantize coefficients by an arithmetic right shift of ``b`` bits chosen
     from the error bound,
  5. the codec over the coefficient planes (coefficient-major layout),
  6. a sparse correction pass: any point whose reconstruction error would
     exceed ``eb`` gets an extra error-bounded correction code, so the
     pointwise bound holds exactly.

The lifting transform runs on the device in int32 tensor ops over all blocks
at once (``>>`` on int32 is an arithmetic shift, and int32 sums wrap, as in
JAX); the block layout, the float64 stages and the correction pass are the
reference's numpy, on the host.  Integer arithmetic is exact, so payloads
are byte-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_lib
from . import entropy
from .quantize import abs_bound_from_rel
from .szlike import _decode_mask, _encode_mask

_P = 24  # fixed-point precision bits (int32 with transform headroom)


@dataclasses.dataclass(frozen=True)
class ZFPLikeConfig:
    zstd_level: int = 9
    eb_margin: float = 1e-9
    # Heuristic transform-gain guard when picking the shift width.
    gain_log2: int = 3


def _fwd_lift(v: torch.Tensor, axis: int) -> torch.Tensor:
    """ZFP fwd_lift along an axis of length 4 (arithmetic shifts, int32)."""
    x, y, z, w = torch.movedim(v, axis, 0)
    x = x + w; x = x >> 1; w = w - x
    z = z + y; z = z >> 1; y = y - z
    x = x + z; x = x >> 1; z = z - x
    w = w + y; w = w >> 1; y = y - w
    w = w + (y >> 1); y = y - (w >> 1)
    return torch.movedim(torch.stack([x, y, z, w]), 0, axis)


def _inv_lift(v: torch.Tensor, axis: int) -> torch.Tensor:
    x, y, z, w = torch.movedim(v, axis, 0)
    y = y + (w >> 1); w = w - (y >> 1)
    y = y + w; w = w << 1; w = w - y
    z = z + x; x = x << 1; x = x - z
    y = y + z; z = z << 1; z = z - y
    w = w + x; x = x << 1; x = x - w
    return torch.movedim(torch.stack([x, y, z, w]), 0, axis)


def _transform(blocks_i: np.ndarray, inverse: bool, device) -> np.ndarray:
    """The lifting transform of every block ``[nb, 4(, 4), 4]`` on
    ``device``; int32 in, int32 out."""
    out = torch.from_numpy(np.ascontiguousarray(blocks_i, np.int32)).to(device)
    axes = list(range(1, out.ndim))
    for ax in (reversed(axes) if inverse else axes):
        out = (_inv_lift if inverse else _fwd_lift)(out, ax)
    return out.cpu().numpy()


def _blockify(x: np.ndarray):
    """Pad to multiples of 4 and reshape to (nblocks, 4[,4[,4]])."""
    pads = [(0, (-d) % 4) for d in x.shape]
    xp = np.pad(x, pads, mode="edge")
    grid = tuple(d // 4 for d in xp.shape)
    if x.ndim == 2:
        b = xp.reshape(grid[0], 4, grid[1], 4).transpose(0, 2, 1, 3)
        blocks = b.reshape(-1, 4, 4)
    else:
        b = xp.reshape(grid[0], 4, grid[1], 4, grid[2], 4).transpose(0, 2, 4, 1, 3, 5)
        blocks = b.reshape(-1, 4, 4, 4)
    return blocks, xp.shape, grid


def _unblockify(blocks: np.ndarray, pad_shape, grid, shape) -> np.ndarray:
    if len(shape) == 2:
        b = blocks.reshape(grid[0], grid[1], 4, 4).transpose(0, 2, 1, 3)
    else:
        b = blocks.reshape(grid[0], grid[1], grid[2], 4, 4, 4).transpose(0, 3, 1, 4, 2, 5)
    return b.reshape(pad_shape)[tuple(slice(0, d) for d in shape)]


def _block_scales(blocks: np.ndarray):
    """Per-block ``(emax, scale, int32 blocks)`` of block floating point."""
    nb = blocks.shape[0]
    amax = np.abs(blocks.reshape(nb, -1)).max(axis=1)
    emax = np.where(amax > 0, np.ceil(np.log2(np.maximum(amax, 1e-300))),
                    -126).astype(np.int32)
    scale = np.exp2((_P - 2) - emax.astype(np.float64))
    bshape = (nb,) + (1,) * (blocks.ndim - 1)
    ints = np.clip(np.round(blocks * scale.reshape(bshape)),
                   -(2**30), 2**30 - 1).astype(np.int32)
    return emax, scale, ints


def _shift_widths(eb, scale: np.ndarray, config: ZFPLikeConfig) -> np.ndarray:
    """Shift width from the bound: one ulp of the shifted coefficient maps
    to ~2^(b+gain) / scale in value space; keep that below eb."""
    with np.errstate(divide="ignore"):
        b_f = np.floor(np.log2(np.maximum(eb * scale, 1e-300))) - config.gain_log2
    return np.clip(b_f, 0, 30).astype(np.int32)


def _descale(coeff_q, bshift, emax, device) -> np.ndarray:
    """Dequantize, inverse-transform and descale the blocks."""
    bshape = (coeff_q.shape[0],) + (1,) * (coeff_q.ndim - 1)
    coeff_dq = coeff_q << bshift.reshape(bshape)
    ints_rec = _transform(coeff_dq, True, device)
    scale = np.exp2((_P - 2) - emax.astype(np.float64))
    return ints_rec.astype(np.float64) / scale.reshape(bshape)


def _finish(x, work, nonfinite, rec, eb: float, abs_eb: float, emax, bshift,
            coeff_q, pad_shape, grid, config: ZFPLikeConfig):
    """Correction pass, literal escapes and the archive of one field."""
    dtype = x.dtype
    nb = coeff_q.shape[0]
    err = work - rec
    need = np.abs(err) > eb
    corr_codes = np.round(err[need] / (2.0 * eb)).astype(np.int32)
    rec[need] = rec[need] + corr_codes * (2.0 * eb)
    # Literal escapes: non-finite points plus any point the output-dtype
    # cast would push past the bound.
    cast_bad = np.abs(rec.astype(dtype).astype(np.float64) - work) > eb
    lit_mask = nonfinite | cast_bad
    rec[lit_mask] = x.astype(np.float64)[lit_mask]
    level = config.zstd_level
    arc = {
        "kind": "zfplike",
        "shape": list(work.shape), "pad_shape": list(pad_shape),
        "grid": list(grid),
        "dtype": str(dtype), "abs_eb": abs_eb, "eb_int": eb,
        "emax": entropy.encode_codes(emax, level),
        "bshift": entropy.encode_codes(bshift, level),
        # Coefficient-major layout: same coefficient across blocks adjacent.
        "coeff": entropy.encode_codes(
            np.moveaxis(coeff_q, 0, -1).reshape(-1, nb), level),
        "corr_mask": _encode_mask(need.ravel(), level),
        "corr_codes": entropy.encode_codes(corr_codes, level),
        "lit_mask": _encode_mask(lit_mask.ravel(), level),
        "lit_vals": entropy.encode_floats(
            np.asarray(x, dtype=np.float64)[lit_mask], level),
    }
    arc["nbytes"] = archive_nbytes(arc)
    return arc, rec.astype(dtype, copy=False)


def compress(x: np.ndarray, rel_eb: float | None = None, *,
             abs_eb: float | None = None,
             config: ZFPLikeConfig = ZFPLikeConfig(),
             device=None) -> tuple[dict, np.ndarray]:
    """Compress ``x``, the transform on ``device`` (``cuda`` unless given);
    returns ``(archive, reconstruction)``."""
    return compress_batched([x], rel_eb, abs_eb=abs_eb, config=config,
                            device=device)[0]


def compress_batched(xs, rel_eb: float | None = None, *,
                     abs_eb: float | None = None,
                     config: ZFPLikeConfig = ZFPLikeConfig(),
                     device=None) -> list:
    """Compress a group of same-shape, same-dtype fields with one forward
    and one inverse transform over all their blocks (exact int32, so
    batching changes no bit); per-field bounds ride along per block.
    Payloads are byte-identical to one :func:`compress` per field."""
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

    abs_ebs, ebs, works, nonfinites, blocks_per = [], [], [], [], []
    pad_shape = grid = None
    for a in arrs:
        ae = float(abs_eb) if abs_eb is not None else abs_bound_from_rel(a, rel_eb)
        abs_ebs.append(float(ae))
        ebs.append(float(ae) * (1.0 - config.eb_margin))
        w = np.nan_to_num(a.astype(np.float64), nan=0.0, posinf=0.0, neginf=0.0)
        works.append(w)
        nonfinites.append(~np.isfinite(a.astype(np.float64)))
        blocks, pad_shape, grid = _blockify(w)
        blocks_per.append(blocks)
    nb = blocks_per[0].shape[0]

    emax, scale, ints = _block_scales(np.concatenate(blocks_per, axis=0))
    coeff = _transform(ints, False, device)
    bshift = _shift_widths(np.repeat(np.asarray(ebs, np.float64), nb), scale,
                           config)
    coeff_q = coeff >> bshift.reshape((-1,) + (1,) * (coeff.ndim - 1))
    blocks_rec = _descale(coeff_q, bshift, emax, device)

    out = []
    for f, a in enumerate(arrs):
        sl = slice(f * nb, (f + 1) * nb)
        rec = _unblockify(blocks_rec[sl], tuple(pad_shape), tuple(grid), shape)
        out.append(_finish(a, works[f], nonfinites[f], rec, ebs[f], abs_ebs[f],
                           emax[sl], bshift[sl], coeff_q[sl], pad_shape, grid,
                           config))
    return out


def _decode_group(arcs: list, device) -> list:
    shape = tuple(arcs[0]["shape"])
    grid = tuple(arcs[0]["grid"])
    nb = int(np.prod(grid))
    bdims = (4,) * len(shape)
    emax = np.concatenate([entropy.decode_codes(a["emax"]).ravel() for a in arcs])
    bshift = np.concatenate([entropy.decode_codes(a["bshift"]).ravel()
                             for a in arcs])
    coeff_q = np.concatenate(
        [np.moveaxis(entropy.decode_codes(a["coeff"]).reshape(bdims + (nb,)),
                     -1, 0) for a in arcs], axis=0)
    blocks_rec = _descale(coeff_q, bshift, emax, device)
    out = []
    for f, arc in enumerate(arcs):
        rec = _unblockify(blocks_rec[f * nb:(f + 1) * nb],
                          tuple(arc["pad_shape"]), grid, shape)
        need = _decode_mask(arc["corr_mask"]).reshape(shape)
        corr = entropy.decode_codes(arc["corr_codes"]).ravel()
        rec[need] = rec[need] + corr * (2.0 * arc["eb_int"])
        nfm = _decode_mask(arc["lit_mask"]).reshape(shape)
        if nfm.any():
            rec[nfm] = entropy.decode_floats(arc["lit_vals"]).ravel()
        out.append(rec.astype(np.dtype(arc["dtype"]), copy=False))
    return out


def decompress(arc: dict, device=None) -> np.ndarray:
    """Decode, the inverse transform on ``device`` (``cuda`` unless given)."""
    if arc["kind"] != "zfplike":
        raise ValueError("not a zfplike archive")
    return _decode_group([arc], device_lib.resolve(device))[0]


def decode_key(arc: dict) -> tuple:
    """Registry ``decode_key``: archives agreeing here share one stacked
    decode.  The per-field bound is excluded: corrections and literals are
    applied per field after the shared transform."""
    return (tuple(arc["shape"]), arc["dtype"], tuple(arc["pad_shape"]),
            tuple(arc["grid"]))


def decompress_batched(arcs: list, device=None) -> list:
    """Decode a ``decode_key``-matched group through one inverse transform;
    bit-identical to one :func:`decompress` per archive."""
    if not arcs:
        return []
    if any(a["kind"] != "zfplike" for a in arcs):
        raise ValueError("not zfplike archives")
    key = decode_key(arcs[0])
    if any(decode_key(a) != key for a in arcs):
        raise ValueError("decompress_batched needs decode_key-matched archives")
    return _decode_group(arcs, device_lib.resolve(device))


def archive_nbytes(arc: dict) -> int:
    n = 64
    for key in ("emax", "bshift", "coeff", "corr_mask", "corr_codes",
                "lit_mask", "lit_vals"):
        if key in arc:
            n += arc[key]["nbytes"] + 16
    return n
