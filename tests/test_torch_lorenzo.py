"""The port's Lorenzo predictor and zfplike against the JAX package's eager
path, byte for byte: the plain versions of the ``lorenzo3d`` kernels against
``szlike._lorenzo_encode_core`` and ``lorenzo_undelta`` on the reference's
probe canaries, and the conventional archives of ``szlike-lorenzo`` and
``zfplike`` (payloads, escapes, literals, reconstruction), per field and
batched.  The CUDA kernels against these plain versions:
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compressors import szlike as ref_sz
from repro.compressors import zfplike as ref_zfp
from repro.data import fields as ref_fields
from repro_torch import kernels
from repro_torch.compressors import szlike as port_sz
from repro_torch.compressors import zfplike as port_zfp
from repro_torch.kernels import lorenzo3d

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)
LORENZO = (ref_sz.SZLikeConfig(predictor="lorenzo"),
           port_sz.SZLikeConfig(predictor="lorenzo"))


def _jit_probe_group():
    """``_lorenzo_jit_probe``'s canary: ragged odd shape, a NaN, a CODE_CAP
    overflow, a float32-cast boundary, two fields with their own bounds."""
    rng = np.random.default_rng(12345)
    x = np.cumsum(rng.standard_normal((2, 5, 7, 3)), axis=1).astype(np.float32)
    x[0, 0, 0, 0] = np.nan
    x[0, 1, 2, 0] = 3.0e9
    x[1, 2, 3, 1] = np.float32(2 ** 25) + 0.5
    return x, np.array([1e-3, 2e-2])


def _eager_probe_group():
    """``_probe_against_eager``'s canary: one field, one escape."""
    rng = np.random.default_rng(99)
    x = np.cumsum(rng.standard_normal((1, 6, 5, 4)), axis=1).astype(np.float32)
    x[0, 0, 0, 0] = 4.0e9
    return x, np.array([1e-3])


def _planar_group():
    """2-D fields (F=3, each with its own bound, at the archive tests'
    planar shape) with an infinity, an overflow and values on the
    lattice's half points, where division and multiplication by the
    reciprocal round apart."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 20, 24)) * 5
    eb = np.array([1e-3, 5e-2, 0.3])
    x[0, 1, 1] = np.inf
    x[1, 4, 2] = 1e12
    x[2, 3, 3] = 0.6 * 2.5            # (k + 1/2) * 2 eb
    x[2, 5, 7] = -0.6 * 7.5
    return x, eb


CANARIES = {"jit_probe": _jit_probe_group, "eager_probe": _eager_probe_group,
            "planar": _planar_group}


def _ref_encode(x, eb, out_dtype):
    eb_arr = jnp.asarray(eb.reshape((-1,) + (1,) * (x.ndim - 1)))
    return [np.asarray(a) for a in ref_sz._lorenzo_encode_core(
        jnp.asarray(x), eb_arr, out_dtype=out_dtype)]


@pytest.mark.parametrize("out_dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CANARIES))
def test_encode_plain_byte_identical_to_reference(case, out_dtype):
    x, eb = CANARIES[case]()
    x = x.astype(np.float64)            # the archive path's float64 work copy
    want = _ref_encode(x, eb, out_dtype)
    got = lorenzo3d.lorenzo3d_fwd(torch.from_numpy(x), eb,
                                  getattr(torch, out_dtype))
    for name, w, g in zip(("delta", "unpred", "rec"), want, got):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert got[1].any()                 # the canaries escaped


@pytest.mark.parametrize("case", sorted(CANARIES))
def test_undelta_and_decode_plain_byte_identical_to_reference(case):
    x, eb = CANARIES[case]()
    delta, unpred, rec = _ref_encode(x.astype(np.float64), eb, "float32")
    axes = range(1, delta.ndim)
    q = np.asarray(ref_sz.lorenzo_undelta(jnp.asarray(delta), axes=axes))
    got = lorenzo3d.lorenzo_undelta_plain(torch.from_numpy(delta), axes=axes)
    assert got.dtype == torch.int32 and got.numpy().tobytes() == q.tobytes()
    # Random deltas too: int32 sums are exact (and wrap alike).
    rng = np.random.default_rng(4)
    d = rng.integers(-2 ** 20, 2 ** 20, size=delta.shape, dtype=np.int32)
    assert (lorenzo3d.lorenzo_undelta_plain(torch.from_numpy(d), axes=axes)
            .numpy().tobytes()
            == np.asarray(ref_sz.lorenzo_undelta(jnp.asarray(d),
                                                 axes=axes)).tobytes())
    # Dequantized as the reference's decode does: q * (2 eb), float64.
    want = q.astype(np.float64) * (2.0 * eb.reshape((-1,) + (1,) * (q.ndim - 1)))
    dec = lorenzo3d.lorenzo3d_inv(torch.from_numpy(delta), eb).numpy()
    assert dec.tobytes() == want.tobytes()
    assert dec[~unpred].tobytes() == rec[~unpred].tobytes()


def _band_undelta(d, bh):
    """The inverse kernel's decomposition in plain torch, band by band: the
    carry rows (each column's sum over the rows above a band, per plane),
    then per band a walk over z that scans each column down the band, adds
    the carry, keeps the running sums over z, and scans each row along x.
    Sums in int64, wrapped to int32 at the end, as the kernel's unsigned
    arithmetic wraps."""
    f, nz, h, w = lorenzo3d._dims(d)
    d = d.reshape(f, nz, h, w).long()
    nb = -(-h // bh)
    carry = torch.zeros((f, nz, nb, w), dtype=torch.long)
    for b in range(1, nb):
        carry[:, :, b] = carry[:, :, b - 1] + d[:, :, (b - 1) * bh:b * bh].sum(2)
    q = torch.empty_like(d)
    for b in range(nb):
        y0, y1 = b * bh, min(h, (b + 1) * bh)
        state = torch.zeros((f, y1 - y0, w), dtype=torch.long)
        for z in range(nz):
            state += carry[:, z, b, None] + torch.cumsum(d[:, z, y0:y1], dim=1)
            q[:, z, y0:y1] = torch.cumsum(state, dim=2)
    return ((q + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


@pytest.mark.parametrize("bh", [8, 3, 1, 20])
@pytest.mark.parametrize("shape", [(1,) + SHAPE, (3,) + SHAPE, (3,) + SHAPE[1:]])
def test_inverse_band_decomposition_matches_undelta(shape, bh):
    """Bands of 8 rows (the kernel's, which do not divide 20), of 3, of one
    row and of the whole plane give the prefix sums of the plain inverse,
    with int32 sums that wrap."""
    rng = np.random.default_rng(bh + len(shape))
    d = torch.from_numpy(rng.integers(-2 ** 28, 2 ** 28, shape, dtype=np.int32))
    want = lorenzo3d.lorenzo_undelta_plain(d, axes=range(1, d.ndim))
    assert (lorenzo3d.lorenzo_undelta_plain(d.long(), axes=range(1, d.ndim)).abs()
            >= 2 ** 31).any()
    got = _band_undelta(d, bh).reshape(shape)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _striped_undelta(d, ws, bh):
    """The striped route of the inverse kernel (rows wider than a band's
    shared memory) in plain torch: each stripe of ``ws`` columns decoded by
    the band decomposition alone, plus the stripe's left prefix P[f, z, y,
    s] (the segment sums of each row, their exclusive scan over the
    stripes, then the inclusive prefix over y and z), in int64 wrapped to
    int32 as the kernel's unsigned sums wrap."""
    f, nz, h, w = lorenzo3d._dims(d)
    d = d.reshape(f, nz, h, w)
    ns = -(-w // ws)
    seg = torch.stack([d[..., s * ws:(s + 1) * ws].long().sum(-1)
                       for s in range(ns)], dim=-1)              # [f, z, y, s]
    left = torch.cumsum(seg, dim=-1) - seg
    left = torch.cumsum(torch.cumsum(left, dim=2), dim=1)
    parts = [_band_undelta(d[..., s * ws:(s + 1) * ws].contiguous(), bh).long()
             + left[..., s, None] for s in range(ns)]
    q = torch.cat(parts, dim=-1)
    return ((q + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


@pytest.mark.parametrize("ws,bh", [(8, 3), (7, 8), (24, 1), (5, 20)])
@pytest.mark.parametrize("shape", [(1,) + SHAPE, (3,) + SHAPE, (2,) + SHAPE[1:]])
def test_inverse_striped_decomposition_matches_undelta(shape, ws, bh):
    """Stripes that divide the rows (8 of 24), that do not (7, 5), one
    stripe of the whole row, with bands of 3, 8, 1 and 20 rows: the prefix
    sums of the plain inverse, int32 sums wrapping."""
    rng = np.random.default_rng(ws + bh + len(shape))
    d = torch.from_numpy(rng.integers(-2 ** 28, 2 ** 28, shape, dtype=np.int32))
    want = lorenzo3d.lorenzo_undelta_plain(d, axes=range(1, d.ndim))
    got = _striped_undelta(d, ws, bh).reshape(shape)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _field(dataset, rel_eb):
    """A snapshot field with a NaN and a CODE_CAP overflow at its bound."""
    name = ref_fields.DATASET_FIELDS[dataset][-1]
    x = ref_fields.make_fields(dataset, SHAPE, seed=1)[name].copy()
    eb = port_sz.abs_bound_from_rel(x, rel_eb)
    x[4, 7, 5] = np.nan
    x[4, 3, 11] = x[4, 3, 11] + 4.0 * (1 << 15) * eb
    return x, eb


def _same_archive(arc, ref_arc, payloads):
    for key in payloads:
        assert arc[key]["payload"] == ref_arc[key]["payload"], key
    assert list(arc) == list(ref_arc)
    for key in arc:
        if key not in payloads:
            assert arc[key] == ref_arc[key], key


SZ_PAYLOADS = ("codes", "unpred", "literals")
ZFP_PAYLOADS = ("emax", "bshift", "coeff", "corr_mask", "corr_codes",
                "lit_mask", "lit_vals")


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("dataset,rel_eb", [("hurricane", 1e-3),
                                            ("miranda", 1e-4)])
def test_lorenzo_archive_byte_identical(dataset, rel_eb, planar):
    x, eb = _field(dataset, rel_eb)
    if planar:
        x = x[4]
    ref_arc, ref_rec = ref_sz.compress(x, abs_eb=eb, config=LORENZO[0],
                                       lowering="eager")
    arc, rec = port_sz.compress(x, abs_eb=eb, config=LORENZO[1], device="cpu")
    _same_archive(arc, ref_arc, SZ_PAYLOADS)
    assert rec.dtype == ref_rec.dtype and rec.tobytes() == ref_rec.tobytes()
    assert ref_sz._decode_mask(arc["unpred"]).sum() >= 2
    dec = port_sz.decompress(arc, device="cpu")
    assert dec.tobytes() == rec.tobytes()
    assert port_sz.decompress(ref_arc, device="cpu").tobytes() == ref_rec.tobytes()
    assert ref_sz.decompress(arc).tobytes() == rec.tobytes()


@pytest.mark.parametrize("compressor", ["szlike-lorenzo", "zfplike"])
def test_batched_archives_byte_identical(compressor):
    """Three fields in one batched call, one of them with a NaN: the
    reference's batched archives, each equal to a per-field call's, and one
    stacked decode equal to each ``rec``."""
    fields = ref_fields.make_fields("hurricane", SHAPE, seed=2)
    xs = [a.copy() for a in fields.values()]
    xs[1][3, 4, 5] = np.nan
    if compressor == "zfplike":
        ref_mod, port_mod, payloads, kw = ref_zfp, port_zfp, ZFP_PAYLOADS, {}
    else:
        ref_mod, port_mod, payloads = ref_sz, port_sz, SZ_PAYLOADS
        kw = {"config": LORENZO[1]}
    ref_kw = {"config": LORENZO[0], "lowering": "eager"} if kw else {}
    want = ref_mod.compress_batched(xs, 1e-3, **ref_kw)
    got = port_mod.compress_batched(xs, 1e-3, device="cpu", **kw)
    single = port_mod.compress(xs[1], 1e-3, device="cpu", **kw)
    _same_archive(single[0], got[1][0], payloads)
    for (arc, rec), (ref_arc, ref_rec) in zip(got, want):
        _same_archive(arc, ref_arc, payloads)
        assert rec.tobytes() == ref_rec.tobytes()
    decoded = port_mod.decompress_batched([a for a, _ in got], device="cpu")
    for (_, rec), dec in zip(got, decoded):
        assert dec.dtype == rec.dtype and dec.tobytes() == rec.tobytes()
    assert port_mod.decode_key(got[0][0]) == ref_mod.decode_key(want[0][0])


@pytest.mark.parametrize("dataset", ["hurricane", "miranda"])
def test_zfplike_archive_byte_identical(dataset):
    x, eb = _field(dataset, 1e-3)
    ref_arc, ref_rec = ref_zfp.compress(x, abs_eb=eb)
    arc, rec = port_zfp.compress(x, abs_eb=eb, device="cpu")
    _same_archive(arc, ref_arc, ZFP_PAYLOADS)
    assert rec.tobytes() == ref_rec.tobytes()
    assert port_zfp.decompress(arc, device="cpu").tobytes() == rec.tobytes()
    assert ref_zfp.decompress(arc).tobytes() == rec.tobytes()
    finite = np.isfinite(x)
    assert np.abs(rec[finite].astype(np.float64) - x[finite]).max() <= eb


def test_lift_transform_matches_reference():
    """The int32 lifting pair on the device: arithmetic shifts and wrapping
    sums as in JAX, and exactly invertible."""
    rng = np.random.default_rng(8)
    # 90 blocks: the block count of a SHAPE field, compiled once for both.
    blocks = rng.integers(-2 ** 30, 2 ** 30, size=(90, 4, 4, 4), dtype=np.int32)
    fwd = port_zfp._transform(blocks, False, "cpu")
    assert fwd.tobytes() == np.asarray(
        ref_zfp._transform(jnp.asarray(blocks), inverse=False)).tobytes()
    inv = port_zfp._transform(fwd, True, "cpu")
    assert inv.tobytes() == np.asarray(
        ref_zfp._transform(jnp.asarray(fwd), inverse=True)).tobytes()


@pytest.mark.parametrize("shape,axes", [(SHAPE, None), (SHAPE, (1, 2)),
                                         (SHAPE[1:], None), ((1, 20, 24), None)])
def test_nd_lorenzo_delta_matches_reference(shape, axes):
    rng = np.random.default_rng(len(shape) + (axes is None))
    q = rng.integers(-3000, 3000, shape).astype(np.int32)
    want = np.asarray(ref_sz.lorenzo_delta(jnp.asarray(q), axes=axes))
    got = port_sz.lorenzo_delta(torch.from_numpy(q), axes=axes)
    assert got.dtype == torch.int32 and got.numpy().tobytes() == want.tobytes()
    back = port_sz.lorenzo_undelta(got, axes=axes)
    assert back.numpy().tobytes() == q.tobytes()
    assert back.numpy().tobytes() == np.asarray(
        ref_sz.lorenzo_undelta(jnp.asarray(want), axes=axes)).tobytes()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    kernels.reset_launch_counts()
    x, eb = _eager_probe_group()
    d, _, _ = lorenzo3d.lorenzo3d_fwd(torch.from_numpy(x.astype(np.float64)),
                                      eb, torch.float32)
    lorenzo3d.lorenzo3d_inv(d, eb)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    with pytest.raises(TypeError, match="float64"):
        lorenzo3d.lorenzo3d_fwd(torch.from_numpy(x), eb, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        lorenzo3d.lorenzo3d_inv(d.long(), eb)
    with pytest.raises(ValueError, match="bounds"):
        lorenzo3d.lorenzo3d_inv(d, [1e-3, 1e-3])
    with pytest.raises(ValueError, match="group"):
        lorenzo3d.lorenzo3d_inv(d[0, 0], eb)
