"""The port's kernel modules: each plain PyTorch version against the JAX
package (conv2d3x3 against the Pallas kernel in interpret mode and its
``ref.py`` oracle, its dgrad and wgrad against ``jax.vjp`` of that oracle;
fused_enhance against the eager reference that writes archives), and the
CPU routing of the wrappers.  The CUDA kernels against
their plain versions: ``test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regulation as ref_regulation
from repro.kernels import conv2d3x3 as pallas_conv
from repro.kernels import ref as kernel_ref
from repro_torch import kernels
from repro_torch.core import regulation as port_regulation
from repro_torch.kernels import conv2d3x3 as port_conv
from repro_torch.kernels import fused_enhance as port_fe

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)


# (H, W, Cin, Cout, stride): the 17×13 probe shape, stride 2 on odd and on
# even sizes (XLA pads lo=0, hi=1 there), Cout=1 (the network head).
CONV_CASES = [(17, 13, 1, 4, 1), (17, 13, 4, 6, 2), (16, 12, 6, 8, 2),
              (17, 13, 8, 1, 1), (9, 7, 12, 3, 2)]


def _conv_inputs(h, w, cin, cout, n=2):
    rng = np.random.default_rng([h, w, cin, cout])
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("h,w,cin,cout,stride", CONV_CASES)
def test_conv_plain_matches_pallas_and_oracle(h, w, cin, cout, stride, relu):
    x, wt, b = _conv_inputs(h, w, cin, cout)
    got = port_conv.conv2d3x3(torch.from_numpy(x), torch.from_numpy(wt),
                              torch.from_numpy(b), stride=stride, relu=relu)
    pallas = np.asarray(pallas_conv.conv2d3x3(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=stride,
        relu=relu, interpret=True))
    oracle = np.asarray(kernel_ref.conv2d3x3_ref(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=stride,
        relu=relu))
    assert got.shape == pallas.shape == oracle.shape
    # float32 sums of at most 9*Cin=108 terms in another order: a few ulp
    # of the largest partial sum, far inside 1e-5 relative.
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,cin,cout,stride", CONV_CASES)
def test_conv_backward_matches_autograd_of_plain(h, w, cin, cout, stride):
    x, wt, b = (torch.from_numpy(a).requires_grad_()
                for a in _conv_inputs(h, w, cin, cout))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, port_conv.same_pads(h, stride)[0],
         port_conv.same_pads(w, stride)[0], cout)).astype(np.float32))
    want = torch.autograd.grad(
        port_conv.conv2d3x3_plain(x, wt, b, stride=stride, relu=True), (x, wt, b), g)
    got = torch.autograd.grad(
        port_conv.conv3x3(x, wt, b, stride=stride, relu=True), (x, wt, b), g)
    # Same terms summed in another order (float32): 1e-5 relative.
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


def _vjp_ref(x, wt, b, g, stride, relu):
    """The JAX package's gradient of its conv oracle at ``g``:
    ``(y, dx, dw, db)`` as numpy arrays."""
    y, pullback = jax.vjp(
        lambda a, c, d: kernel_ref.conv2d3x3_ref(a, c, d, stride=stride, relu=relu),
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    return (np.array(y), *(np.array(t) for t in pullback(jnp.asarray(g))))


def _out_grad(h, w, cout, stride):
    return np.random.default_rng([h, w, cout, stride]).standard_normal(
        (2, port_conv.same_pads(h, stride)[0], port_conv.same_pads(w, stride)[0],
         cout)).astype(np.float32)


def _assert_sums_close(got, want, terms):
    """``got`` within 1e-5 of each sum's own scale ``terms`` (the sum of
    the absolute values of its float32 terms, up to 2·Ho·Wo = 442 of them
    here): another summation order moves a sum by a few ulp of that scale,
    a wrong or missing term by a large share of it."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = 1e-5 * np.asarray(terms, np.float64) + 1e-6
    assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("h,w,cin,cout,stride", CONV_CASES)
def test_conv_dgrad_wgrad_plain_match_jax_vjp(h, w, cin, cout, stride, relu):
    x, wt, b = _conv_inputs(h, w, cin, cout)
    g = _out_grad(h, w, cout, stride)
    y, dx, dw, db = _vjp_ref(x, wt, b, g, stride, relu)
    # The reference's own output carries the ReLU mask to both sides.
    yt, gt, xt, wtt = (torch.from_numpy(a) for a in (y, g, x, wt))
    got_dx = port_conv.conv2d3x3_dgrad_plain(gt, yt, wtt, x.shape,
                                             stride=stride, relu=relu)
    got_dw, got_db = port_conv.conv2d3x3_wgrad_plain(gt, yt, xt, stride=stride,
                                                     relu=relu)
    assert got_dx.shape == dx.shape and got_dw.shape == dw.shape
    # dx: float32 sums of <= 9*Cout = 72 terms in another order.
    np.testing.assert_allclose(got_dx.numpy(), dx, rtol=1e-5, atol=1e-5)
    gm = port_conv.relu_mask(gt, yt, relu).abs()
    terms_dw, terms_db = port_conv.conv2d3x3_wgrad_plain(gm, yt, xt.abs(),
                                                         stride=stride, relu=False)
    _assert_sums_close(got_dw.numpy(), dw, terms_dw.numpy())
    _assert_sums_close(got_db.numpy(), db, terms_db.numpy())


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("h,w,cin,cout,stride", [CONV_CASES[1], CONV_CASES[2]])
def test_conv3x3_autograd_matches_jax_vjp(h, w, cin, cout, stride, need_dx):
    """Through the autograd function on CPU tensors, with and without an
    input gradient (the enhancer's conv_in needs none)."""
    x, wt, b = _conv_inputs(h, w, cin, cout)
    g = _out_grad(h, w, cout, stride)
    _, dx, dw, db = _vjp_ref(x, wt, b, g, stride, True)
    xt = torch.from_numpy(x).requires_grad_(need_dx)
    wtt, bt = (torch.from_numpy(a).requires_grad_() for a in (wt, b))
    inputs = (xt, wtt, bt) if need_dx else (wtt, bt)
    got = torch.autograd.grad(port_conv.conv3x3(xt, wtt, bt, stride=stride),
                              inputs, torch.from_numpy(g))
    want = (dx, dw, db) if need_dx else (dw, db)
    # Same terms summed in another order (float32), <= 442 terms of |x·g|
    # below 10: 1e-4 absolute.
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["strict", "relaxed"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_enhance_byte_identical_to_reference(dtype, mode):
    decomp, resid, orig, eb = ref_regulation._enhance_canaries()
    decomp, orig = decomp.astype(dtype), orig.astype(dtype)
    want_rec, want_mask = ref_regulation.fused_enhance(
        decomp, resid, orig, eb, out_dtype=dtype, mode=mode)
    got_rec, got_mask = port_regulation.fused_enhance(
        torch.from_numpy(decomp), torch.from_numpy(resid),
        torch.from_numpy(orig), eb, mode=mode)
    assert got_rec.numpy().dtype == want_rec.dtype
    assert got_rec.numpy().tobytes() == want_rec.tobytes()
    if mode == "strict":
        assert got_mask.numpy().tobytes() == want_mask.tobytes()
    else:
        assert got_mask is None
    if dtype == np.float32:   # the double-rounding canary stayed unrounded
        assert got_rec[0, 0, 0].item() == 1.0 + 2.0 ** -23
    # The unfused sequence, piece by piece, against the reference's.
    enh = port_regulation.enhance(torch.from_numpy(decomp),
                                  torch.from_numpy(resid), eb)
    assert enh.numpy().tobytes() == ref_regulation.enhance(
        decomp, resid, eb, dtype).tobytes()
    mask = port_regulation.outlier_mask(torch.from_numpy(orig), enh, eb)
    assert mask.numpy().tobytes() == ref_regulation.outlier_mask(
        orig, enh.numpy(), eb).tobytes()
    final = port_regulation.apply_strict(enh, torch.from_numpy(decomp), mask)
    if mode == "strict":
        assert final.numpy().tobytes() == want_rec.tobytes()


def test_fused_enhance_regulated_plain():
    rng = np.random.default_rng(6)
    z = rng.standard_normal((4, 9, 11)).astype(np.float32) * 3
    dec = rng.standard_normal(z.shape)
    eb = 0.05
    out, mask = port_fe.fused_enhance(
        torch.from_numpy(z), torch.from_numpy(dec), torch.from_numpy(dec), eb,
        regulated=True, strict=False)
    # float64 sigmoid in two libraries: agree to a few ulp of eb.
    want = dec + (2.0 / (1.0 + np.exp(-z.astype(np.float64))) - 1.0) * eb
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-15)
    assert not mask.any()   # |2σ(z) − 1| < 1: never past eb


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    kernels.reset_launch_counts()
    x, wt, b = (torch.from_numpy(a) for a in _conv_inputs(8, 8, 2, 3))
    port_conv.conv2d3x3(x, wt, b)
    z = torch.zeros(5, dtype=torch.float32)
    port_fe.fused_enhance(z, z.double(), z.double(), 0.1)
    gx, gw, gb = (t.requires_grad_() for t in (x.clone(), wt.clone(), b.clone()))
    port_conv.conv3x3(gx, gw, gb).sum().backward()
    assert kernels.launch_counts() == {"conv2d3x3": 0, "conv2d3x3_bwd": 0,
                                       "conv2d3x3_grouped": 0,
                                       "conv2d3x3_grouped_bwd": 0,
                                       "fused_enhance": 0, "lorenzo3d_fwd": 0,
                                       "lorenzo3d_inv": 0}
    with pytest.raises(ValueError, match="output channels"):
        port_conv.conv2d3x3(x, torch.zeros(3, 3, 2, 9), torch.zeros(9))
    with pytest.raises(TypeError, match="float32"):
        port_conv.conv2d3x3(x.double(), wt.double(), b.double())
    with pytest.raises(TypeError, match="share"):
        port_fe.fused_enhance(z, z, z.double(), 0.1)
