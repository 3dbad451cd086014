"""The port's CUDA kernels against their plain PyTorch versions, on a machine
with an NVIDIA GPU and nvcc (marker ``cuda``; they skip without a GPU).
This file imports neither JAX nor ``repro``, so it runs where only the port's
dependencies are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv2d3x3 as conv
from repro_torch.kernels import fused_enhance as fe
from repro_torch.kernels import lorenzo3d

# (N, H, W, Cin, Cout, stride): odd sizes, stride 2 on odd and even sizes
# (XLA's SAME pads lo=0, hi=1 there), Cout=1, and the enhancer's six conv
# layers on a 512×512 training batch (conv_in, down1-4, conv_out).
CONV_CASES = [(2, 17, 13, 1, 4, 1), (2, 17, 13, 4, 6, 2), (2, 16, 12, 6, 8, 2),
              (2, 17, 13, 8, 1, 1), (2, 9, 7, 16, 3, 2), (10, 512, 512, 1, 4, 1),
              (10, 512, 512, 4, 4, 2), (10, 256, 256, 4, 6, 2),
              (10, 128, 128, 6, 6, 2), (10, 64, 64, 6, 8, 2),
              (10, 512, 512, 8, 1, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch import device
    return device.resolve("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("n,h,w,cin,cout,stride", CONV_CASES)
def test_conv_kernel_matches_plain(cuda_device, n, h, w, cin, cout, stride, relu):
    gen = torch.Generator().manual_seed(h * w + cin)
    x = torch.randn((n, h, w, cin), generator=gen).to(cuda_device)
    wt = (torch.randn((3, 3, cin, cout), generator=gen) * 0.3).to(cuda_device)
    b = (torch.randn((cout,), generator=gen) * 0.1).to(cuda_device)
    before = conv.launches
    got = conv.conv2d3x3(x, wt, b, stride=stride, relu=relu)
    torch.cuda.synchronize()
    assert conv.launches == before + 1
    want = conv.conv2d3x3_plain(x, wt, b, stride=stride, relu=relu)
    # float32 sums of <= 144 terms in another order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _bwd_inputs(device, n, h, w, cin, cout, stride, relu):
    """x, w, the kernel forward's y and an output gradient g."""
    gen = torch.Generator().manual_seed(h * w + cin + 7)
    x = torch.randn((n, h, w, cin), generator=gen).to(device)
    wt = (torch.randn((3, 3, cin, cout), generator=gen) * 0.3).to(device)
    b = (torch.randn((cout,), generator=gen) * 0.1).to(device)
    y = conv.conv2d3x3(x, wt, b, stride=stride, relu=relu)
    g = torch.randn(tuple(y.shape), generator=gen).to(device)
    return x, wt, y, g


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("n,h,w,cin,cout,stride", CONV_CASES)
def test_conv_bwd_kernels_match_plain(cuda_device, n, h, w, cin, cout, stride,
                                      relu, need_dx):
    """With and without dx: the wgrad blocks' count, and so the order of
    the sums, depends on the share of the grid that dgrad takes."""
    x, wt, y, g = _bwd_inputs(cuda_device, n, h, w, cin, cout, stride, relu)
    before = conv.bwd_launches
    dx, dw, db = conv.conv2d3x3_bwd(g, y, x, wt, stride=stride, relu=relu,
                                    need_dx=need_dx)
    again = conv.conv2d3x3_bwd(g, y, x, wt, stride=stride, relu=relu,
                               need_dx=need_dx)
    torch.cuda.synchronize()
    assert conv.bwd_launches == before + 2
    assert (dx is None) == (again[0] is None) == (not need_dx)
    assert conv.bwd_kernels_per_call(x.shape, cout, stride=stride,
                                     need_dx=need_dx) in (1, 2)
    # Deterministic: the same inputs give the same bytes.
    for a, e in zip((dx, dw, db), again):
        if a is not None:
            assert torch.equal(a.view(torch.int32), e.view(torch.int32))
    want_dw, want_db = conv.conv2d3x3_wgrad_plain(g, y, x, stride=stride, relu=relu)
    if need_dx:
        want_dx = conv.conv2d3x3_dgrad_plain(g, y, wt, x.shape, stride=stride,
                                             relu=relu)
        # dx: float32 sums of <= 9*Cout = 72 terms in another order.
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    # dw and db sum up to N*Ho*Wo = 2.6M float32 terms, in blocks, in
    # another order than cuBLAS's: each within 1e-5 of the sum of its terms'
    # absolute values (sum |x * g'|), where a wrong or missing tap would
    # move it by a large share.
    gm = conv.relu_mask(g, y, relu).abs()
    terms_dw, terms_db = conv.conv2d3x3_wgrad_plain(gm, y, x.abs(), stride=stride,
                                                    relu=False)
    assert ((dw - want_dw).abs() <= 1e-5 * terms_dw + 1e-6).all()
    assert ((db - want_db).abs() <= 1e-5 * terms_db + 1e-6).all()


def _bwd_bytes(device, case, relu=True, need_dx=True):
    x, wt, y, g = _bwd_inputs(device, *case, relu)
    got = conv.conv2d3x3_bwd(g, y, x, wt, stride=case[-1], relu=relu,
                             need_dx=need_dx)
    return [t.cpu().numpy().tobytes() for t in got if t is not None]


@pytest.mark.cuda
def test_conv_bwd_back_to_back_shapes_match_alone(cuda_device):
    """Calls of different shapes back to back share the launch's ticket
    counter, which the last block of each call sets back to zero: each
    call's bytes equal those of the same call alone."""
    cases = [(10, 512, 512, 8, 1, 1), (10, 64, 64, 6, 8, 2), (2, 11, 9, 5, 7, 1),
             (10, 512, 512, 1, 4, 1), (2, 17, 13, 4, 6, 2)]
    alone = {}
    for c in cases:
        alone[c] = _bwd_bytes(cuda_device, c, need_dx=c[3] != 1)
        torch.cuda.synchronize()
    for c in cases[::-1] + cases[1::2] + cases[::2]:
        assert _bwd_bytes(cuda_device, c, need_dx=c[3] != 1) == alone[c], c
    assert all(int(t.abs().sum()) == 0 for t in conv._group_tickets.values())


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bwd_run_time_channels(cuda_device, stride, need_dx):
    """Cin and Cout off the enhancer's layers take the kernel whose channel
    counts are run-time values."""
    x, wt, y, g = _bwd_inputs(cuda_device, 3, 37, 70, 5, 7, stride, True)
    dx, dw, db = conv.conv2d3x3_bwd(g, y, x, wt, stride=stride, need_dx=need_dx)
    torch.cuda.synchronize()
    assert (dx is None) == (not need_dx)
    if need_dx:
        want_dx = conv.conv2d3x3_dgrad_plain(g, y, wt, x.shape, stride=stride)
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    want_dw, want_db = conv.conv2d3x3_wgrad_plain(g, y, x, stride=stride)
    terms_dw, terms_db = conv.conv2d3x3_wgrad_plain(
        conv.relu_mask(g, y, True).abs(), y, x.abs(), stride=stride, relu=False)
    assert ((dw - want_dw).abs() <= 1e-5 * terms_dw + 1e-6).all()
    assert ((db - want_db).abs() <= 1e-5 * terms_db + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [True, False])
def test_conv_autograd_on_gpu(cuda_device, need_dx):
    """Through the autograd function: one backward launch per call (dgrad
    skipped without an input gradient), matching the plain backward."""
    gen = torch.Generator().manual_seed(3)
    x, wt, b = (t.to(cuda_device).requires_grad_() for t in (
        torch.randn((2, 17, 13, 4), generator=gen),
        torch.randn((3, 3, 4, 6), generator=gen) * 0.3,
        torch.randn((6,), generator=gen) * 0.1))
    x.requires_grad_(need_dx)
    inputs = (x, wt, b) if need_dx else (wt, b)
    g = torch.randn((2, 9, 7, 6), generator=gen).to(cuda_device)
    before = (conv.launches, conv.bwd_launches)
    got = torch.autograd.grad(conv.conv3x3(x, wt, b, stride=2), inputs, g)
    torch.cuda.synchronize()
    assert (conv.launches, conv.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(conv.conv2d3x3_plain(x, wt, b, stride=2), inputs, g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


# The enhancer's six training layers at N=10 per field and one odd shape:
# (N, H, W, Cin, Cout, stride).
GROUPED_CASES = [(10, 512, 512, 1, 4, 1), (10, 512, 512, 4, 4, 2),
                 (10, 256, 256, 4, 6, 2), (10, 128, 128, 6, 6, 2),
                 (10, 64, 64, 6, 8, 2), (10, 512, 512, 8, 1, 1),
                 (2, 17, 13, 5, 7, 2)]


def _grouped_inputs(device, nf, n, h, w, cin, cout, stride, relu):
    """F fields' x (field-major), weights, biases, the single-field
    kernel's y and an output gradient g."""
    gen = torch.Generator().manual_seed(nf * 100 + h + cin)
    x = torch.randn((nf * n, h, w, cin), generator=gen).to(device)
    wt = (torch.randn((nf, 3, 3, cin, cout), generator=gen) * 0.3).to(device)
    b = (torch.randn((nf, cout), generator=gen) * 0.1).to(device)
    y = torch.cat([conv.conv2d3x3(x[f * n:(f + 1) * n], wt[f], b[f],
                                  stride=stride, relu=relu) for f in range(nf)])
    g = torch.randn(tuple(y.shape), generator=gen).to(device)
    return x, wt, b, y, g


def _bytes(t):
    return t.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("case", GROUPED_CASES)
def test_grouped_conv_equals_single_launches(cuda_device, case, nf):
    """Field f of one grouped forward equals the single-field kernel on
    field f byte for byte, two calls agree, and it is within float32
    tolerance of the plain grouped version."""
    n, h, w, cin, cout, stride = case
    for relu in (True, False):
        x, wt, b, y, _ = _grouped_inputs(cuda_device, nf, *case, relu)
        before = (conv.grouped_launches, conv.launches)
        got = conv.conv2d3x3_grouped(x, wt, b, stride=stride, relu=relu)
        again = conv.conv2d3x3_grouped(x, wt, b, stride=stride, relu=relu)
        torch.cuda.synchronize()
        assert (conv.grouped_launches, conv.launches) == (before[0] + 2,
                                                          before[1])
        assert _bytes(got) == _bytes(y) == _bytes(again)
        want = conv.conv2d3x3_grouped_plain(x, wt, b, stride=stride, relu=relu)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("case", GROUPED_CASES)
def test_grouped_conv_bwd_equals_single_launches(cuda_device, case, nf,
                                                 need_dx):
    """Field f's dx, dw and db of one grouped backward equal a single-field
    call on field f byte for byte; two calls agree; each field's ticket is
    back at 0; the plain grouped versions agree within the tolerances of
    the single-field test."""
    n, h, w, cin, cout, stride = case
    x, wt, b, y, g = _grouped_inputs(cuda_device, nf, *case, True)
    singles = [conv.conv2d3x3_bwd(g[f * n:(f + 1) * n], y[f * n:(f + 1) * n],
                                  x[f * n:(f + 1) * n], wt[f], stride=stride,
                                  need_dx=need_dx) for f in range(nf)]
    before = conv.grouped_bwd_launches
    dx, dw, db = conv.conv2d3x3_bwd_grouped(g, y, x, wt, stride=stride,
                                            need_dx=need_dx)
    again = conv.conv2d3x3_bwd_grouped(g, y, x, wt, stride=stride,
                                       need_dx=need_dx)
    torch.cuda.synchronize()
    assert conv.grouped_bwd_launches == before + 2
    assert (dx is None) == (not need_dx)
    for f, (sdx, sdw, sdb) in enumerate(singles):
        if need_dx:
            assert _bytes(dx[f * n:(f + 1) * n]) == _bytes(sdx)
        assert _bytes(dw[f]) == _bytes(sdw) and _bytes(db[f]) == _bytes(sdb)
    for a, e in zip((dx, dw, db), again):
        assert (a is None and e is None) or _bytes(a) == _bytes(e)
    tickets = conv.group_tickets(cuda_device, nf)
    assert int(tickets.abs().sum()) == 0
    if need_dx:
        want_dx = conv.conv2d3x3_grouped_dgrad_plain(g, y, wt, x.shape,
                                                     stride=stride)
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    want_dw, want_db = conv.conv2d3x3_grouped_wgrad_plain(g, y, x, nf,
                                                          stride=stride)
    terms_dw, terms_db = conv.conv2d3x3_grouped_wgrad_plain(
        conv.relu_mask(g, y, True).abs(), y, x.abs(), nf, stride=stride,
        relu=False)
    assert ((dw - want_dw).abs() <= 1e-5 * terms_dw + 1e-6).all()
    assert ((db - want_db).abs() <= 1e-5 * terms_db + 1e-6).all()


@pytest.mark.cuda
def test_grouped_conv_autograd_on_gpu(cuda_device):
    """Through the grouped autograd function: one grouped launch each way,
    gradients equal to the single-field function's byte for byte."""
    gen = torch.Generator().manual_seed(5)
    nf, n = 3, 2
    x = torch.randn((nf * n, 17, 13, 4), generator=gen).to(cuda_device)
    wt = (torch.randn((nf, 3, 3, 4, 6), generator=gen) * 0.3).to(cuda_device)
    b = (torch.randn((nf, 6), generator=gen) * 0.1).to(cuda_device)
    g = torch.randn((nf * n, 9, 7, 6), generator=gen).to(cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
    before = (conv.grouped_launches, conv.grouped_bwd_launches)
    got = torch.autograd.grad(conv.conv3x3_grouped(*leaves, stride=2), leaves, g)
    torch.cuda.synchronize()
    assert (conv.grouped_launches, conv.grouped_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for f in range(nf):
        one = [t[f * n:(f + 1) * n].clone().requires_grad_() if i == 0
               else t[f].clone().requires_grad_()
               for i, t in enumerate((x, wt, b))]
        want = torch.autograd.grad(conv.conv3x3(*one, stride=2), one,
                                   g[f * n:(f + 1) * n])
        assert _bytes(got[0][f * n:(f + 1) * n]) == _bytes(want[0])
        assert _bytes(got[1][f]) == _bytes(want[1])
        assert _bytes(got[2][f]) == _bytes(want[2])


@pytest.mark.cuda
def test_batched_session_on_gpu(cuda_device):
    """``engine="batched"`` on the card: ``vmap`` trains through the grouped
    kernels and holds the strict bound; ``auto`` gives the serial engine's
    entries where the parity check holds; both decode as the serial decode
    does, byte for byte."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import archive as arc_io
    from repro_torch.core import batched_engine
    from repro_torch.data import fields as fields_lib

    fields = fields_lib.make_fields("hurricane", (6, 40, 36), seed=2)
    serial = repro_torch.NeurLZ(epochs=2, device=cuda_device).compress(
        fields, rel_eb=1e-3)
    kernels.reset_launch_counts()
    sess = repro_torch.NeurLZ(epochs=2, device=cuda_device, engine="batched",
                              field_batching="vmap", group_size=0)
    arc = sess.compress(fields, rel_eb=1e-3)
    counts = kernels.launch_counts()
    assert counts["conv2d3x3_grouped"] > 0 and counts["conv2d3x3_grouped_bwd"] > 0
    assert arc["timing"]["strategies"] == {"cloud,precip,w": "vmap"}
    dec = sess.decompress(arc)
    for name, x in fields.items():
        assert np.abs(dec[name].astype(np.float64) - x).max() <= \
            arc["fields"][name]["abs_eb"]
    serial_dec = serial.decode_all()
    batched_dec = serial.decode_all(engine="batched")
    assert all(_bytes_np(batched_dec[n]) == _bytes_np(serial_dec[n])
               for n in fields)
    auto = repro_torch.NeurLZ(epochs=2, device=cuda_device, engine="batched",
                              group_size=0).compress(fields, rel_eb=1e-3)
    net = serial["fields"]["w"]["net"]
    from repro_torch.core.skipping_dnn import SkippingDNNConfig
    parity = batched_engine.stacked_bit_parity(
        SkippingDNNConfig(c_in=net["c_in"]), (40, 36), 6, 3, cuda_device)
    assert auto["timing"]["strategies"]["cloud,precip,w"] == (
        "vmap" if parity else "unroll")
    assert arc_io.dumps(auto["fields"]) == arc_io.dumps(serial["fields"])


@pytest.mark.cuda
def test_streaming_session_on_gpu(cuda_device, tmp_path):
    """The streaming engine on the card: its entries equal the serial
    engine's byte for byte, its ledger stays under the budget, decode by
    ``iter_decompress`` and a ROI equal the serial decode; the direct
    learning ablation holds its strict bound and decodes as encoded."""
    import io
    import repro_torch
    from repro_torch import kernels, streaming
    from repro_torch.core import archive as arc_io
    from repro_torch.data import fields as fields_lib

    fields = fields_lib.make_fields("hurricane", (6, 40, 36), seed=2)
    serial = repro_torch.NeurLZ(epochs=2, device=cuda_device).compress(
        fields, rel_eb=1e-3)
    budget = 3 * 6 * 40 * 36 * 4 * 4        # 1.5 of a field's working set
    kernels.reset_launch_counts()
    arc = repro_torch.NeurLZ(epochs=2, device=cuda_device, group_size=1,
                             max_resident_bytes=budget).compress_to(
        fields, tmp_path / "snap.nlzs", rel_eb=1e-3)
    counts = kernels.launch_counts()
    assert counts["conv2d3x3"] > 0 and counts["conv2d3x3_bwd"] > 0
    assert counts["fused_enhance"] == 3
    assert arc.report["peak_resident_bytes"] <= budget
    assert arc_io.dumps(arc.to_dict()["fields"]) == arc_io.dumps(serial["fields"])
    want = serial.decode_all()
    got = dict(streaming.iter_decompress(arc))
    assert all(_bytes_np(got[n]) == _bytes_np(want[n]) for n in fields)
    roi = (slice(1, 4), slice(None), slice(5, 30))
    assert _bytes_np(arc.decode("w", roi=roi)) == _bytes_np(want["w"][roi])
    direct = repro_torch.NeurLZ(epochs=2, device=cuda_device,
                                learn_residual=False).compress(fields, rel_eb=1e-3)
    dec = direct.decode_all()
    for name, x in fields.items():
        e = direct["fields"][name]
        assert np.abs(dec[name].astype(np.float64) - x).max() <= e["abs_eb"]
    buf = io.BytesIO()
    repro_torch.NeurLZ(epochs=2, device=cuda_device, learn_residual=False,
                       group_size=1).compress_to(fields, buf, rel_eb=1e-3)
    again = repro_torch.open(buf, device=cuda_device)
    assert arc_io.dumps(again.to_dict()["fields"]) == arc_io.dumps(direct["fields"])


def _bytes_np(a):
    return np.ascontiguousarray(a).tobytes()


def _canaries():
    """Bound-edge outliers plus the double-rounding canary: float64 add of
    (1, 2**-24 + 2**-48) rounds to 1 + 2**-23 after the float32 cast, a
    float32 add (or a fused multiply-add) gives another value."""
    rng = np.random.default_rng(7)
    dec = rng.standard_normal((3, 5, 7)).astype(np.float32)
    z = np.clip(rng.standard_normal((3, 5, 7)), -1, 1).astype(np.float32)
    orig = (dec + z * 1e-2 * rng.choice([0.5, 1.5], (3, 5, 7))).astype(np.float32)
    dec[0, 0, 0], z[0, 0, 0], orig[0, 0, 0] = 1.0, 2.0 ** -24, 1.0
    return z, dec, orig, 1.0 + 2.0 ** -24


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_enhance_kernel_byte_identical(cuda_device, dtype, strict):
    z, dec, orig, eb = _canaries()
    args = [torch.from_numpy(z).to(cuda_device)] + [
        torch.from_numpy(a).to(cuda_device, dtype) for a in (dec, orig)]
    before = fe.launches
    got = fe.fused_enhance(*args, eb, strict=strict)
    want = fe.fused_enhance_plain(*args, eb, strict=strict)
    torch.cuda.synchronize()
    assert fe.launches == before + 1
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
    if dtype == torch.float32:
        assert got[0][0, 0, 0].item() == 1.0 + 2.0 ** -23


# Stacked Lorenzo groups: odd sizes, several tiles with ragged edges, 2-D
# fields as [F, H, W], F=1 and F=3, and rows wider than one scan block.
LORENZO_SHAPES = [(1, 5, 7, 3), (3, 11, 13), (3, 9, 37, 45), (1, 3, 33, 65),
                  (2, 4, 9, 1100)]


def _lorenzo_group(shape, seed):
    """A smooth group with the reference's probe values: a NaN, an
    infinity, a CODE_CAP overflow, 2**25 + 0.5 (which a float32 cast moves
    past the bound) and points on the lattice's half steps."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1)
    eb = np.array([1e-3, 2e-2, 0.3][:shape[0]] + [5e-3] * (shape[0] - 3))
    flat = x.reshape(shape[0], -1)
    n = flat.shape[1]
    flat[0, 0] = np.nan
    flat[0, n // 2] = 3.0e9
    flat[-1, n // 3] = np.inf
    flat[-1, n - 1] = float(np.float32(2 ** 25)) + 0.5
    flat[-1, n // 4] = 2.0 * eb[-1] * 2.5
    return x, eb


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", LORENZO_SHAPES)
def test_lorenzo_kernels_byte_identical(cuda_device, shape, out_dtype):
    x, eb = _lorenzo_group(shape, len(shape) + shape[-1])
    xt = torch.from_numpy(x).to(cuda_device)
    before = (lorenzo3d.fwd_launches, lorenzo3d.inv_launches)
    got = lorenzo3d.lorenzo3d_fwd(xt, eb, out_dtype)
    want = lorenzo3d.lorenzo_encode_plain(xt, torch.from_numpy(eb).to(cuda_device),
                                          out_dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
    assert got[1].any()
    dec = lorenzo3d.lorenzo3d_inv(got[0], eb)
    plain = lorenzo3d.lorenzo_decode_plain(got[0],
                                           torch.from_numpy(eb).to(cuda_device))
    torch.cuda.synchronize()
    assert (lorenzo3d.fwd_launches, lorenzo3d.inv_launches) == (
        before[0] + 1, before[1] + 1)
    assert dec.cpu().numpy().tobytes() == plain.cpu().numpy().tobytes()
    keep = ~got[1]
    assert torch.equal(dec[keep], got[2][keep])


@pytest.mark.cuda
def test_lorenzo_inv_wide_rows(cuda_device):
    """Rows wider than 48 KB of shared column sums (the opt-in path)."""
    rng = np.random.default_rng(11)
    d = torch.from_numpy(rng.integers(-9, 9, (1, 2, 3, 13000), dtype=np.int32))
    d = d.to(cuda_device)
    got = lorenzo3d.lorenzo3d_inv(d, [1e-2])
    want = lorenzo3d.lorenzo_decode_plain(d, torch.tensor([1e-2], dtype=torch.float64,
                                                          device=cuda_device))
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


# Band edges of the inverse (bands of 8 rows): H one below and one above a
# band, 2-D fields ([F, H, W], D = 1), F = 1, and int32 sums that wrap.
INV_EDGE_SHAPES = [(2, 3, 7, 40), (2, 3, 9, 40), (1, 5, 17, 33), (3, 15, 600),
                   (1, 1, 9, 513)]


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("shape", INV_EDGE_SHAPES)
def test_lorenzo_inv_band_edges(cuda_device, shape, wrap):
    rng = np.random.default_rng(sum(shape) + wrap)
    hi = 2 ** 30 if wrap else 9
    d = torch.from_numpy(rng.integers(-hi, hi, shape, dtype=np.int32)).to(cuda_device)
    eb = torch.from_numpy(rng.uniform(1e-3, 0.5, shape[0])).to(cuda_device)
    q = lorenzo3d.lorenzo_undelta_plain(d.cpu().long(), axes=range(1, d.ndim))
    assert (q.abs() >= 2 ** 31).any() == wrap    # the int32 sums wrap
    before = lorenzo3d.inv_launches
    got = lorenzo3d.lorenzo3d_inv(d, eb)
    want = lorenzo3d.lorenzo_decode_plain(d, eb)
    torch.cuda.synchronize()
    assert lorenzo3d.inv_launches == before + 1
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_lorenzo_inv_allocates_no_full_size_scratch(cuda_device):
    """Beyond its output, the inverse allocates only the carry rows of its
    bands (1/8 of delta), not a full-size int32 copy of delta."""
    d = torch.ones((3, 50, 200, 200), dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lorenzo3d.lorenzo3d_inv(d, [1e-3] * 3)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - 8 * d.numel()
    assert scratch <= 4 * d.numel() // 4


@pytest.mark.cuda
def test_lorenzo_session_round_trip(cuda_device):
    """``szlike-lorenzo`` end to end on the card: one fused group, both
    kernels launched, the strict bound held, and decode equal to the
    encoder's final field bit for bit."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.compressors import szlike
    from repro_torch.core import neurlz, online_trainer
    from repro_torch.data import fields as fields_lib

    fields = fields_lib.make_fields("hurricane", (6, 40, 36), seed=2)
    kernels.reset_launch_counts()
    sess = repro_torch.NeurLZ(compressor="szlike-lorenzo", epochs=2,
                              device=cuda_device)
    arc = sess.compress(fields, rel_eb=1e-3)
    dec = arc.decode_all()
    counts = kernels.launch_counts()
    assert counts["lorenzo3d_fwd"] == 1 and counts["lorenzo3d_inv"] == 1
    assert counts["conv2d3x3"] > 0 and counts["conv2d3x3_bwd"] > 0
    assert counts["fused_enhance"] == 6
    assert arc["timing"]["conv_stage"]["batched_fields"] == 3
    for name, x in fields.items():
        e = arc["fields"][name]
        assert np.abs(dec[name].astype(np.float64) - x).max() <= e["abs_eb"]
        rec = szlike.decompress(e["conv"], device=cuda_device)
        model = neurlz.decode_entry_net(e, cuda_device)
        inputs, _, _ = online_trainer.make_dataset(rec, x, e["abs_eb"])
        resid = online_trainer.predict_residual(model, inputs)
        final, _ = neurlz.enhance_and_mask(x, rec, resid, e["abs_eb"], sess.config)
        assert final.cpu().numpy().tobytes() == dec[name].tobytes()


@pytest.mark.cuda
def test_out_of_memory_degrades_and_releases_the_field(cuda_device, monkeypatch):
    """A CUDA out-of-memory in one field's training degrades that field to
    conv-only (``error:OutOfMemoryError``); its device tensors are released
    before the next field trains, which then trains as usual."""
    import repro_torch
    from repro_torch.core import online_trainer
    from repro_torch.data import fields as fields_lib

    fields = fields_lib.make_fields("hurricane", (6, 40, 36), seed=2)
    real_train = online_trainer.train
    held = []    # memory_allocated() as each field's training starts

    def train(model, inputs, targets, cfg, **kw):
        held.append(torch.cuda.memory_allocated(cuda_device))
        if len(held) == 1:
            # What a failed field pins: its inputs and targets on the card.
            xs = torch.as_tensor(inputs, device=cuda_device)
            ys = torch.as_tensor(targets, device=cuda_device)
            big = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
            assert xs.numel() + ys.numel() + big.numel() > 0
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real_train(model, inputs, targets, cfg, **kw)

    monkeypatch.setattr(online_trainer, "train", train)
    arc = repro_torch.NeurLZ(epochs=2, device=cuda_device).compress(
        fields, rel_eb=1e-3)
    first = list(fields)[0]
    assert arc["fields"][first]["degraded"] == "error:OutOfMemoryError"
    assert arc["timing"]["degraded_fields"] == [first]
    # The next field starts from the level the failed one started from.
    assert len(held) == len(fields) and held[1] == held[0]
    dec = arc.decode_all()
    for name, x in fields.items():
        e = arc["fields"][name]
        assert ("degraded" in e) == (name == first)
        assert np.abs(dec[name].astype(np.float64) - x).max() <= e["abs_eb"]


@pytest.mark.cuda
def test_telemetry_changes_no_entry_and_no_launch(cuda_device):
    """Telemetry on (with the sample-PSNR hook) or off: equal entries; the
    kernel launches differ only by the hook's own inference and enhance."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import archive as arc_io
    from repro_torch.data import fields as fields_lib

    fields = fields_lib.make_fields("hurricane", (6, 40, 36), seed=2)
    runs = {}
    for kind, tel in (("off", None), ("on", repro_torch.Telemetry()),
                      ("sample_psnr", repro_torch.Telemetry(
                          repro_torch.TelemetryConfig(sample_psnr=True)))):
        kernels.reset_launch_counts()
        arc = repro_torch.NeurLZ(epochs=2, device=cuda_device,
                                 telemetry=tel).compress(fields, rel_eb=1e-3)
        runs[kind] = (arc_io.dumps(arc["fields"]), kernels.launch_counts(), tel)
    assert runs["on"][0] == runs["off"][0] == runs["sample_psnr"][0]
    assert runs["on"][1] == runs["off"][1]
    # The hook: per epoch and field, one inference forward (six conv
    # launches) and one fused_enhance.
    hook = 2 * len(fields)
    off, sampled = runs["off"][1], runs["sample_psnr"][1]
    assert sampled["fused_enhance"] == off["fused_enhance"] + hook
    assert sampled["conv2d3x3"] == off["conv2d3x3"] + 6 * hook
    assert sampled["conv2d3x3_bwd"] == off["conv2d3x3_bwd"]
    tel = runs["sample_psnr"][2]
    assert all(len(tel.trace(n)) == 2 and "sample_psnr" in tel.trace(n)[0]
               for n in fields)


@pytest.mark.cuda
def test_serve_on_gpu(cuda_device, tmp_path):
    """The server decodes on the card from its dispatcher thread, equal to
    ``Archive.decode`` on the card bit for bit, with the kernels counted
    from that thread; a transcode whose source decodes on the card equals
    the serial compress of the decoded fields."""
    import threading

    import repro_torch
    from repro_torch import kernels, serve, streaming
    from repro_torch.core import archive as arc_io
    from repro_torch.core import neurlz
    from repro_torch.data import fields as fields_lib

    fields = fields_lib.make_fields("hurricane", (6, 40, 36), seed=3)
    cfg = neurlz.NeurLZConfig(epochs=2, engine="streaming",
                              cross_field={"w": ("precip",)})
    path = str(tmp_path / "snap.nlzs")
    streaming.compress(fields, path, 1e-3, config=cfg, device=cuda_device)
    with repro_torch.Archive.open(path, device=cuda_device) as arc:
        want = {n: arc.decode(n) for n in fields}
    threads = set()
    real = neurlz.decode_field_entry

    def spy(*a, **k):
        threads.add(threading.current_thread())
        return real(*a, **k)
    neurlz.decode_field_entry = spy
    try:
        kernels.reset_launch_counts()
        srv = serve.ArchiveServer(path, max_bytes=1 << 30, auto_start=False,
                                  device=cuda_device)
        futs = {n: srv.submit(n) for n in fields}
        srv.start()
        got = {n: f.result(300) for n, f in futs.items()}
        srv.close()
    finally:
        neurlz.decode_field_entry = real
    counts = kernels.launch_counts()
    assert threads == {srv._thread}
    assert srv.decode_stats.batched == 1
    assert counts["conv2d3x3"] > 0 and counts["fused_enhance"] == len(fields)
    for n in fields:
        assert got[n].tobytes() == want[n].tobytes(), n
    # A handle on the CPU is reopened on the server's card.
    with serve.ArchiveServer(repro_torch.Archive.open(path, device="cpu"),
                             max_bytes=1 << 30, device=cuda_device) as srv:
        assert srv._archives["default"].device.type == "cuda"
        assert srv.decode("w").tobytes() == want["w"].tobytes()
    out = serve.transcode(path, str(tmp_path / "re.nlzs"), rel_eb=1e-2,
                          config=cfg, device=cuda_device)
    serial = repro_torch.NeurLZ(epochs=2, cross_field={"w": ("precip",)},
                                device=cuda_device).compress(want, rel_eb=1e-2)
    for n in fields:
        assert arc_io.dumps(out.entry(n)) == arc_io.dumps(serial["fields"][n]), n
    out.close()


LM_ARCHS = ["qwen3-4b", "gemma-2b", "gemma3-4b", "granite-moe-3b-a800m",
            "deepseek-moe-16b", "llava-next-34b", "hubert-xlarge", "zamba2-7b",
            "xlstm-350m"]


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.detach().to(dev)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_gpu_matches_cpu(cuda_device, arch):
    """The reduced model on the card against the same weights on the CPU:
    forward hidden states and every decode position's logits, TF32 off
    (float32 sums in other orders: |Δ| <= 1e-4 · max|CPU| + 1e-5)."""
    from repro_torch import configs
    from repro_torch.models import model as M

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced(arch)
    cpu = M.build_model(cfg, model_axis=1)
    params = M.init_params(cpu, seed=0, device="cpu")
    gpu = M.build_model(cfg, model_axis=1)
    gpu.load_params(_to(params, cuda_device))

    def close(got, want):
        got, want = got.float().cpu(), want.float()
        assert got.shape == want.shape
        lim = 1e-4 * float(want.abs().max()) + 1e-5
        assert float((got - want).abs().max()) <= lim

    batch = M.demo_batch(cfg, 2, 20, seed=1, device="cpu")
    with torch.inference_mode():
        close(gpu.forward(gpu.params, _to(batch, cuda_device)),
              cpu.forward(cpu.params, batch))
        if cfg.family == "audio":
            return
        c_cpu, c_gpu = cpu.init_cache(2, 24), gpu.init_cache(2, 24)
        toks = batch["tokens"]
        for pos in range(toks.shape[1]):
            want, c_cpu = cpu.decode_step(cpu.params, c_cpu, toks[:, pos:pos + 1], pos)
            got, c_gpu = gpu.decode_step(gpu.params, c_gpu,
                                         toks[:, pos:pos + 1].to(cuda_device), pos)
            close(got, want)


# Rows of the inverse wider than a band's shared memory (56,320 int32
# values) take the striped route: a row at the band route's limit and one
# past it, the shapes a lossy checkpoint reaches (qwen3-8b's untied head
# [4096, 151,936]; a flattened float32 expert stack) and a 3-D group.
WIDE_INV_SHAPES = [(1, 2, 56320), (1, 2, 56321), (1, 4096, 151936),
                   (1, 32, 1048576), (2, 3, 5, 100000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WIDE_INV_SHAPES)
def test_lorenzo_inv_rows_of_any_width(cuda_device, shape):
    rng = np.random.default_rng(shape[-1])
    d = torch.from_numpy(rng.integers(-2 ** 30, 2 ** 30, shape, dtype=np.int32))
    d = d.to(cuda_device)
    eb = torch.from_numpy(rng.uniform(1e-3, 0.5, shape[0])).to(cuda_device)
    before = lorenzo3d.inv_launches
    got = lorenzo3d.lorenzo3d_inv(d, eb)
    want = lorenzo3d.lorenzo_decode_plain(d, eb)
    torch.cuda.synchronize()
    assert lorenzo3d.inv_launches == before + 1
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
def test_lorenzo_inv_striped_scratch_is_small(cuda_device):
    """The striped route's scratch: the bands' carry rows (1/8 of delta)
    and the stripes' left prefixes (1/2048 of it)."""
    d = torch.ones((1, 64, 200000), dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lorenzo3d.lorenzo3d_inv(d, [1e-3])
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - 8 * d.numel()
    assert scratch <= 4 * d.numel() // 4


def _train_pair(cuda_device, arch="qwen3-4b", dtype=None):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get_reduced(arch)
    cpu = M.build_model(cfg, model_axis=1)
    params = M.init_params(cpu, seed=0, device="cpu")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        cpu = M.build_model(cfg, model_axis=1)
        params = cpu.load_params(_to_dtype(params, cfg.params_dtype))
    gpu = M.build_model(cfg, model_axis=1)
    gpu.load_params(_to(params, cuda_device))
    return cfg, cpu, gpu


def _to_dtype(tree, dtype):
    return {k: _to_dtype(v, dtype) if isinstance(v, dict)
            else v.detach().to(dtype, copy=True) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", None),
                                        ("granite-moe-3b-a800m", None),
                                        ("zamba2-7b", "float64"),
                                        ("xlstm-350m", "float64")])
def test_train_step_on_gpu_matches_cpu(cuda_device, arch, dtype):
    """One ``make_train_step`` from the same parameters and batch on the
    card and the CPU (TF32 off): loss within 1e-5 relative, gradients and
    the global norm within 1e-4 of their largest, moments within 1e-4 of
    each leaf's largest, and the parameters within a hundredth of a step
    wherever the gradient stands above its rounding noise (1e-5 of its
    leaf's largest; below it m̂ / (√v̂ + ε) ≈ sign(g) may flip).  The
    attention archs in their float32; the recurrent ones with their float32
    weights in float64, where their gradients' rounding stays below that
    noise floor (in float32 it is 3-5e-5 of a leaf's largest, measured on
    the card and against the JAX package alike)."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves

    cfg, cpu, gpu = _train_pair(cuda_device, arch, dtype)
    batch = M.demo_batch(cfg, 2, 32, seed=1, device="cpu")
    lr = 1e-3
    out = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        params = m.params
        b = _to(batch, dev)
        grads = torch.autograd.grad(m.loss(params, b), tree_leaves(params))
        opt = adamw_init(params)
        params, opt, met = M.make_train_step(m, lr=lr)(params, opt, b, 0)
        out.append((float(met["loss"]), float(met["grad_norm"]), grads, params, opt))
    (lc, nc, gc, pc, oc), (lg, ng, gg, pg, og) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert abs(ng - nc) <= 1e-4 * nc
    for a, b in zip(list(gg) + tree_leaves(og.mu) + tree_leaves(og.nu),
                    list(gc) + tree_leaves(oc.mu) + tree_leaves(oc.nu)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-20
    for a, b, g in zip(tree_leaves(pg), tree_leaves(pc), gc):
        assert a.dtype == b.dtype
        keep = g.abs() >= 1e-5 * float(g.abs().max())
        d = (a.detach().cpu() - b.detach()).abs()[keep]
        assert float(d.max()) <= 1e-2 * lr


@pytest.mark.cuda
def test_restart_drill_on_gpu_bit_for_bit(cuda_device, tmp_path):
    """``launch.train.train`` on the card, failing at step 3 under
    ``run_with_restarts`` and resumed from the step-2 checkpoint: the
    final checkpoint equals an uninterrupted run's byte for byte."""
    import types

    from repro_torch.checkpoint import run_with_restarts
    from repro_torch.launch import train as train_lib

    def args(d, fail=None):
        return types.SimpleNamespace(
            arch="qwen3-4b", preset="reduced", steps=6, batch=2, seq=32,
            lr=3e-3, seed=0, microbatch=1, ckpt_dir=str(tmp_path / d),
            ckpt_every=2, keep=3, resume=True, lossy_ckpt_eb=None,
            fail_at_step=fail, step_deadline=120.0, log_every=0,
            device=str(cuda_device))
    attempts = []

    def make():
        attempts.append(1)
        return train_lib.train(args("a", 3 if len(attempts) == 1 else None))
    rep = run_with_restarts(make)
    whole = train_lib.train(args("b"))
    assert len(attempts) == 2 and rep["resumed_from"] == 2
    assert rep["last_loss"] == whole["last_loss"] < whole["first_loss"]
    for name in ("params.bin", "opt.bin"):
        a = (tmp_path / "a" / "step_6" / name).read_bytes()
        assert a == (tmp_path / "b" / "step_6" / name).read_bytes(), name


# ---- the distributed layer over NCCL (one rank: NCCL takes one rank a
# device; the multi-rank checks run over gloo in test_torch_distributed.py)

@pytest.fixture
def nccl_host_mesh(cuda_device):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_world(cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        yield mesh_lib.make_host_mesh(cuda_device)
    finally:
        dist.destroy_process_group()


def _same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


@pytest.mark.cuda
def test_compressed_and_bf16_psum_over_nccl(nccl_host_mesh, cuda_device):
    """One rank: the mean is ``dequantize(quantize_ef(g))`` bit for bit,
    the carry ``g + ef - mean``, the sum in int32 on the wire;
    ``bf16_psum`` is ``bf16(g).float()``."""
    from repro_torch.optim import grad_compress as gc

    gen = torch.Generator().manual_seed(5)
    g = {"a": torch.randn((64, 48), generator=gen).to(cuda_device),
         "b": {"c": (torch.randn((7,), generator=gen) * 1e-3).to(cuda_device)}}
    ef = {"a": (torch.randn((64, 48), generator=gen) * 1e-3).to(cuda_device),
          "b": {"c": torch.zeros(7, device=cuda_device)}}
    stats = {}
    mean, new_ef = gc.compressed_psum(g, ef, stats=stats)
    q, s, want_ef = gc.quantize_ef(g, ef)
    want = gc.dequantize(q, s)
    for got, exp in ((mean["a"], want["a"]), (mean["b"]["c"], want["b"]["c"]),
                     (new_ef["a"], want_ef["a"]), (new_ef["b"]["c"], want_ef["b"]["c"])):
        assert _same_bits(got, exp)
    assert stats["wire_bytes"] == 4 * (64 * 48 + 7) + 4 * 2
    out = gc.bf16_psum(g)
    assert _same_bits(out["a"], g["a"].to(torch.bfloat16).float())


@pytest.mark.cuda
def test_reshard_rescale_and_constrain_over_nccl(nccl_host_mesh, cuda_device, tmp_path):
    """The reduced qwen3-4b's state on the 1x1 NCCL mesh, saved and
    ``rescale``'d bit for bit; ``constrain`` of a DTensor there."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_items

    model = M.build_model(configs.get_reduced("qwen3-4b"), model_axis=1)
    params, opt = M.init_train_state(model, seed=0, device=cuda_device)
    placed = elastic.reshard_to_mesh(params, nccl_host_mesh)
    for (_, d), (_, p) in zip(tree_items(placed), tree_items(params)):
        assert _same_bits(d.to_local(), p.detach())
    mgr = CheckpointManager(str(tmp_path), device=cuda_device)
    mgr.save(1, placed, opt)
    new_p, new_o, _ = elastic.rescale(mgr, 1, params, opt, nccl_host_mesh)
    for (_, d), (_, p) in zip(tree_items(new_p), tree_items(params)):
        assert _same_bits(d.to_local(), p.detach())
    assert new_o.step == opt.step
    x = distribute_tensor(torch.ones((4, 6, 4, 3), device=cuda_device), nccl_host_mesh,
                          [Replicate(), Replicate()])
    sh.set_active_mesh(nccl_host_mesh)
    try:
        y = sh.constrain(x, ("batch", None, "model", None))
    finally:
        sh.set_active_mesh(None)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert _same_bits(y.to_local(), x.to_local())
