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
