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

# (N, H, W, Cin, Cout, stride): odd sizes, stride 2 on odd and even sizes
# (XLA's SAME pads lo=0, hi=1 there), Cout=1, and the enhancer's conv_in and
# down1 on a 512×512 training batch.
CONV_CASES = [(2, 17, 13, 1, 4, 1), (2, 17, 13, 4, 6, 2), (2, 16, 12, 6, 8, 2),
              (2, 17, 13, 8, 1, 1), (2, 9, 7, 16, 3, 2), (10, 512, 512, 1, 4, 1),
              (10, 512, 512, 4, 4, 2)]


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


@pytest.mark.cuda
def test_conv_autograd_on_gpu(cuda_device):
    gen = torch.Generator().manual_seed(3)
    x, wt, b = (t.to(cuda_device).requires_grad_() for t in (
        torch.randn((2, 17, 13, 4), generator=gen),
        torch.randn((3, 3, 4, 6), generator=gen) * 0.3,
        torch.randn((6,), generator=gen) * 0.1))
    g = torch.randn((2, 9, 7, 6), generator=gen).to(cuda_device)
    got = torch.autograd.grad(conv.conv3x3(x, wt, b, stride=2), (x, wt, b), g)
    want = torch.autograd.grad(conv.conv2d3x3_plain(x, wt, b, stride=2),
                               (x, wt, b), g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


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
