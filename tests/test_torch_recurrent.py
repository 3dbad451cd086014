"""The port's recurrent cells against the JAX package's, on the CPU: the
Mamba2 SSD scan (``models/ssm.py``) and the xLSTM mLSTM and sLSTM
(``models/xlstm.py``) at the reduced zamba2-7b and xlstm-350m presets,
with the reference's initial parameters carried across and inputs from a
numpy seed.

At the reduced presets a sequence of at most 128 is a single chunk, so the
scans here run with ``chunk=16`` at L = 64: four chunks, so the state
carried from one chunk to the next is held against the reference.  The
reference runs with 64-bit types off (its compressors turn them on at
import, and its mLSTM then divides by a numpy float64 scalar): outputs are
held in dtype as well as in value.

Tolerances (float32): outputs within 1e-4 · max |reference| + 1e-5 (the
model tests' bound), gradients of ``Σ out · r`` (``r`` a fixed random
cotangent) within 1e-5 · max |reference leaf| + 1e-7.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import ssm, xlstm

REL, ABS = 1e-4, 1e-5
GRAD_REL, GRAD_ABS = 1e-5, 1e-7
BATCH, L, CHUNK = 2, 64, 16


def cfgs(arch):
    return jconfigs.get_reduced(arch), configs.get_reduced(arch)


def rng_normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, rel=REL, abs_=ABS):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    lim = rel * float(np.max(np.abs(want))) + abs_
    assert err <= lim, f"max |Δ| {err} > {lim}"


# (reference function, port function, reference init, port module's
# keyword arguments) of each cell
CELLS = {
    "ssm": ("zamba2-7b", jssm.forward, ssm.forward, jssm.init, {"chunk": CHUNK}),
    "mlstm": ("xlstm-350m", jxlstm.m_forward, xlstm.m_forward, jxlstm.m_init,
              {"chunk": CHUNK}),
    "slstm": ("xlstm-350m", jxlstm.s_forward, xlstm.s_forward, jxlstm.s_init, {}),
}


@functools.lru_cache(maxsize=None)
def cell_case(name):
    """The reference's parameters (numpy), an input, a cotangent, and the
    reference's output and gradients of ``Σ out · r`` (params and input)."""
    arch, jfwd, _, jinit, kw = CELLS[name]
    jcfg, _ = cfgs(arch)
    x = rng_normal(1, (BATCH, L, jcfg.d_model))
    r = rng_normal(2, (BATCH, L, jcfg.d_model))
    with jax.enable_x64(False):
        p = jax.tree.map(np.asarray, jax.jit(
            lambda k: jinit(k, jcfg, jnp.float32))(jax.random.PRNGKey(3)))

        def out_and_grads(p, x):       # one compile for both
            out, vjp = jax.vjp(lambda p, x: jfwd(p, jcfg, x, **kw), p, x)
            return out, vjp(jnp.asarray(r))

        out, (gp, gx) = jax.jit(out_and_grads)(p, x)
    return p, x, r, np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_forward_and_gradients_across_chunks_match_reference(name):
    arch, _, fwd, _, kw = CELLS[name]
    _, cfg = cfgs(arch)
    p, x, r, want, want_gp, want_gx = cell_case(name)
    tp = {k: v.requires_grad_() for k, v in M.params_from_jax(p, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = fwd(tp, cfg, tx, **kw)
    close(out, want)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)),
                                [tx] + [tp[k] for k in sorted(tp)])
    for got, (k, w) in zip(grads, [("x", want_gx)] + sorted(want_gp.items())):
        close(got, w, GRAD_REL, GRAD_ABS)


def test_chunked_scans_equal_one_chunk():
    """The carry across chunks: ``chunk=16`` at L = 64 against one chunk of
    64, in the port alone (float32 sums in other orders)."""
    for name in ("ssm", "mlstm"):
        arch, _, fwd, _, _ = CELLS[name]
        _, cfg = cfgs(arch)
        p, x, _, _, _, _ = cell_case(name)
        tp, tx = M.params_from_jax(p, "cpu"), torch.from_numpy(x)
        whole = fwd(tp, cfg, tx, chunk=L)
        close(fwd(tp, cfg, tx, chunk=CHUNK), whole.detach().numpy())
        with pytest.raises(ValueError, match="does not split"):
            fwd(tp, cfg, tx, chunk=24)


@pytest.mark.parametrize("name", ["ssm", "mlstm", "slstm"])
def test_cell_decode_steps_match_reference(name):
    """Every position's O(1)-state decode step against the reference's,
    from its zeroed cache; the port writes its cache in place."""
    arch = CELLS[name][0]
    jcfg, cfg = cfgs(arch)
    p, x, _, _, _, _ = cell_case(name)
    tp = M.params_from_jax(p, "cpu")
    jstep, step = {"ssm": (jssm.decode_step, ssm.decode_step),
                   "mlstm": (jxlstm.m_decode_step, xlstm.m_decode_step),
                   "slstm": (jxlstm.s_decode_step, xlstm.s_decode_step)}[name]
    if name == "ssm":
        jcache = jssm.init_cache(jcfg, BATCH, jnp.float32)
        cache = ssm.init_cache(cfg, BATCH, torch.float32, "cpu")
    elif name == "mlstm":
        jcache, cache = (jxlstm.m_init_cache(jcfg, BATCH),
                         xlstm.m_init_cache(cfg, BATCH, "cpu"))
    else:
        jcache, cache = (jxlstm.s_init_cache(jcfg, BATCH),
                         xlstm.s_init_cache(cfg, BATCH, "cpu"))
    held = {k: v for k, v in cache.items()}
    with jax.enable_x64(False):
        jit_step = jax.jit(lambda p, x, c: jstep(p, jcfg, x, c))
        for pos in range(16):
            want, jcache = jit_step(p, x[:, pos:pos + 1], jcache)
            with torch.inference_mode():
                got, cache = step(tp, cfg, torch.from_numpy(x[:, pos:pos + 1]), cache)
            close(got, want)
            for k in jcache:
                assert cache[k] is held[k]          # in place
                close(cache[k], jcache[k])


def test_ssd_gradient_finite_where_the_reference_overflows():
    """The reduced zamba2-7b's Mamba2 layer at its default init, batch 2,
    L = 128 (one chunk): the reference's gradient is NaN in ``A_log``,
    ``dt_bias`` and ``w_in`` (its ``exp`` of the gap above the diagonal
    overflows before the mask, and ``0 · inf`` is NaN), the port's, which
    masks first, is finite; the forwards agree."""
    jcfg, cfg = cfgs("zamba2-7b")
    p, _, _, _, _, _ = cell_case("ssm")
    x = rng_normal(0, (BATCH, 128, jcfg.d_model))
    def out_and_grad(p, x):      # the gradient of Σ out², one compile
        out, vjp = jax.vjp(lambda p: jssm.forward(p, jcfg, x), p)
        return out, vjp(2 * out)[0]

    with jax.enable_x64(False):
        want, g = jax.jit(out_and_grad)(p, x)
    assert {k for k, v in g.items() if np.isnan(np.asarray(v)).any()} == {
        "A_log", "dt_bias", "w_in"}
    tp = {k: v.requires_grad_() for k, v in M.params_from_jax(p, "cpu").items()}
    out = ssm.forward(tp, cfg, torch.from_numpy(x))
    close(out, want)
    grads = torch.autograd.grad(torch.sum(out ** 2), list(tp.values()))
    assert all(bool(torch.isfinite(v).all()) for v in grads)


def test_tril_cumsum_equals_cumsum():
    x = torch.from_numpy(rng_normal(4, (2, 3, 16, 5)))
    got = ssm._tril_cumsum(x, 2)
    assert torch.allclose(got, torch.cumsum(x, 2), rtol=1e-6, atol=1e-6)
