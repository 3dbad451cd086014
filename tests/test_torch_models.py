"""The port's LM layers, attention, MoE and model stacks against the JAX
package, on the CPU, with the JAX package's weights carried across by
``params_from_jax`` and inputs made from a numpy seed.

Tolerance (float32): max |port − reference| ≤ 1e-4 · max |reference| +
1e-5, for every compared output (hidden states, logits, attention, MoE
output and aux).  The embedding is held bit for bit.  The reference's
forward and decode step are jitted once per arch (one compile each).  The
recurrent archs (zamba2-7b, xlstm-350m) run the reference with 64-bit
types off, as its dry run does, and are held in dtype as well.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpoint import _flatten
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import attention, layers, mlp, moe
from repro_torch.models import model as M

REL, ABS = 1e-4, 1e-5
ATTENTION_ARCHS = ["qwen3-4b", "gemma-2b", "gemma3-4b", "granite-moe-3b-a800m",
                   "deepseek-moe-16b", "llava-next-34b", "hubert-xlarge"]
DECODE_ARCHS = [a for a in ATTENTION_ARCHS if a != "hubert-xlarge"]
RECURRENT_ARCHS = ["zamba2-7b", "xlstm-350m"]
# gemma3's reduced config has window 16: a 20-token prompt wraps the ring
# buffers of its windowed layers (max_len 24 > window, so they cache 16).
SEQ, MAX_LEN, BATCH = 20, 24, 2


def close(got, want, rel=REL, abs_=ABS):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    lim = rel * float(np.max(np.abs(want))) + abs_
    assert err <= lim, f"max |Δ| {err} > {lim}"


def t(a):
    return torch.from_numpy(np.array(a))


def rng_normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_head_rmsnorm():
    x = rng_normal(0, (2, 5, 64), 3.0)
    scale = rng_normal(1, (64,), 0.1)
    close(layers.rmsnorm(t(x), t(scale), 1e-6), jlayers.rmsnorm(x, scale, 1e-6))
    xh = rng_normal(2, (2, 5, 4, 16))
    sh = rng_normal(3, (16,), 0.1)
    close(layers.head_rmsnorm(t(xh), t(sh), 1e-6),
          jlayers.head_rmsnorm(xh, sh, 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_to_position_600(theta):
    x = rng_normal(4, (2, 601, 3, 16))
    pos = np.broadcast_to(np.arange(601, dtype=np.int32), (2, 601))
    close(layers.apply_rope(t(x), t(pos), theta), jlayers.apply_rope(x, pos, theta))
    np.testing.assert_array_equal(layers.rope_freqs(16, theta),
                                  jlayers.rope_freqs(16, theta))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation(name):
    x = rng_normal(5, (7, 33), 4.0)
    close(layers.activation(name)(t(x)), jlayers.activation(name)(x))


def test_mlp_forward():
    p = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0), 64, 96, jnp.float32))
    x = rng_normal(6, (2, 5, 64))
    for act in ("silu", "gelu"):
        close(mlp.forward(M.params_from_jax(p, "cpu"), t(x), act),
              jax.jit(functools.partial(jmlp.forward, act=act))(p, x))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["causal", "windowed", "full"])
def test_sdpa(kind):
    s = 24
    q = rng_normal(7, (2, s, 4, 16))
    k = rng_normal(8, (2, s, 2, 16))
    v = rng_normal(9, (2, s, 2, 16))
    if kind == "full":
        jm, m = jattention.full_mask(s), attention.full_mask(s)
    else:
        w = 7 if kind == "windowed" else None
        jm, m = jattention.causal_mask(s, w), attention.causal_mask(s, w)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    close(attention._sdpa(t(q), t(k), t(v), m), jattention._sdpa(q, k, v, jm, None))


@pytest.mark.parametrize("skip_uncausal", [False, True])
@pytest.mark.parametrize("window", [None, 700])
def test_sdpa_chunked_at_2048(skip_uncausal, window):
    # s divides by both chunk sizes (512, 1024), as the reference asserts.
    s = 2048
    q = rng_normal(10, (1, s, 2, 8))
    k = rng_normal(11, (1, s, 1, 8))
    v = rng_normal(12, (1, s, 1, 8))
    ref = jax.jit(functools.partial(jattention._sdpa_chunked, cfg=None, causal=True,
                                    window=window, skip_uncausal=skip_uncausal))
    got = attention._sdpa_chunked(t(q), t(k), t(v), causal=True, window=window,
                                  skip_uncausal=skip_uncausal)
    # The reference's masks promote its scan carry to float64 under
    # jax_enable_x64, which its compressors turn on at import, and its scan
    # then refuses the carry: it runs with 64-bit types off, as its dry run
    # does.
    with jax.enable_x64(False):
        want = ref(q, k, v)
    close(got, want)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_embedding_bit_for_bit_at_vocab_8192(arch):
    # At a padded vocabulary of 8192 or more the reference contracts a
    # one-hot matrix with the table; the port gathers.  Same bits.
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), vocab_size=8192)
    cfg = dataclasses.replace(configs.get_reduced(arch), vocab_size=8192)
    jm = JM.build_model(jcfg)
    assert 8192 >= jm.ONE_HOT_EMBED_MIN_VOCAB
    table = rng_normal(13, (8192, cfg.d_model), 0.02)
    toks = np.random.default_rng(14).integers(0, 8192, (3, 40)).astype(np.int32)
    want = np.asarray(jm._embed({"embed": table}, toks))
    got = M.build_model(cfg)._embed({"embed": t(table)}, t(toks)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_vocab_padding_keeps_padded_logits():
    from repro.models.transformer import pad_vocab as jpad
    from repro_torch.models.transformer import pad_vocab
    for v in (49155, 151936, 250, 504, 262144):
        assert pad_vocab(v) == jpad(v)
    assert pad_vocab(49155) == 49168
    cfg = dataclasses.replace(configs.get_reduced("granite-moe-3b-a800m"),
                              vocab_size=250)
    m = M.build_model(cfg, model_axis=1)
    params = M.init_params(m, seed=0, device="cpu")
    assert tuple(params["embed"].shape) == (256, cfg.d_model)
    with torch.inference_mode():
        logits, _ = m.decode_step(params, m.init_cache(2, 4),
                                  torch.zeros((2, 1), dtype=torch.int32), 0)
    assert tuple(logits.shape) == (2, 1, 256)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_forward_drops_tokens_like_reference(arch):
    # capacity_factor 0.5: cap = 4 slots for the 8 choices an expert gets
    # on average, so tokens drop; model_axis 16 pads 8 experts to 16.
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), capacity_factor=0.5)
    cfg = dataclasses.replace(configs.get_reduced(arch), capacity_factor=0.5)
    p = jax.jit(lambda k: jmoe.init(k, jcfg, jnp.float32, model_axis=16))(
        jax.random.PRNGKey(3))
    p = jax.tree.map(np.asarray, p)
    x = rng_normal(15, (2, 32, cfg.d_model))
    out_j, aux_j = jax.jit(lambda p, x: jmoe.forward(p, jcfg, x, model_axis=16))(p, x)
    tp = M.params_from_jax(p, "cpu")
    out, aux = moe.forward(tp, cfg, t(x), model_axis=16)
    close(out, out_j)
    close(aux, aux_j)
    *_, keep = moe.route(tp, cfg, t(x).reshape(2, 32, cfg.d_model))
    assert 0 < int(keep.sum()) < keep.numel(), "no token dropped"


# ---------------------------------------------------------------------------
# model stacks, weights carried across
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pair(arch):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jm = JM.build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))   # the JAX package's init
    m = M.build_model(cfg)
    m.load_params(M.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return jm, jp, m


def reference_tree(arch):
    """The reference's parameter tree at the reduced preset, traced without
    compiling its init (``jax.eval_shape``): zeros of each leaf's shape and
    dtype, as numpy arrays."""
    jm = JM.build_model(jconfigs.get_reduced(arch))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


@functools.lru_cache(maxsize=None)
def batches(arch):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jb = JM.demo_batch(jcfg, BATCH, SEQ, seed=1)
    tb = M.demo_batch(cfg, BATCH, SEQ, seed=1, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    return jb, tb


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_forward_matches_reference(arch):
    jm, jp, m = pair(arch)
    jb, tb = batches(arch)
    with torch.inference_mode():
        got = m.forward(m.params, tb)
        if arch == "hubert-xlarge":
            logits = M.make_encode_step(m)(m.params, tb)
    want, want_aux = jax.jit(lambda p, b: (jm.forward(p, b), jm._last_aux))(jp, jb)
    close(got, want)
    if arch != "hubert-xlarge":   # prefill: the head on the last position
        with torch.inference_mode():
            last = M.make_prefill_step(m)(m.params, tb)
        close(last, jm._logits(jp, want[:, -1:]))
    if m.cfg.family == "moe":
        close(m._last_aux, want_aux)
    if arch == "hubert-xlarge":
        close(logits, jax.jit(JM.make_encode_step(jm))(jp, jb))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference_at_every_position(arch):
    jm, jp, m = pair(arch)
    jb, tb = batches(arch)
    jcache = jm.init_cache(BATCH, MAX_LEN)
    cache = m.init_cache(BATCH, MAX_LEN)
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
                            cache))
    toks = np.asarray(jb["tokens"])
    step = jax.jit(JM.make_decode_step(jm))
    with torch.inference_mode():
        for pos in range(toks.shape[1]):
            want, jcache = step(jp, jcache, toks[:, pos:pos + 1],
                                jnp.asarray(pos, jnp.int32))
            got, cache = m.decode_step(m.params, cache, tb["tokens"][:, pos:pos + 1],
                                       pos)
            close(got, want)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_forward_matches_reference(arch):
    """Hidden states, and the prefill's last-position logits."""
    jm, jp, m = pair(arch)
    jb, tb = batches(arch)
    with torch.inference_mode():
        got = m.forward(m.params, tb)
        last = M.make_prefill_step(m)(m.params, tb)
    with jax.enable_x64(False):
        want = jax.jit(jm.forward)(jp, jb)
        want_last = jm._logits(jp, want[:, -1:])
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    close(got, want)
    close(last, want_last)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_decode_matches_reference_at_every_position(arch):
    """Teacher-forced decode from zeroed caches (zamba2's shared attention
    block holds one KV cache per unit): every position's logits, and the
    caches' tree, shapes and dtypes (float32 states in a model of any
    dtype)."""
    jm, jp, m = pair(arch)
    jb, tb = batches(arch)
    jcache = jm.init_cache(BATCH, MAX_LEN)
    cache = m.init_cache(BATCH, MAX_LEN)
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
                            cache))
    toks = np.asarray(jb["tokens"])
    with jax.enable_x64(False):
        step = jax.jit(JM.make_decode_step(jm))
        for pos in range(toks.shape[1]):
            want, jcache = step(jp, jcache, toks[:, pos:pos + 1],
                                jnp.asarray(pos, jnp.int32))
            with torch.inference_mode():
                got, cache = m.decode_step(m.params, cache,
                                           tb["tokens"][:, pos:pos + 1], pos)
            close(got, want)
    flat = dict(_flatten(jax.tree.map(np.asarray, jcache)))
    for k, v in _flatten(cache).items():
        close(v, flat[k])


@pytest.mark.parametrize("arch", ATTENTION_ARCHS + RECURRENT_ARCHS)
def test_flatten_params_matches_checkpoint_keys(arch):
    """The reference's tree carried across (``params_from_jax``): keys,
    shapes and dtypes in its ``tree_flatten_with_path`` order (the
    recurrent archs' float32 ``A_log``, ``D`` and ``dt_bias`` among
    them)."""
    jp = reference_tree(arch)
    m = M.build_model(configs.get_reduced(arch))
    m.load_params(M.params_from_jax(jp, "cpu"))
    want = [(k, (a.shape, str(a.dtype))) for k, a in _flatten(jp).items()]
    got = [(k, (tuple(p.shape), str(p.dtype).split(".")[1]))
           for k, p in M.flatten_params(m).items()]
    assert got == want


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "gemma3-4b", "llava-next-34b"]
                         + RECURRENT_ARCHS)
def test_init_params_shapes_match_reference_tree(arch):
    # The port's own init draws other values, but the same tree.
    jp = reference_tree(arch)
    m = M.build_model(configs.get_reduced(arch))
    M.init_params(m, seed=0, device="cpu")
    want = {k: a.shape for k, a in _flatten(jp).items()}
    assert {k: tuple(p.shape) for k, p in M.flatten_params(m).items()} == want


def test_recurrent_init_keeps_float32_leaves_in_a_bfloat16_model():
    """zamba2's ``A_log``, ``D`` and ``dt_bias`` stay float32 in a bfloat16
    model, as the reference's do (``ssm.py:43-45``); every other leaf takes
    the model's dtype."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("zamba2-7b"), dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_reduced("zamba2-7b"), dtype="bfloat16")
    jp = jax.eval_shape(JM.build_model(jcfg).init, jax.random.PRNGKey(0))
    want = {k: str(a.dtype) for k, a in _flatten(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jp)).items()}
    m = M.build_model(cfg)
    M.init_params(m, seed=0, device="cpu")
    got = {k: str(p.dtype).split(".")[1] for k, p in M.flatten_params(m).items()}
    assert got == want
    assert {k for k, d in got.items() if d == "float32"} == {
        f"{s}/mamba/{n}" for s in ("mamba_units", "mamba_rem")
        for n in ("A_log", "D", "dt_bias")}
