"""The port's LM training path against the JAX package, on the CPU: the
chunked loss, its gradients, the tree-form AdamW, ``make_train_step``
with microbatches, remat, ``warmup_cosine`` and the error-feedback
quantizer.  The reference's weights are carried across by
``params_from_jax``; inputs come from a numpy seed.  The reference runs
its models inside ``jax.enable_x64(False)`` (its chunked attention fails
under 64-bit types, which its compressors turn on at import), and each of
its jitted functions is compiled once per arch.

Tolerances (float32): a loss within 2e-6 · |loss| (1e-6 for the recurrent
archs); a gradient leaf within 1e-5 · max |reference leaf| + 1e-7 (sums of
up to 2·32·256 terms in another order; measured 1.2e-6); AdamW on the same
inputs within 1 bfloat16 ulp on the parameters and 1e-6 of each moment
leaf's largest value (elementwise relative error is ill-defined where
b1·m + (1−b1)·g cancels).

The recurrent archs' whole-model gradients are held within 1e-4 · max
|reference leaf| + 1e-7.  Their cells are held at 1e-5 one by one
(``test_torch_recurrent.py``), but stacked layers of exponential gates
and max-stabilised normalisers amplify rounding: at these inputs the two
packages' float32 gradients are 1.4e-5 (zamba2-7b) and 2.8e-5
(xlstm-350m) of a leaf's largest apart, spread over every leaf, and the
card's float32 gradients part from the CPU's by as much (3.4e-5, 6.0e-5;
``chip_smoke.py``'s train parity).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jschedule
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.optim import adamw, grad_compress, schedule
from repro_torch.optim.adamw import AdamWState, tree_leaves

BATCH, SEQ = 2, 32
LOSS_REL = 2e-6
GRAD_REL, GRAD_ABS = 1e-5, 1e-7
RECURRENT_ARCHS = ["zamba2-7b", "xlstm-350m"]
LOSS_ARCHS = ["qwen3-4b", "granite-moe-3b-a800m", "llava-next-34b",
              "hubert-xlarge"]
GRAD_ARCHS = ["qwen3-4b", "granite-moe-3b-a800m"] + RECURRENT_ARCHS
RECURRENT_LOSS_REL, RECURRENT_GRAD_REL = 1e-6, 1e-4


def seq_len(cfg):
    return SEQ + (cfg.frontend_tokens if cfg.family == "vlm" else 0)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The JAX package's config, model, parameters (numpy) and batch."""
    jcfg = jconfigs.get_reduced(arch)
    jm = JM.build_model(jcfg, model_axis=1)
    with jax.enable_x64(False):
        jp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    jb = JM.demo_batch(jcfg, BATCH, seq_len(jcfg), seed=1)
    return jcfg, jm, jp, jb


def port(arch):
    """A port model holding the reference's parameters, and its batch."""
    _, _, jp, _ = reference(arch)
    cfg = configs.get_reduced(arch)
    m = M.build_model(cfg, model_axis=1)
    params = m.load_params(M.params_from_jax(jp, "cpu"))
    return m, params, M.demo_batch(cfg, BATCH, seq_len(cfg), seed=1, device="cpu")


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch):
    _, jm, jp, jb = reference(arch)
    with jax.enable_x64(False):
        if arch in GRAD_ARCHS:
            loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
            return float(loss), jax.tree.map(np.asarray, grads)
        return float(jax.jit(jm.loss)(jp, jb)), None


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def numpy(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_matches_reference(arch):
    m, params, batch = port(arch)
    want, _ = reference_loss_and_grads(arch)
    with torch.no_grad():
        got = float(m.loss(params, batch))
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    if m.cfg.family == "moe":
        assert m._last_aux is not None and float(m._last_aux) > 0


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(arch):
    """Every leaf's gradient, zamba2's one ``shared_attn`` block (the sum
    over its uses after each unit) and its float32 ``A_log`` / ``D`` /
    ``dt_bias`` among them; for the recurrent archs the loss too, within
    1e-6 relative (the reference's loss and gradients are one compile)."""
    m, params, batch = port(arch)
    want_loss, want = reference_loss_and_grads(arch)
    names = sorted(flat(params))
    leaves = [flat(params)[k] for k in names]
    loss = m.loss(params, batch)
    if arch in RECURRENT_ARCHS:     # their loss is held here, one compile
        assert abs(float(loss.detach()) - want_loss) <= RECURRENT_LOSS_REL * abs(want_loss)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    want = flat(want)
    assert sorted(want) == names
    rel = RECURRENT_GRAD_REL if arch in RECURRENT_ARCHS else GRAD_REL
    for k, g in zip(names, grads):
        w = want[k]
        assert g.dtype == flat(params)[k].dtype and w.dtype == g.numpy().dtype
        err = float(np.max(np.abs(numpy(g).astype(np.float64) - w)))
        lim = rel * float(np.max(np.abs(w))) + GRAD_ABS
        assert err <= lim, f"{k}: max |Δ| {err} > {lim}"


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_remat_policies_give_the_same_gradients_bit_for_bit(arch):
    # The port alone: its own init (no reference compile for the weights).
    cfg = configs.get_reduced(arch)
    m = M.build_model(cfg, model_axis=1)
    params = M.init_params(m, seed=0, device="cpu")
    batch = M.demo_batch(cfg, BATCH, seq_len(cfg), seed=1, device="cpu")
    leaves = tree_leaves(params)

    def grads(policy):
        loss = m.loss(params, batch, remat_policy=policy)
        return [loss] + list(torch.autograd.grad(loss, leaves))

    plain = grads("none")
    for policy in ("nothing", "dots"):
        for a, b in zip(plain, grads(policy)):
            assert torch.equal(a, b), policy


def _plain_ce(m, params, hidden, tokens) -> float:
    """A plain cross-entropy over every next-token target, float64."""
    logits = m._logits(params, hidden[:, :-1]).double()
    lp = torch.log_softmax(logits, dim=-1)
    return float(-lp.gather(-1, tokens[:, 1:].long()[..., None]).mean())


@pytest.mark.parametrize("s", [1100, 1024])
def test_loss_takes_every_target_of_a_ragged_tail(s):
    """The loss over ``s = seq - 1`` targets in chunks of 512: at s = 1100
    the port takes the last 76 as a shorter chunk and equals a plain
    cross-entropy over all of them, where the reference drops them; at
    s = 1024 it equals the reference's.  Both models' forwards are
    replaced by the same hidden states."""
    jcfg, jm, jp, _ = reference("qwen3-4b")
    m, params, _ = port("qwen3-4b")
    rng = np.random.default_rng(s)
    hidden = rng.standard_normal((1, s + 1, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (1, s + 1)).astype(np.int32)
    jm = JM.build_model(jcfg, model_axis=1)
    jm.forward = lambda p, b, remat_policy="nothing": b["hidden"]
    m.forward = lambda p, b, remat_policy="nothing": b["hidden"]
    with jax.enable_x64(False):
        want = float(jax.jit(jm.loss)(jp, {"tokens": tokens, "hidden": hidden}))
    th = torch.from_numpy(hidden)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        got = float(m.loss(params, {"tokens": tt, "hidden": th}))
        plain = _plain_ce(m, params, th, tt)
    assert abs(got - plain) <= LOSS_REL * abs(plain), (got, plain)
    if s % 512:
        with torch.no_grad():
            head = _plain_ce(m, params, th[:, :1025], tt[:, :1025])
        assert abs(want - head) <= LOSS_REL * abs(head), (want, head)
        assert abs(got - want) > 1e-3      # the reference's dropped tail
    else:
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _adam_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 40, 50), "b": {"c": (64,), "d": (7, 130)}}

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def tree(scale):
        return jax.tree.map(lambda s: draw(s, scale), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))
    params, grads = tree(0.5), tree(0.05)
    mu = tree(0.01)
    nu = jax.tree.map(lambda v: np.abs(v), tree(1e-3))
    return params, grads, mu, nu


def _to_torch(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _bits(t):
    return t.view(torch.int16).numpy().astype(np.int32)


def _leaf_dtypes(dtype):
    """Each leaf's dtype; ``mixed`` keeps a 1-D leaf float32 in a bfloat16
    tree, as zamba2-7b keeps ``A_log``, ``D`` and ``dt_bias``."""
    if dtype == "mixed":
        return {"a": "bfloat16", "b": {"c": "float32", "d": "bfloat16"}}
    return {"a": dtype, "b": {"c": dtype, "d": dtype}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_adamw_update_matches_reference_with_the_clip_active(dtype):
    """Same grads, params and state through both updates, the global-norm
    clip scaling the gradients (norm ≈ 2.4 against 0.5).  In bfloat16 the
    clip's float32 scale must meet float32 gradients: scaling the bfloat16
    gradients themselves moves the moments by ~1e-3 relative."""
    params, grads, mu, nu = _adam_inputs(dtype)
    dts = _leaf_dtypes(dtype)

    def jax_tree(tree):
        return jax.tree.map(lambda a, d: jnp.asarray(a, getattr(jnp, d)), tree, dts)

    def torch_tree(tree):
        return jax.tree.map(lambda a, d: torch.from_numpy(np.array(a)).to(
            getattr(torch, d)), tree, dts)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1, grad_clip_norm=0.5)
    with jax.enable_x64(False):
        jstate = jadamw.AdamWState(step=jnp.asarray(2, jnp.int32),
                                   mu=jax.tree.map(jnp.asarray, mu),
                                   nu=jax.tree.map(jnp.asarray, nu))
        jp, js = jadamw.adamw_update(jax_tree(grads), jstate, jax_tree(params),
                                     lr=jnp.asarray(3e-3, jnp.float32), **kw)
        gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                                   for g in jax.tree.leaves(jax_tree(grads)))))
    assert gnorm > 4 * kw["grad_clip_norm"]
    tp, tg = torch_tree(params), torch_tree(grads)
    state = AdamWState(step=2, mu=_to_torch(mu, torch.float32),
                       nu=_to_torch(nu, torch.float32))
    assert abs(float(adamw.global_norm(tg)) - gnorm) <= 1e-6 * gnorm
    new_p, new_s = adamw.adamw_update(tg, state, tp, lr=3e-3, **kw)
    assert new_s.step == 3 and int(js.step) == 3
    assert new_p is tp and new_s.mu is state.mu     # in place
    for got, want, d in zip(tree_leaves(new_p), jax.tree.leaves(jp),
                            jax.tree.leaves(dts)):
        assert got.dtype == getattr(torch, d)
        if d == "bfloat16":
            want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(got.dtype)
            assert np.abs(_bits(got) - _bits(want_t)).max() <= 1
        else:
            w = np.asarray(want)
            assert np.abs(got.numpy() - w).max() <= 1e-6 * np.abs(w).max()
    for tree_got, tree_want in ((new_s.mu, js.mu), (new_s.nu, js.nu)):
        for got, want in zip(tree_leaves(tree_got), jax.tree.leaves(tree_want)):
            w = np.asarray(want, np.float64)
            assert np.abs(got.numpy() - w).max() <= 1e-6 * np.abs(w).max()


def test_adamw_update_keeps_temporaries_to_a_piece(monkeypatch):
    """A leaf larger than PIECE is updated slice by slice of its leading
    axis, with the same values as a whole-leaf update (one clip norm
    given to both)."""
    params, grads, mu, nu = _adam_inputs("float32", seed=3)

    def run():
        tp, tg = _to_torch(params, torch.float32), _to_torch(grads, torch.float32)
        st = AdamWState(step=0, mu=_to_torch(mu, torch.float32),
                        nu=_to_torch(nu, torch.float32))
        p, st = adamw.adamw_update(tg, st, tp, lr=1e-2, weight_decay=0.1,
                                   grad_clip_norm=1.0, gnorm=torch.tensor(3.0))
        return tree_leaves(p) + tree_leaves(st.mu) + tree_leaves(st.nu)
    whole = run()
    monkeypatch.setattr(adamw, "PIECE", 2000)
    assert len(adamw.pieces(torch.zeros(3, 40, 50))) == 3
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


def test_warmup_cosine_matches_reference():
    for base, warm, total in ((3e-3, 1, 8), (1e-3, 10, 100), (3e-3, 2, 50)):
        got = schedule.warmup_cosine(base, warm, total)
        want = jschedule.warmup_cosine(base, warm, total)
        for step in range(0, total + 3):
            w = np.float32(want(jnp.asarray(step, jnp.int32)))
            g = np.float32(got(step))
            # XLA's float32 cosine is off by an ulp at some points, which
            # the decay's two roundings carry to at most two.
            assert abs(int(g.view(np.int32)) - int(w.view(np.int32))) <= 2, (
                base, warm, total, step, g, w)


def test_quantize_ef_dequantize_init_ef_match_reference():
    rng = np.random.default_rng(5)
    g = {"w": (rng.standard_normal((64, 48)) * 0.1).astype(np.float32),
         "b": {"c": (rng.standard_normal((33,)) * 3).astype(np.float32)}}
    jef = jgc.init_ef(g)
    ef = grad_compress.init_ef(_to_torch(g, torch.float32))
    for bits in (8, 4):
        jq, js, jef = jgc.quantize_ef(g, jef, bits=bits)
        q, s, ef = grad_compress.quantize_ef(_to_torch(g, torch.float32), ef,
                                             bits=bits)
        for a, b in zip(tree_leaves(q), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8 and np.array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(s), jax.tree.leaves(js)):
            assert float(a) == float(b)
        for a, b in zip(tree_leaves(ef), jax.tree.leaves(jef)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(grad_compress.dequantize(q, s)),
                        jax.tree.leaves(jgc.dequantize(jq, js))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_train_step_with_microbatches_matches_reference():
    """Three steps of ``make_train_step(microbatch=2)``: each step's loss
    and, after the last, the moments, against the reference's.  The
    parameters are not held tightly: m̂ / (√v̂ + ε) is ill-conditioned where
    |g| is near ε."""
    arch = "qwen3-4b"
    jcfg, jm, jp, _ = reference(arch)
    m, params, _ = port(arch)
    kw = dict(lr=1e-3, microbatch=2)
    jstep = jax.jit(JM.make_train_step(jm, **kw))
    step = M.make_train_step(m, **kw)
    jparams, jopt = jp, jadamw.adamw_init(jp)
    opt = adamw.adamw_init(params)
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(
            0, jcfg.vocab_size, (4, SEQ)).astype(np.int32)
        with jax.enable_x64(False):
            jparams, jopt, jmet = jstep(jparams, jopt, {"tokens": toks},
                                        jnp.asarray(i, jnp.int32))
        params, opt, met = step(params, opt, {"tokens": torch.from_numpy(toks)}, i)
        want = float(jmet["loss"])
        assert abs(float(met["loss"]) - want) <= 1e-6 * abs(want), (i, met, want)
        assert np.float32(met["lr"]) == np.float32(jmet["lr"])
    assert opt.step == int(jopt.step) == 3
    for tree_got, tree_want in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        got, want = flat(tree_got), flat(jax.tree.map(np.asarray, tree_want))
        for k in want:
            w = want[k].astype(np.float64)
            err = float(np.max(np.abs(got[k].numpy() - w)))
            # measured 3.6e-5: three steps of parameters apart by rounding
            assert err <= 2e-4 * float(np.max(np.abs(w))) + 1e-12, (k, err)


def test_microbatches_split_the_batch_like_one_step():
    """``microbatch=2`` against one step over the whole batch: the same
    loss and, with a float32 model, the same update within tolerance."""
    arch = "qwen3-4b"
    jcfg = jconfigs.get_reduced(arch)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (4, SEQ)).astype(np.int32))
    out = []
    for mb in (1, 2):
        m, params, _ = port(arch)
        opt = adamw.adamw_init(params)
        params, opt, met = M.make_train_step(m, lr=1e-3, microbatch=mb)(
            params, opt, {"tokens": toks}, 0)
        out.append((float(met["loss"]), float(met["grad_norm"]), opt))
    (l1, n1, o1), (l2, n2, o2) = out
    assert abs(l1 - l2) <= 1e-5 * abs(l1) and abs(n1 - n2) <= 1e-4 * n1
    for a, b in zip(tree_leaves(o1.mu), tree_leaves(o2.mu)):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()) + 1e-12


def test_init_train_state_and_trainable_parameters():
    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"), dtype="bfloat16")
    m = M.build_model(cfg, model_axis=1)
    params, opt = M.init_train_state(m, seed=0, device="cpu")
    assert all(p.requires_grad for p in m.parameters())
    assert opt.step == 0
    for p, mu, nu in zip(tree_leaves(params), tree_leaves(opt.mu), tree_leaves(opt.nu)):
        assert p.dtype == torch.bfloat16 and mu.dtype == nu.dtype == torch.float32
        assert mu.shape == p.shape and not mu.any() and not nu.any()
    with torch.inference_mode():     # serving takes no gradients
        logits, _ = m.decode_step(params, m.init_cache(1, 2),
                                  torch.zeros((1, 1), dtype=torch.int32), 0)
    assert not logits.requires_grad
