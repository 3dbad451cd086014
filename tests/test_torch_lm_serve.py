"""The LM serving slice as a whole against the JAX package, on the CPU:
the serve loop's greedy tokens on weights carried across, ``serve(args)``'s
report, the token stream's bytes, the configs, and the families the port
refuses.  Greedy tokens are compared exactly (argmax of float32 logits
that agree to 1e-4 of their range)."""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch import configs
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import serve
from repro_torch.models import model as M

SERVE_ARCHS = ["qwen3-4b", "gemma-2b"]


@functools.lru_cache(maxsize=None)
def jax_report(arch):
    args = SimpleNamespace(arch=arch, batch=2, prompt_len=12, gen=6, seed=0)
    return jserve.serve(args)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_loop_tokens_equal_reference(arch):
    batch, plen, gen = 2, 16, 8
    jm = JM.build_model(jconfigs.get_reduced(arch), model_axis=1)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    prompts = JTokenStream(jm.cfg.vocab_size, batch, plen, seed=0).next_batch()

    # The reference driver's loop (repro.launch.serve.serve).
    logits, cache, pos = jserve.prefill_into_cache(jm, jp, jnp.asarray(prompts),
                                                   plen + gen)
    step = jax.jit(JM.make_decode_step(jm), donate_argnums=(1,))
    toks = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [np.asarray(toks)]
    for i in range(gen - 1):
        logits, cache = step(jp, cache, toks, jnp.asarray(pos + i, jnp.int32))
        toks = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(np.asarray(toks))
    want = np.concatenate(want, axis=1)

    m = M.build_model(configs.get_reduced(arch), model_axis=1)
    params = m.load_params(M.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    with torch.inference_mode():
        logits, cache, pos = serve.prefill_into_cache(
            m, params, torch.from_numpy(prompts), plen + gen)
        got, _ = serve.greedy_decode(m, params, cache, logits, pos, gen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_report_on_cpu(arch, capsys):
    args = SimpleNamespace(arch=arch, batch=2, prompt_len=12, gen=6, seed=0,
                           device="cpu")
    report = serve.serve(args)
    want = jax_report(arch)
    assert set(want) <= set(report)
    assert report["generated"] == args.gen == want["generated"]
    assert report["device"] == "cpu"
    assert report["decode_tok_per_s"] > 0
    assert all(0 <= tok < configs.get_reduced(arch).vocab_size
               for tok in report["sample_tokens"])


def test_serve_refuses_encoder_only():
    args = SimpleNamespace(arch="hubert-xlarge", batch=2, prompt_len=8, gen=4,
                           seed=0, device="cpu")
    with pytest.raises(SystemExit):
        serve.serve(args)


def test_token_stream_byte_identical_with_checkpoint_and_restore():
    mine, ref = TokenStream(1000, 3, 70, seed=5), JTokenStream(1000, 3, 70, seed=5)
    for _ in range(3):
        a, b = mine.next_batch(), ref.next_batch()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    state = mine.checkpoint()
    assert state == ref.checkpoint() == {"seed": 5, "step": 3}
    after = mine.next_batch().tobytes()
    mine.restore(state)
    ref.restore(state)
    assert mine.next_batch().tobytes() == after == ref.next_batch().tobytes()


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_reduced"):
        mine, ref = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.hd == ref.hd
        assert mine.n_params_estimate() == ref.n_params_estimate()
        assert mine.n_active_params() == ref.n_active_params()
        assert mine.params_dtype == getattr(torch, ref.dtype)


def test_registry_and_cells_equal_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.cells() == jconfigs.cells()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m"])
def test_recurrent_families_are_refused(arch):
    """The recurrent families were refused (``NotImplementedError``) until
    the port's recurrent slice; now nothing refuses them: ``build_model``
    takes them and ``launch.serve`` serves them, their caches recurrent
    states.  Their parity with the reference is in ``test_torch_models.py``
    and ``test_torch_recurrent.py``."""
    assert configs.get_reduced(arch).family in M.build_model(
        configs.get_reduced(arch)).FAMILIES
    report = serve.serve(SimpleNamespace(arch=arch, batch=2, prompt_len=8, gen=4,
                                         seed=0, device="cpu"))
    assert report["generated"] == 4 and report["device"] == "cpu"
    assert all(0 <= tok < configs.get_reduced(arch).vocab_size
               for tok in report["sample_tokens"])
