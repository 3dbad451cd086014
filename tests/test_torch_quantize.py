"""The rest of the compressors' public surface against the JAX package's:
``quantize`` / ``dequantize`` / ``quantize_reconstruct`` / ``prequantize``
byte for byte (float32 and float64, with escapes, NaN and infinity) at the
suite's 9×20×24 field shape, ``entropy.first_order_entropy_bits``, and the
codec's ``available_codecs`` / ``set_default_codec`` with the resolution
order explicit > override > ``$REPRO_CODEC`` > best."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compressors import codec as ref_codec
from repro.compressors import entropy as ref_entropy
from repro.compressors import quantize as ref_q
from repro_torch.compressors import codec, entropy
from repro_torch.compressors import quantize as port_q

torch.set_num_threads(1)

SHAPE = (9, 20, 24)


def _values(dtype):
    rng = np.random.default_rng(7)
    x = (np.cumsum(rng.standard_normal(SHAPE), axis=1) * 3).astype(dtype)
    pred = (x + rng.standard_normal(SHAPE) * 0.05).astype(dtype)
    x[0, 0, 0] = np.nan
    x[1, 2, 3] = np.inf
    x[2, 3, 4] = 1e9                    # past CODE_CAP: an escape
    x[3, 4, 5] = pred[3, 4, 5] + np.asarray(2.5 * 2 * 1e-2, dtype)  # a half point
    return x, pred


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quantize_primitives_match_reference(dtype):
    x, pred = _values(dtype)
    eb = 1e-2
    tx, tp = torch.from_numpy(x), torch.from_numpy(pred)
    rc, ru = ref_q.quantize(jnp.asarray(x), jnp.asarray(pred), eb)
    pc, pu = port_q.quantize(tx, tp, eb)
    assert pc.dtype == torch.int32
    assert pc.numpy().tobytes() == np.asarray(rc).tobytes()
    assert np.array_equal(pu.numpy(), np.asarray(ru)) and pu.sum() >= 3
    deq = np.asarray(ref_q.dequantize(rc, jnp.asarray(pred), eb))
    assert port_q.dequantize(pc, tp, eb).numpy().tobytes() == deq.tobytes()
    r3 = [np.asarray(a) for a in ref_q.quantize_reconstruct(
        jnp.asarray(x), jnp.asarray(pred), eb)]
    p3 = [a.numpy() for a in port_q.quantize_reconstruct(tx, tp, eb)]
    for a, b in zip(p3, r3):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rp = [np.asarray(a) for a in ref_q.prequantize(jnp.asarray(x), eb)]
    pp = [a.numpy() for a in port_q.prequantize(tx, eb)]
    for a, b in zip(pp, rp):
        assert a.tobytes() == b.tobytes()


def test_first_order_entropy_bits_matches_reference():
    rng = np.random.default_rng(1)
    for codes in (rng.integers(-20, 20, SHAPE).astype(np.int32),
                  np.zeros(SHAPE[1:], np.int32), np.zeros(0, np.int32)):
        assert entropy.first_order_entropy_bits(codes) == \
            ref_entropy.first_order_entropy_bits(codes)


@pytest.mark.parametrize("env", [None, "zlib"])
@pytest.mark.parametrize("override", [None, "zlib"])
def test_codec_resolution_matches_reference(monkeypatch, override, env):
    assert codec.available_codecs() == ref_codec.available_codecs()
    if env is None:
        monkeypatch.delenv("REPRO_CODEC", raising=False)
    else:
        monkeypatch.setenv("REPRO_CODEC", env)
    try:
        codec.set_default_codec(override)
        ref_codec.set_default_codec(override)
        assert codec.default_codec() == ref_codec.default_codec()
        data = bytes(range(256)) * 8
        payload, name = codec.compress(data)
        assert name == codec.default_codec()
        # Explicit beats the override.
        assert codec.compress(data, codec="zlib")[1] == "zlib"
        assert codec.decompress(payload, name) == data
    finally:
        codec.set_default_codec(None)
        ref_codec.set_default_codec(None)
    with pytest.raises(ValueError):
        codec.set_default_codec("lz4")
