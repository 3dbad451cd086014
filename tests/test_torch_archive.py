"""The port's byte layer against the JAX package's: its msgpack subset packs
to ``msgpack.packb`` bytes and reads them back, and the codec, entropy,
outlier and weight blobs are byte-identical for equal inputs."""
import math

import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.compressors import codec as ref_codec
from repro.compressors import entropy as ref_entropy
from repro.compressors import outliers as ref_outliers
from repro.core import archive as ref_archive
from repro.core import skipping_dnn as ref_dnn
from repro_torch.compressors import codec as port_codec
from repro_torch.compressors import entropy as port_entropy
from repro_torch.compressors import outliers as port_outliers
from repro_torch.core import archive as port_archive
from repro_torch.core import skipping_dnn as port_dnn

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

_INT_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
              -2**31 - 1, -2**63]

_scalars = (st.none() | st.booleans() | st.sampled_from(_INT_EDGES)
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_msgpack_subset_matches_msgpack(obj):
    want = msgpack.packb(obj, default=ref_archive._default, use_bin_type=True)
    got = port_archive.dumps(obj)
    assert got == want
    assert port_archive.loads(got) == ref_archive.loads(want)


@pytest.mark.parametrize("n", [0, 15, 16, 255, 256, 70000])
def test_msgpack_sized_forms(n):
    # Lengths at every header boundary: fix, 8-, 16- and 32-bit forms.
    objs = ["x" * n, b"y" * n, list(range(min(n, 70000))),
            {str(i): i for i in range(min(n, 300))}]
    for obj in objs:
        want = msgpack.packb(obj, default=ref_archive._default, use_bin_type=True)
        assert port_archive.dumps(obj) == want
        assert port_archive.loads(want) == obj


def test_msgpack_numpy_values():
    obj = {"arr": np.arange(12, dtype=np.float32).reshape(3, 4),
           "i": np.int64(-7), "f": np.float32(0.5), "d": np.float64(1.25),
           "b": np.bool_(True), "nested": [np.uint8(200), {"z": np.zeros(0)}]}
    want = ref_archive.dumps(obj)
    assert port_archive.dumps(obj) == want
    got = port_archive.loads(want)
    assert got["arr"].dtype == np.float32
    assert np.array_equal(got["arr"], obj["arr"])
    assert got["i"] == -7 and got["b"] is True
    assert math.isclose(got["f"], 0.5)


def test_blobs_byte_identical():
    rng = np.random.default_rng(3)
    assert port_codec.default_codec() == ref_codec.default_codec()
    raw = rng.integers(0, 4, 5000).astype(np.uint8).tobytes()
    assert port_codec.compress(raw) == ref_codec.compress(raw)
    for codes in (rng.integers(-3, 4, (6, 7, 8)), rng.integers(-900, 900, 500),
                  np.zeros(0, np.int32), rng.integers(-2**20, 2**20, 64)):
        codes = codes.astype(np.int32)
        blob = port_entropy.encode_codes(codes)
        assert blob == ref_entropy.encode_codes(codes)
        assert np.array_equal(port_entropy.decode_codes(blob), codes)
    lits = rng.standard_normal(333)
    assert port_entropy.encode_floats(lits) == ref_entropy.encode_floats(lits)
    for shape, p in (((5, 17, 19), 0.02), ((4, 8), 0.0), ((3, 3, 3), 1.0)):
        mask = rng.random(shape) < p
        blob = port_outliers.encode_outliers(mask)
        assert blob == ref_outliers.encode_outliers(mask)
        assert np.array_equal(port_outliers.decode_outliers(blob), mask)


@pytest.mark.parametrize("weight_dtype", ["float32", "float16"])
def test_pack_weights_byte_identical(weight_dtype):
    cfg = ref_dnn.SkippingDNNConfig(c_in=2)
    ref_params = ref_dnn.init_params(jax.random.PRNGKey(5), cfg)
    np_params = jax.tree.map(np.asarray, ref_params)
    model = port_dnn.SkippingDNN(
        port_dnn.SkippingDNNConfig(c_in=2),
        port_dnn.params_from_jax(np_params), device="cpu")
    blob = port_archive.pack_weights(model.tree(), weight_dtype)
    assert blob == ref_archive.pack_weights(ref_params, weight_dtype)
    assert blob["n_params"] == ref_dnn.param_count(ref_params)
    # Each package reads the other's blob back into its own layout.
    like = {name: {"b": None, "w": None} for name in port_dnn.LAYERS}
    back = port_archive.unpack_weights(blob, like)
    ref_back = ref_archive.unpack_weights(blob, ref_params)
    for name in port_dnn.LAYERS:
        for k in ("b", "w"):
            assert np.array_equal(back[name][k], np.asarray(ref_back[name][k]))
