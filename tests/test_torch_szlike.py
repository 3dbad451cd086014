"""The port's szlike interpolation compressor against the JAX package's:
payloads, header numbers and reconstruction byte-identical (the walk is
float64 elementwise arithmetic with round-half-even in both), and each
package decodes the other's archive to the same bytes."""
import numpy as np
import pytest
import torch

from repro.compressors import quantize as ref_quantize
from repro.compressors import szlike as ref_sz
from repro.data import fields as ref_fields
from repro_torch.compressors import quantize as port_quantize
from repro_torch.compressors import szlike as port_sz
from repro_torch.compressors.quantize import CODE_CAP

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)


def _field(dataset, rel_eb):
    """A snapshot field, its absolute bound from the clean field, then a NaN
    literal (its neighbours' predictions turn non-finite too) and a value
    whose code overflows CODE_CAP at that bound."""
    name = ref_fields.DATASET_FIELDS[dataset][-1]
    x = ref_fields.make_fields(dataset, SHAPE, seed=1)[name].copy()
    eb = port_quantize.abs_bound_from_rel(x, rel_eb)
    assert eb == ref_quantize.abs_bound_from_rel(x, rel_eb)
    x[4, 7, 5] = np.nan
    x[2, 3, 11] = x[2, 3, 11] + 4.0 * CODE_CAP * eb
    return x, eb


@pytest.mark.parametrize("rel_eb", [1e-2, 1e-4])
@pytest.mark.parametrize("dataset", ["hurricane", "miranda"])
def test_payloads_and_rec_byte_identical(dataset, rel_eb):
    x, eb = _field(dataset, rel_eb)
    assert x.dtype == np.dtype(ref_fields.DATASET_DTYPES[dataset])
    ref_arc, ref_rec = ref_sz.compress(x, abs_eb=eb, lowering="eager")
    arc, rec = port_sz.compress(x, abs_eb=eb, device="cpu")
    for key in ("codes", "unpred", "literals"):
        assert arc[key]["payload"] == ref_arc[key]["payload"], key
    for key in ("mean", "eb_int", "abs_eb", "pad_shape", "shape", "level",
                "dtype", "nbytes"):
        assert arc[key] == ref_arc[key], key
    assert rec.dtype == ref_rec.dtype
    assert rec.tobytes() == ref_rec.tobytes()
    # Both escapes made it into the literal stream.
    assert ref_sz._decode_mask(arc["unpred"]).sum() >= 2

    port_dec = port_sz.decompress(arc, device="cpu")
    assert port_dec.tobytes() == ref_sz.decompress(arc).tobytes()
    assert port_dec.tobytes() == rec.tobytes()
    assert port_sz.decompress(ref_arc, device="cpu").tobytes() == ref_rec.tobytes()

