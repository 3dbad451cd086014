"""The port's roofline (``launch.roofline``) against the JAX package's.

``wire_factor`` equals the reference's for every collective kind and group
size; ``model_flops`` equals the reference's for every dry-run cell, each
package using its own configs; ``roofline_terms`` divides by the H100
constants (its seconds times them give the inputs back; float32 products
at the float32 peak), and a group's
link is NVLink inside a node of 8 consecutive ranks, the network across.
"""
import pytest

from repro import configs as ref_configs
from repro.launch import roofline as ref_rl
from repro_torch import configs
from repro_torch.launch import roofline as rl

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("n", [1, 2, 3, 8, 16, 256, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_factor_equals_the_reference(kind, n):
    assert rl.wire_factor(kind, n) == ref_rl.wire_factor(kind, n)


@pytest.mark.parametrize("n_chips", [1, 256, 512])
def test_model_flops_equal_the_reference(n_chips):
    cells = configs.cells()
    assert cells == ref_configs.cells()
    for arch, shape in cells:
        got = rl.model_flops(configs.get_config(arch), configs.SHAPES[shape],
                             n_chips)
        want = ref_rl.model_flops(ref_configs.get_config(arch),
                                  ref_configs.SHAPES[shape], n_chips)
        assert got == want, (arch, shape)


@pytest.mark.parametrize("flops,nbytes,wire", [
    (1e15, 1e12, 1e10), (3.3e12, 7.7e11, 0.0), (0.0, 2.5e9, 4.5e11)])
def test_roofline_terms_give_back_their_inputs(flops, nbytes, wire):
    t = rl.roofline_terms(flops, nbytes, wire)
    assert t["compute_s"] * rl.PEAK_FLOPS == pytest.approx(flops, rel=1e-12)
    assert t["memory_s"] * rl.HBM_BW == pytest.approx(nbytes, rel=1e-12)
    assert t["collective_s"] * rl.NET_BW == pytest.approx(wire, rel=1e-12)
    on_nvlink = rl.roofline_terms(flops, nbytes, wire, nvlink_wire_bytes=wire)
    assert on_nvlink["collective_s"] * rl.NVLINK_BW == pytest.approx(wire, rel=1e-12)
    terms = {k: t[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert t["dominant"] == max(terms, key=terms.get)


@pytest.mark.parametrize("flops,f32", [(1e15, 0.0), (1e15, 2.5e13), (4e12, 4e12)])
def test_float32_products_at_the_float32_peak(flops, f32):
    t = rl.roofline_terms(flops, 0.0, 0.0, f32_flops=f32)
    assert t["compute_s"] == pytest.approx(
        (flops - f32) / rl.PEAK_FLOPS + f32 / rl.PEAK_FLOPS_F32, rel=1e-12)


def test_h100_constants_and_links():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert rl.PEAK_FLOPS_F32 == 67e12
    assert (rl.NVLINK_BW, rl.NET_BW, rl.NODE_SIZE) == (450e9, 50e9, 8)
    assert rl.link_of(range(8)) == "nvlink"
    assert rl.link_of(range(8, 16)) == "nvlink"
    assert rl.link_of(range(16)) == "net"           # the 16-wide model axis
    assert rl.link_of(range(0, 256, 16)) == "net"   # the data axis


def test_collective_bytes_keys():
    recs = [{"kind": "all-reduce", "result_bytes": 100, "wire_bytes": 150.0,
             "link": "net"},
            {"kind": "all-gather", "result_bytes": 64, "wire_bytes": 56.0,
             "link": "nvlink"},
            {"kind": "all-reduce", "result_bytes": 4, "wire_bytes": 6.0,
             "link": "net"}]
    got = rl.collective_bytes(recs)
    assert got["wire_bytes"] == 212.0
    assert got["per_kind_wire"] == {"all-reduce": 156.0, "all-gather": 56.0}
    assert got["per_kind_result_bytes"] == {"all-reduce": 104, "all-gather": 64}
    assert got["per_kind_count"] == {"all-reduce": 2, "all-gather": 1}
    assert got["wire_by_link"] == {"net": 156.0, "nvlink": 56.0}
