"""The port's compressor registry, conventional stage and per-field bounds
against the JAX package's:

* registry rules: unknown names and kinds are errors, entries that share a
  kind must share its decode entry points;
* ``ConvStage`` plans and counts (``ConvStats``) as the reference does on a
  mixed snapshot (two shapes, one field with its own ``ErrorBound``), with
  byte-identical archives, and ``decompress_many`` decodes them as the
  reference does.

``NeurLZ(compressor="szlike-lorenzo")`` end to end against the reference:
``test_torch_e2e.py``.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.compressors import registry as ref_registry
from repro.core import bounds as ref_bounds
from repro.core import conv_stage as ref_stage
from repro.data import fields as ref_fields
from repro_torch import compressors
from repro_torch.compressors import registry
from repro_torch.core import bounds, conv_stage

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)


def test_registry_names_and_errors():
    assert registry.names() == ref_registry.names()
    # interp stacks a group as the reference's does
    assert registry.get("szlike").batchable == ref_registry.get("szlike").batchable
    assert registry.get("szlike").batch_supports(np.float32)
    assert registry.get("szlike-lorenzo").batch_supports(np.float64)
    with pytest.raises(ValueError, match="unknown compressor"):
        compressors.compress(np.zeros((4, 4), np.float32), 1e-3,
                             compressor="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown compressor"):
        conv_stage.ConvStage("nope", 1e-3, device="cpu")
    with pytest.raises(ValueError, match="unknown compressor"):
        repro_torch.NeurLZ(compressor="nope", device="cpu")
    for arc in ({"kind": "mystery"}, {}):
        with pytest.raises(ValueError, match="unknown archive kind"):
            compressors.archive_nbytes(arc)
    with pytest.raises(ValueError, match="unknown archive kind"):
        compressors.decompress({"kind": "mystery"}, device="cpu")


def test_registry_kind_ownership(monkeypatch):
    monkeypatch.setattr(registry, "_COMPRESSORS", dict(registry._COMPRESSORS))
    monkeypatch.setattr(registry, "_KINDS", dict(registry._KINDS))
    sz = registry.get("szlike")
    with pytest.raises(ValueError, match="already registered"):
        registry.register(sz)
    rogue = registry.CompressorEntry(
        name="rogue", kind="szlike", compress=sz.compress,
        decompress=lambda arc, device=None: None,
        archive_nbytes=sz.archive_nbytes)
    with pytest.raises(ValueError, match="owned by 'szlike'"):
        registry.register(rogue)
    # Sharing every decode entry point is fine; the first entry keeps the kind.
    twin = registry.register(registry.CompressorEntry(
        name="twin", kind="szlike", compress=sz.compress,
        decompress=sz.decompress, archive_nbytes=sz.archive_nbytes,
        decompress_batched=sz.decompress_batched, decode_key=sz.decode_key))
    assert registry.for_archive({"kind": "szlike"}) is sz
    # The kind passes to an entry that shares it when its owner leaves.
    registry.unregister("szlike")
    registry.unregister("szlike-lorenzo")
    assert registry.for_archive({"kind": "szlike"}) is twin


SHAPE = (9, 20, 24)


def _mixed_snapshot():
    """Two shapes (3-D and 2-D); field ``c`` carries its own bound.  The
    groups' shapes are those of ``test_torch_e2e`` and ``test_torch_lorenzo``
    (a stacked 3-field group, one 3-D and one 2-D field), so that the
    reference's eager ops compile once for all three files."""
    big = ref_fields.make_fields("hurricane", SHAPE, seed=2)
    other = ref_fields.make_fields("hurricane", SHAPE, seed=3)
    fields = {"a": big["cloud"], "b": big["precip"], "c": other["w"],
              "d": big["w"], "e": other["cloud"][4]}
    return fields, {"c": (0.05, "relaxed")}


GROUPS = {"abd": ("a", "b", "d"), "c": ("c",), "e": ("e",)}   # the plan's
STAT_KEYS = ("fields", "groups", "batched_fields", "fallback_fields", "calls")


def _resolve(pkg_bounds, names, own):
    return pkg_bounds.resolve_bounds(
        list(names), {n: pkg_bounds.ErrorBound(abs=a, mode=m)
                      for n, (a, m) in own.items() if n in names}, 1e-3)


def _reference_group(compressor, part):
    """The reference's stage run on one group of the plan alone (its
    archives and reconstructions, and its stats): groups are compressed
    independently, so these are the entries of a run over the whole
    snapshot, and its stats add up to that run's.  Each group compiles the
    reference's eager ops at its own shape, in a case of its own."""
    fields, own = _mixed_snapshot()
    sub = {n: fields[n] for n in GROUPS[part]}
    ref = ref_stage.ConvStage(compressor, 1e-3, bounds=_resolve(ref_bounds, sub, own),
                              lowering="eager")
    return ref.run(sub), ref.stats.as_dict()


@pytest.mark.parametrize("part", list(GROUPS) + ["whole"])
@pytest.mark.parametrize("compressor", ["szlike", "szlike-lorenzo", "zfplike"])
def test_stage_plans_counts_and_archives_as_reference(compressor, part):
    """Each group of the plan against the reference's run of it: archives
    and reconstructions byte-identical, the same stats.  Then the whole
    snapshot in one run: the same plan as the reference's, the groups'
    entries and summed stats, and ``decompress_many`` of the whole decoding
    as the reference's does."""
    fields, own = _mixed_snapshot()
    if part != "whole":
        sub = {n: fields[n] for n in GROUPS[part]}
        port = conv_stage.ConvStage(compressor, 1e-3,
                                    bounds=_resolve(bounds, sub, own), device="cpu")
        got = port.run(sub)
        want, want_stats = _reference_group(compressor, part)
        for key in STAT_KEYS:
            assert port.stats.as_dict()[key] == want_stats[key], key
        for name in sub:
            (arc, rec), (ref_arc, ref_rec) = got[name], want[name]
            assert repro.core.archive.dumps(arc) == repro.core.archive.dumps(ref_arc)
            assert rec.tobytes() == ref_rec.tobytes()
        return

    # The whole snapshot in one run: the plan, the stats summed over the
    # groups and each group's entries, against the port's runs of the
    # groups alone, which the cases above hold against the reference's
    # (so this case compiles the reference's decode alone).
    ref_res, port_res = _resolve(ref_bounds, fields, own), _resolve(bounds, fields, own)
    assert ({n: (b.rel, b.abs, b.mode) for n, b in port_res.items()}
            == {n: (b.rel, b.abs, b.mode) for n, b in ref_res.items()})
    ref = ref_stage.ConvStage(compressor, 1e-3, bounds=ref_res, lowering="eager")
    port = conv_stage.ConvStage(compressor, 1e-3, bounds=port_res, device="cpu")
    metas = {n: (x.shape, x.dtype) for n, x in fields.items()}
    assert port.plan(metas) == ref.plan(metas) == [list(g) for g in GROUPS.values()]
    got = port.run(fields)
    groups = []
    for names in GROUPS.values():
        sub = {n: fields[n] for n in names}
        alone = conv_stage.ConvStage(compressor, 1e-3, bounds=_resolve(bounds, sub, own),
                                     device="cpu")
        groups.append((alone.run(sub), alone.stats.as_dict()))
    want = {n: v for out, _ in groups for n, v in out.items()}
    skip = ("conv_s", "lowered_calls", "lowering")
    assert (port.stats.as_dict().keys()
            == {k for k in ref.stats.as_dict() if k not in skip} | {"conv_s"})
    for key in STAT_KEYS:
        assert port.stats.as_dict()[key] == sum(st[key] for _, st in groups), key
    assert port.stats.batched_fields == 3 and port.stats.calls == 3
    assert got["c"][0]["abs_eb"] == 0.05
    for name in fields:
        (arc, rec), (ref_arc, ref_rec) = got[name], want[name]
        assert repro.core.archive.dumps(arc) == repro.core.archive.dumps(ref_arc)
        assert rec.tobytes() == ref_rec.tobytes()

    ref_stats, port_stats = ref_registry.DecodeStats(), registry.DecodeStats()
    arcs = {n: arc for n, (arc, _) in got.items()}
    ref_dec = ref_registry.decompress_many(arcs, stats=ref_stats)
    dec = compressors.decompress_many(arcs, stats=port_stats, device="cpu")
    assert port_stats.as_dict() == ref_stats.as_dict()
    for name in fields:
        assert dec[name].tobytes() == ref_dec[name].tobytes() == got[name][1].tobytes()


def test_bounds_per_field_through_the_session():
    """``bounds=`` per field: each entry records its own bound and mode and
    decodes within it; the conventional archives equal the reference's."""
    fields, _ = _mixed_snapshot()
    sub = {n: fields[n] for n in ("a", "b", "c")}
    spec = {"c": repro_torch.ErrorBound(abs=0.05, mode="relaxed"),
            "b": 2e-3}
    arc = repro_torch.NeurLZ(compressor="zfplike", epochs=1,
                             device="cpu").compress(sub, spec, rel_eb=1e-3)
    ref_conv = ref_stage.ConvStage(
        "zfplike", 1e-3, bounds=ref_bounds.resolve_bounds(
            list(sub), {"c": ref_bounds.ErrorBound(abs=0.05, mode="relaxed"),
                        "b": 2e-3}, 1e-3)).run(sub)
    dec = arc.decode_all()
    for name, x in sub.items():
        e = arc["fields"][name]
        assert repro.core.archive.dumps(e["conv"]) == repro.core.archive.dumps(
            ref_conv[name][0])
        assert e["abs_eb"] == ref_conv[name][0]["abs_eb"]
        assert e["mode"] == ("relaxed" if name == "c" else "strict")
        limit = (2.0 if name == "c" else 1.0) * e["abs_eb"]
        assert np.abs(dec[name].astype(np.float64) - x).max() <= limit
    assert "outliers" not in arc["fields"]["c"]
    assert arc["timing"]["conv_stage"]["groups"] == 3
