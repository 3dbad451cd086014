"""The port's main path as a whole against the JAX package's serial engine:
compress a small Hurricane snapshot with the reference's initial weights and
batch order carried across, then decode; the same for the ``szlike-lorenzo``
path, whose conventional stage is one batched group.  Both reference runs
sit in this module so that one process compiles the reference's trainer
once for both.

* conventional payloads byte-identical;
* strict archives hold the 1× bound, relaxed ones 2×;
* PSNR and bit rate within a stated tolerance of the reference's;
* the port's decode equals its encoder's final field bit for bit;
* archive files cross-open: the JAX package reads the port's and decodes its
  conventional payloads to the same bytes, and the reverse;
* the reference's entries streamed into an ``NLZSTRM2`` container by the
  reference's appender open lazily in the port and decode as above;
* the paper's direct-learning ablation (``learn_residual=False``) against
  the reference's serial engine with the same tolerances.
"""
import io

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.compressors import szlike as ref_sz
from repro.core import archive as ref_archive
from repro.core import neurlz as ref_neurlz
from repro.core import online_trainer as ref_trainer
from repro.core import skipping_dnn as ref_dnn
from repro.data import fields as ref_fields
from repro_torch import compressors
from repro_torch.compressors import szlike as port_sz
from repro_torch.compressors import zfplike as port_zfp
from repro_torch import streaming
from repro_torch.core import archive as arc_io
from repro_torch.core import conv_stage, metrics, neurlz, online_trainer
from repro_torch.core import skipping_dnn as port_dnn

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)      # the shape of test_torch_szlike: one JAX compile
EPOCHS, SEED, REL_EB = 2, 0, 1e-3
FIELDS = ref_fields.make_fields("hurricane", SHAPE, seed=1)


def _carried_across(fields):
    """The reference's initial weights and batch indices, per field."""
    n = SHAPE[0]
    batch = min(10, n)
    steps = max(1, n // batch)
    key = jax.random.PRNGKey(SEED)
    params = jax.tree.map(np.asarray, ref_dnn.init_params(
        key, ref_dnn.SkippingDNNConfig(c_in=1)))
    sched = np.stack([np.asarray(ref_trainer.epoch_batches(
        jax.random.fold_in(key, e), n, steps, batch)) for e in range(EPOCHS)])
    return ({name: params for name in fields},
            {name: sched for name in fields})


def _max_err(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.fixture(scope="module")
def ref_main():
    """The reference's serial archive of the main path and its decode."""
    ref_arc = repro.NeurLZ(engine="serial", lowering="eager", conv_batch=False,
                           epochs=EPOCHS, seed=SEED).compress(FIELDS,
                                                              rel_eb=REL_EB)
    return ref_arc, ref_arc.decode_all()


def test_main_path_matches_reference(tmp_path, ref_main):
    ref_arc, ref_dec = ref_main
    init, sched = _carried_across(FIELDS)
    sess = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu")
    arc = sess.compress(FIELDS, rel_eb=REL_EB, init_params=init,
                        batch_schedules=sched)
    dec = arc.decode_all()
    cfg = sess.config
    for name, x in FIELDS.items():
        e, re_ = arc["fields"][name], ref_arc["fields"][name]
        for key in ("codes", "unpred", "literals"):
            assert e["conv"][key]["payload"] == re_["conv"][key]["payload"]
        assert e["abs_eb"] == re_["abs_eb"] and e["stats"] == re_["stats"]
        eb = e["abs_eb"]
        assert _max_err(dec[name], x) <= eb

        # Same weights, same batches, float32 sums in another order: the
        # loss curves agree to 1e-4, quality to 0.05 dB, and the bit rate
        # to 2% (the outlier count can move by a few points at the bound).
        np.testing.assert_allclose(e["loss_history"], re_["loss_history"],
                                   rtol=1e-4)
        assert abs(metrics.psnr(x, dec[name])
                   - metrics.psnr(x, ref_dec[name])) <= 0.05
        assert arc.bitrate(name)["bitrate"] == pytest.approx(
            ref_arc.bitrate(name)["bitrate"], rel=0.02)

        # The engine's own encoder helpers, run again from the archived
        # weights: decode reproduces the encoder's final field bit for bit.
        rec = port_sz.decompress(e["conv"], device="cpu")
        model = neurlz.decode_entry_net(e, "cpu")
        inputs, _, _ = online_trainer.make_dataset(rec, x, eb)
        resid = online_trainer.predict_residual(model, inputs)
        final, mask = neurlz.enhance_and_mask(x, rec, resid, eb, cfg)
        assert final.numpy().tobytes() == dec[name].tobytes()
        assert int(mask.sum()) == e["outliers"]["count"]

    # Files cross-open both ways.
    port_path, ref_path = tmp_path / "port.nlz", tmp_path / "ref.nlz"
    arc.save(port_path)
    ref_arc.save(ref_path)
    seen_by_ref = repro.Archive.open(port_path)
    seen_by_port = repro_torch.Archive.open(ref_path, device="cpu")
    port_on_ref = seen_by_port.decode_all()
    for name in FIELDS:
        conv = seen_by_ref["fields"][name]["conv"]
        assert (ref_sz.decompress(conv).tobytes()
                == port_sz.decompress(arc["fields"][name]["conv"],
                                     device="cpu").tobytes())
        # The port decoding the reference's weights: float32 tolerance.
        eb = ref_arc["fields"][name]["abs_eb"]
        assert _max_err(port_on_ref[name], ref_dec[name]) <= 1e-3 * eb


def test_direct_learning_matches_reference():
    """``learn_residual=False``: the network learns the original normalized
    by the decompressed field's stats (paper Fig. 4, "non-residual").  The
    reference's trainer compile is the main path's (same shapes)."""
    ref_arc = repro.NeurLZ(engine="serial", lowering="eager", conv_batch=False,
                           epochs=EPOCHS, seed=SEED,
                           learn_residual=False).compress(FIELDS, rel_eb=REL_EB)
    ref_dec = ref_arc.decode_all()
    init, sched = _carried_across(FIELDS)
    sess = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, learn_residual=False,
                              device="cpu")
    arc = sess.compress(FIELDS, rel_eb=REL_EB, init_params=init,
                        batch_schedules=sched)
    dec = arc.decode_all()
    for name, x in FIELDS.items():
        e, re_ = arc["fields"][name], ref_arc["fields"][name]
        assert e["learn_residual"] is False and re_["learn_residual"] is False
        for key in ("codes", "unpred", "literals"):
            assert e["conv"][key]["payload"] == re_["conv"][key]["payload"]
        assert e["abs_eb"] == re_["abs_eb"] and e["stats"] == re_["stats"]
        eb = e["abs_eb"]
        assert _max_err(dec[name], x) <= eb            # strict 1x
        # The main path's tolerances: losses to 1e-4, quality to 0.05 dB.
        np.testing.assert_allclose(e["loss_history"], re_["loss_history"],
                                   rtol=1e-4)
        assert abs(metrics.psnr(x, dec[name])
                   - metrics.psnr(x, ref_dec[name])) <= 0.05
        # Decode reproduces the encoder's final field bit for bit.
        rec = port_sz.decompress(e["conv"], device="cpu")
        inputs, _, stats = neurlz.build_dataset(x, rec, eb, [], sess.config)
        resid = online_trainer.predict_residual(
            neurlz.decode_entry_net(e, "cpu"), inputs)
        final, mask = neurlz.enhance_and_mask(x, rec, resid, eb, sess.config,
                                              stats)
        assert final.numpy().tobytes() == dec[name].tobytes()
        assert int(mask.sum()) == e["outliers"]["count"]


def test_reference_container_opens_lazily_in_the_port(tmp_path, ref_main):
    ref_arc, ref_dec = ref_main
    path = tmp_path / "ref.nlzs"
    meta = {"field_order": list(FIELDS),
            "shapes": {n: list(x.shape) for n, x in FIELDS.items()},
            "slice_axis": 0, "compressor": "szlike",
            "timing": ref_arc["timing"]}
    app = ref_archive.ArchiveAppender(str(path), durability="fsync",
                                      prelude={"field_order": list(FIELDS)})
    for name in FIELDS:
        app.add_entry(name, ref_arc["fields"][name])
    app.finalize(meta)

    with repro_torch.open(path, device="cpu") as arc:
        assert arc.streaming and arc.reader.entry_reads == []
        dec = arc.decode_all()
        with ref_archive.ArchiveReader(str(path)) as r:
            want = ref_archive.dumps(ref_neurlz.assemble_streaming_archive(r))
        assert ref_archive.dumps(arc.to_dict()) == want
        assert arc.verify()["ok"]
    for name in FIELDS:
        # The port decoding the reference's weights: float32 tolerance.
        eb = ref_arc["fields"][name]["abs_eb"]
        assert _max_err(dec[name], ref_dec[name]) <= 1e-3 * eb


def test_lorenzo_path_matches_reference():
    ref_arc = repro.NeurLZ(engine="serial", lowering="eager",
                           compressor="szlike-lorenzo", epochs=EPOCHS,
                           seed=SEED).compress(FIELDS, rel_eb=REL_EB)
    init, sched = _carried_across(FIELDS)
    arc = repro_torch.NeurLZ(compressor="szlike-lorenzo", epochs=EPOCHS,
                             seed=SEED, device="cpu").compress(
        FIELDS, rel_eb=REL_EB, init_params=init, batch_schedules=sched)
    stats = arc["timing"]["conv_stage"]
    assert (stats["groups"], stats["calls"], stats["batched_fields"]) == (1, 1, 3)
    dec, ref_dec = arc.decode_all(), ref_arc.decode_all()
    for name, x in FIELDS.items():
        e, re_ = arc["fields"][name], ref_arc["fields"][name]
        assert e["conv"]["predictor"] == "lorenzo"
        assert repro.core.archive.dumps(e["conv"]) == repro.core.archive.dumps(
            re_["conv"])
        assert e["abs_eb"] == re_["abs_eb"] and e["stats"] == re_["stats"]
        assert _max_err(dec[name], x) <= e["abs_eb"]
        # Same weights and batches, float32 sums in another order: the
        # tolerances of the main path (losses to 1e-4, 0.05 dB, 2% of the
        # bit rate).
        np.testing.assert_allclose(e["loss_history"], re_["loss_history"],
                                   rtol=1e-4)
        assert abs(metrics.psnr(x, dec[name])
                   - metrics.psnr(x, ref_dec[name])) <= 0.05
        assert arc.bitrate(name)["bitrate"] == pytest.approx(
            ref_arc.bitrate(name)["bitrate"], rel=0.02)
        assert np.array_equal(arc.decode(name), dec[name])


@pytest.mark.parametrize("mode,factor", [("relaxed", 2.0), ("unregulated", None)])
def test_other_modes_decode_within_their_bound(mode, factor):
    sub = {k: FIELDS[k] for k in ("cloud", "w")}
    arc = repro_torch.NeurLZ(epochs=1, mode=mode, device="cpu",
                             cross_field={"cloud": ("w",)}).compress(
                                 sub, rel_eb=REL_EB)
    assert arc["fields"]["cloud"]["net"]["c_in"] == 2
    dec = arc.decode_all()
    for name, x in sub.items():
        assert "outliers" not in arc["fields"][name]
        if factor is not None:
            assert _max_err(dec[name], x) <= factor * arc["fields"][name]["abs_eb"]
    assert np.array_equal(arc.decode("cloud"), dec["cloud"])


@pytest.mark.parametrize("kwargs", [
    {"engine": "streaming"},
    {"engine": "streaming", "max_resident_bytes": 10 ** 6},
    {"learn_residual": False},
])
def test_unported_settings_name_their_roadmap_item(kwargs):
    """The settings that once raised, naming the item that would port them,
    now run: each compresses and decodes within its bound."""
    sub = {k: FIELDS[k] for k in ("cloud", "w")}
    arc = repro_torch.NeurLZ(epochs=1, device="cpu", **kwargs).compress(
        sub, rel_eb=REL_EB)
    dec = arc.decode_all()
    for name, x in sub.items():
        e = arc["fields"][name]
        assert e["learn_residual"] is kwargs.get("learn_residual", True)
        assert _max_err(dec[name], x) <= e["abs_eb"]
    if "max_resident_bytes" in kwargs:
        assert arc["timing"]["peak_resident_bytes"] <= 10 ** 6


@pytest.mark.parametrize("kwargs", [{"engine": "batched"},
                                    {"engine": "batched", "group_size": 4}])
def test_batched_settings_give_the_serial_bytes(kwargs):
    """The batched engine's settings are accepted; its default strategy
    gives the serial engine's entries."""
    sub = {k: FIELDS[k] for k in ("cloud", "w")}
    want = repro_torch.NeurLZ(epochs=1, device="cpu").compress(sub, rel_eb=REL_EB)
    got = repro_torch.NeurLZ(epochs=1, device="cpu", **kwargs).compress(
        sub, rel_eb=REL_EB)
    assert arc_io.dumps(got["fields"]) == arc_io.dumps(want["fields"])


def test_make_fields_is_the_reference_generator():
    from repro_torch.data import fields as port_fields
    got = port_fields.make_fields("hurricane", (6, 10, 12), seed=4)
    want = ref_fields.make_fields("hurricane", (6, 10, 12), seed=4)
    assert list(got) == list(want)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes()


@pytest.fixture(scope="module")
def tiny_arc(tmp_path_factory):
    """A one-field archive, saved whole and as an ``NLZSTRM2`` container."""
    x = FIELDS["w"][:4]
    arc = neurlz.compress_impl({"w": x}, REL_EB, device="cpu",
                               config=neurlz.NeurLZConfig(epochs=1))
    d = tmp_path_factory.mktemp("tiny")
    arc_io.save(str(d / "w.nlz"), arc)
    app = arc_io.ArchiveAppender(str(d / "w.nlzs"))
    app.add_entry("w", arc["fields"]["w"])
    app.finalize({"field_order": ["w"], "shapes": {"w": list(x.shape)},
                  "slice_axis": 0, "compressor": "szlike"})
    return x, arc, {"whole": d / "w.nlz", "container": d / "w.nlzs"}


def test_missing_gpu_is_an_error(monkeypatch, tiny_arc):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.NeurLZ()
    for path in tiny_arc[2].values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.open(path)


# Every layer's entry point defaults to the card: without one it raises
# instead of running on the CPU.
DEFAULT_CUDA_CALLS = {
    "compressors.compress": lambda x, arc, files: compressors.compress(x, REL_EB),
    "compressors.decompress":
        lambda x, arc, files: compressors.decompress(arc["fields"]["w"]["conv"]),
    "szlike.compress": lambda x, arc, files: port_sz.compress(x, REL_EB),
    "szlike.decompress":
        lambda x, arc, files: port_sz.decompress(arc["fields"]["w"]["conv"]),
    "szlike.compress_batched": lambda x, arc, files: port_sz.compress_batched(
        [x, x], REL_EB, config=port_sz.SZLikeConfig(predictor="lorenzo")),
    "zfplike.compress": lambda x, arc, files: port_zfp.compress(x, REL_EB),
    "compressors.decompress_many": lambda x, arc, files: compressors.decompress_many(
        {"w": arc["fields"]["w"]["conv"]}),
    "ConvStage": lambda x, arc, files: conv_stage.ConvStage("szlike-lorenzo", REL_EB),
    "neurlz.compress_impl": lambda x, arc, files: neurlz.compress_impl(
        {"w": x}, REL_EB, config=neurlz.NeurLZConfig(epochs=1)),
    "neurlz.decompress": lambda x, arc, files: neurlz.decompress(arc),
    "neurlz.decode_field_entry":
        lambda x, arc, files: neurlz.decode_field_entry(arc["fields"]["w"], x, [], 0),
    "SkippingDNN": lambda x, arc, files: port_dnn.SkippingDNN(port_dnn.SkippingDNNConfig()),
    "Archive.from_dict": lambda x, arc, files: repro_torch.Archive.from_dict(arc),
    "Archive.open(container)":
        lambda x, arc, files: repro_torch.Archive.open(files["container"]),
    "repro_torch.open": lambda x, arc, files: repro_torch.open(files["whole"]),
    "streaming.compress": lambda x, arc, files: streaming.compress(
        {"w": x}, io.BytesIO(), REL_EB),
    "streaming.iter_decompress":
        lambda x, arc, files: next(streaming.iter_decompress(files["container"])),
    "NeurLZ.compress_to": lambda x, arc, files: repro_torch.NeurLZ(
        epochs=1).compress_to({"w": x}, io.BytesIO(), rel_eb=REL_EB),
    "PipelineScheduler.run": lambda x, arc, files: streaming.PipelineScheduler(
        neurlz.NeurLZConfig(epochs=1)).run({"w": x}, io.BytesIO(), REL_EB),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_CUDA_CALLS))
def test_entry_points_default_to_cuda(monkeypatch, tiny_arc, name):
    x, arc, files = tiny_arc
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_CUDA_CALLS[name](x, arc, files)
