"""The port's batched engine (``engine="batched"``) against the JAX
package's and against the port's own serial engine, at the port's test
shapes (9×20×24 fields, the stacked 3×9×20×24 group), 2 epochs:

* group planning and strategy choice equal the reference's on the same
  metadata;
* the plain grouped conv and its gradients equal ``jax.vmap`` of the
  reference's conv (its Pallas kernel in interpret mode; the gradient of its
  oracle, as Pallas has none);
* the stacked interp walk gives the payloads of one ``compress`` per field
  and of the reference's ``compress_batched``;
* ``unroll`` and ``auto`` archives equal the serial engine's byte for byte
  (ragged groups, cross-field aux, an injected fault, group sizes 0/1/2);
* ``vmap`` holds the bound, and its per-epoch losses follow the reference's
  ``_epoch_vmapped`` from the same initial weights and batches;
* the batched decode equals the serial decode byte for byte;
* strict mode holds its bound with weights archived below float32.

The reference's stacked epoch is compiled once, by one test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.compressors import szlike as ref_sz
from repro.core import batched_engine as ref_be
from repro.core import neurlz as ref_neurlz
from repro.core import online_trainer as ref_trainer
from repro.core import skipping_dnn as ref_dnn
from repro.data import fields as ref_fields
from repro.kernels import conv2d3x3 as pallas_conv
from repro.kernels import ref as kernel_ref
from repro.optim import adamw_init
from repro_torch.compressors import szlike as port_sz
from repro_torch.core import archive as arc_io
from repro_torch.core import batched_engine as port_be
from repro_torch.core import neurlz, online_trainer
from repro_torch.core import skipping_dnn as port_dnn
from repro_torch.kernels import conv2d3x3 as port_conv

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

SHAPE = (9, 20, 24)
EPOCHS, SEED, REL_EB = 2, 0, 1e-3
FIELDS = ref_fields.make_fields("hurricane", SHAPE, seed=1)
# A ragged group: precip has 7 slices beside the others' 9.
RAGGED = {**FIELDS, "precip": FIELDS["precip"][:7]}


def _max_err(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


# ---- planning ---------------------------------------------------------------

PLAN_SHAPES = {"a": (9, 20, 24), "b": (9, 20, 24), "c": (7, 20, 24),
               "d": (9, 16, 24), "e": (9, 20, 24)}


@pytest.mark.parametrize("slice_axis", [0, 2])
@pytest.mark.parametrize("with_modes", [False, True])
@pytest.mark.parametrize("group_size", [0, 1, 2])
def test_plan_groups_match_reference(group_size, with_modes, slice_axis):
    c_ins = {"a": 1, "b": 1, "c": 1, "d": 1, "e": 2}
    modes = ({"a": "strict", "b": "relaxed", "c": "strict", "d": "strict",
              "e": "strict"} if with_modes else None)
    ref_cfg = ref_neurlz.NeurLZConfig(group_size=group_size,
                                      slice_axis=slice_axis)
    cfg = neurlz.NeurLZConfig(group_size=group_size, slice_axis=slice_axis)
    want = ref_be.plan_groups_from_meta(PLAN_SHAPES, c_ins, ref_cfg, modes)
    got = port_be.plan_groups_from_meta(PLAN_SHAPES, c_ins, cfg, modes)
    assert [dataclass_tuple(g) for g in got] == [dataclass_tuple(g) for g in want]
    for shape in PLAN_SHAPES.values():
        assert (port_be.sliced_shape(shape, slice_axis)
                == ref_be.sliced_shape(shape, slice_axis))
    # From the arrays, with a cross-field aux channel.
    arrays = {n: np.zeros(s, np.float32) for n, s in PLAN_SHAPES.items()}
    cross = {"e": ("a",)}
    want = ref_be.plan_groups(arrays, ref_neurlz.NeurLZConfig(
        group_size=group_size, slice_axis=slice_axis, cross_field=cross), modes)
    got = port_be.plan_groups(arrays, neurlz.NeurLZConfig(
        group_size=group_size, slice_axis=slice_axis, cross_field=cross), modes)
    assert [dataclass_tuple(g) for g in got] == [dataclass_tuple(g) for g in want]


def dataclass_tuple(g):
    return (list(g.names), tuple(g.slice_hw), g.c_in, g.mode)


@pytest.mark.parametrize("strategy", ["auto", "unroll", "vmap"])
@pytest.mark.parametrize("counts", [[9], [9, 9], [9, 7, 9], [5, 5, 5]])
def test_resolve_batching_matches_reference(strategy, counts):
    assert (port_be.resolve_batching(strategy, counts)
            == ref_be.resolve_batching(strategy, counts))


def test_unknown_field_batching_is_an_error():
    with pytest.raises(ValueError, match="field_batching"):
        repro_torch.NeurLZ(device="cpu", engine="batched",
                           field_batching="scan")


# ---- the grouped conv against jax.vmap of the reference's ------------------

@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("h,w,cin,cout,stride", [(17, 13, 4, 6, 2),
                                                 (16, 12, 1, 4, 1),
                                                 (9, 7, 8, 1, 1)])
def test_grouped_conv_matches_vmapped_reference(h, w, cin, cout, stride, relu):
    nf, n = 3, 2
    rng = np.random.default_rng([h, w, cin, cout, stride])
    x = rng.standard_normal((nf, n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((nf, 3, 3, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((nf, cout)) * 0.1).astype(np.float32)
    ho, wo = port_conv.same_pads(h, stride)[0], port_conv.same_pads(w, stride)[0]
    g = rng.standard_normal((nf, n, ho, wo, cout)).astype(np.float32)

    pallas = np.asarray(jax.vmap(lambda a, c, d: pallas_conv.conv2d3x3(
        a, c, d, stride=stride, relu=relu, interpret=True))(x, wt, b))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x.reshape(nf * n, h, w, cin), wt, b)]
    y = port_conv.conv3x3_grouped(*leaves, stride=stride, relu=relu)
    # float32 sums of at most 9*Cin=72 terms in another order.
    np.testing.assert_allclose(y.detach().numpy().reshape(pallas.shape),
                               pallas, rtol=1e-5, atol=1e-5)

    # Gradients: jax.vmap of the gradient of the reference's oracle (the
    # Pallas kernel has no autodiff rule) at the same output gradient.
    def loss(a, c, d, gg):
        return jnp.sum(kernel_ref.conv2d3x3_ref(a, c, d, stride=stride,
                                                relu=relu) * gg)
    want = jax.vmap(jax.grad(loss, argnums=(0, 1, 2)))(x, wt, b, g)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g.reshape(y.shape)))
    # dx sums <= 9*Cout terms; dw and db sum N*Ho*Wo <= 442 terms: float32
    # in another order, within 1e-4 of the largest gradient.
    for a, e in zip(got, want):
        e = np.asarray(e).reshape(a.shape)
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-5,
                                   atol=1e-4 * max(1.0, float(np.abs(e).max())))


def test_grouped_plain_is_single_field_plain_stacked():
    gen = torch.Generator().manual_seed(3)
    nf, n = 3, 2
    x = torch.randn((nf * n, 17, 13, 4), generator=gen)
    wt = torch.randn((nf, 3, 3, 4, 6), generator=gen) * 0.3
    b = torch.randn((nf, 6), generator=gen) * 0.1
    before = (port_conv.grouped_launches, port_conv.grouped_bwd_launches)
    y = port_conv.conv2d3x3_grouped(x, wt, b, stride=2)
    g = torch.randn(tuple(y.shape), generator=gen)
    dx, dw, db = port_conv.conv2d3x3_bwd_grouped(g, y, x, wt, stride=2)
    for f in range(nf):
        s = slice(f * n, (f + 1) * n)
        assert torch.equal(y[s], port_conv.conv2d3x3(x[s], wt[f], b[f], stride=2))
        one = port_conv.conv2d3x3_bwd(g[s], y[s], x[s], wt[f], stride=2)
        assert torch.equal(dx[s], one[0]) and torch.equal(dw[f], one[1])
        assert torch.equal(db[f], one[2])
    # CPU tensors take the plain versions and count no launch.
    assert (port_conv.grouped_launches,
            port_conv.grouped_bwd_launches) == before


def test_stacked_forward_is_per_field_forward():
    gen = torch.Generator().manual_seed(4)
    cfg = port_dnn.SkippingDNNConfig(c_in=1)
    trees = [port_dnn.init_params(cfg, gen) for _ in range(3)]
    x = torch.randn((3, 2, 20, 24, 1), generator=gen)
    st = port_dnn.stack_params(trees)
    out = port_dnn.forward_stacked(st, x)
    assert out.shape == (3, 2, 20, 24, 1)
    for f, tree in enumerate(port_dnn.unstack_params(st, 3)):
        assert all(torch.equal(tree[k]["w"], trees[f][k]["w"]) for k in tree)
        # Each field's sums in the single-field order: the same bytes.
        assert torch.equal(out[f], port_dnn.forward(trees[f], x[f]))


# ---- the stacked interp walk ---------------------------------------------

@pytest.mark.parametrize("abs_eb", [None, 0.05])
def test_stacked_interp_payloads_match_per_field_and_reference(abs_eb):
    xs = list(FIELDS.values())
    got = port_sz.compress_batched(xs, REL_EB, abs_eb=abs_eb, device="cpu")
    want = ref_sz.compress_batched(xs, REL_EB, abs_eb=abs_eb)
    for x, (arc, rec), (ref_arc, ref_rec) in zip(xs, got, want):
        one_arc, one_rec = port_sz.compress(x, REL_EB, abs_eb=abs_eb,
                                            device="cpu")
        assert arc_io.dumps(arc) == arc_io.dumps(one_arc)
        assert rec.tobytes() == one_rec.tobytes() == np.asarray(ref_rec).tobytes()
        for key in ("codes", "unpred", "literals"):
            assert arc[key]["payload"] == ref_arc[key]["payload"]
        assert arc["abs_eb"] == ref_arc["abs_eb"] and arc["mean"] == ref_arc["mean"]
    decoded = port_sz.decompress_batched([a for a, _ in got], device="cpu")
    for (arc, rec), dec in zip(got, decoded):
        assert dec.tobytes() == rec.tobytes()
        assert dec.tobytes() == port_sz.decompress(arc, device="cpu").tobytes()


def test_main_path_conventional_stage_is_one_stacked_group():
    arc = repro_torch.NeurLZ(epochs=1, device="cpu").compress(FIELDS,
                                                              rel_eb=REL_EB)
    stats = arc["timing"]["conv_stage"]
    assert (stats["groups"], stats["calls"], stats["batched_fields"]) == (1, 1, 3)


# ---- archives against the serial engine ----------------------------------

def _faults():
    return repro_torch.FaultConfig(
        injector=repro_torch.FaultInjector({"train.precip": 0}))


CASES = {
    "equal": (FIELDS, {}),
    "ragged": (RAGGED, {}),
    "cross_field": (FIELDS, {"cross_field": {"cloud": ("w",)}}),
    "fault": (FIELDS, {"faults": _faults}),
}


def _kwargs(case):
    return {k: (v() if callable(v) else v) for k, v in CASES[case][1].items()}


_serial_cache: dict = {}


def _serial(case):
    """The port's serial archive of a case, compressed once per process."""
    if case not in _serial_cache:
        fields = CASES[case][0]
        _serial_cache[case] = repro_torch.NeurLZ(
            epochs=EPOCHS, seed=SEED, device="cpu", **_kwargs(case)).compress(
                fields, rel_eb=REL_EB)
    return _serial_cache[case]


@pytest.mark.parametrize("group_size", [0, 1, 2])
@pytest.mark.parametrize("strategy", ["unroll", "auto"])
@pytest.mark.parametrize("case", list(CASES))
def test_batched_archives_equal_serial(case, strategy, group_size):
    fields = CASES[case][0]
    arc = repro_torch.NeurLZ(
        epochs=EPOCHS, seed=SEED, device="cpu", engine="batched",
        field_batching=strategy, group_size=group_size,
        **_kwargs(case)).compress(fields, rel_eb=REL_EB)
    serial = _serial(case)
    assert arc_io.dumps(arc["fields"]) == arc_io.dumps(serial["fields"])
    assert arc["bitrate"] == serial["bitrate"]
    timing = arc["timing"]
    assert timing["degraded_fields"] == serial["timing"]["degraded_fields"]
    groups = port_be.plan_groups(fields, neurlz.NeurLZConfig(
        group_size=group_size, **{k: v for k, v in _kwargs(case).items()
                                  if k == "cross_field"}))
    assert list(timing["strategies"]) == [",".join(g.names) for g in groups]
    if strategy == "unroll":
        assert set(timing["strategies"].values()) == {"unroll"}
    elif case == "ragged" and group_size != 1:
        # Ragged groups unroll under auto.
        assert timing["strategies"][",".join(groups[0].names)] == "unroll"


def test_auto_stacks_equal_groups_where_parity_holds():
    arc = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu",
                             engine="batched", group_size=0).compress(
        FIELDS, rel_eb=REL_EB)
    parity = port_be.stacked_bit_parity(port_dnn.SkippingDNNConfig(),
                                        SHAPE[1:], SHAPE[0], 3, "cpu")
    assert arc["timing"]["strategies"] == {
        "cloud,precip,w": "vmap" if parity else "unroll"}
    assert arc_io.dumps(arc["fields"]) == arc_io.dumps(_serial("equal")["fields"])


def test_batched_decode_equals_serial_decode(tmp_path):
    for case in ("equal", "fault", "cross_field"):
        serial = _serial(case)
        want = serial.decode_all()
        got = serial.decode_all(engine="batched")
        assert list(got) == list(want)
        assert all(got[n].tobytes() == want[n].tobytes() for n in want)
    # From a container too, and through a batched session.
    serial = _serial("equal")
    path = tmp_path / "snap.nlzs"
    app = arc_io.ArchiveAppender(str(path))
    for name, e in serial["fields"].items():
        app.add_entry(name, e)
    app.finalize({"field_order": list(FIELDS), "slice_axis": 0,
                  "compressor": "szlike",
                  "shapes": {n: list(x.shape) for n, x in FIELDS.items()}})
    want = serial.decode_all()
    with repro_torch.open(path, device="cpu") as opened:
        got = repro_torch.NeurLZ(device="cpu", engine="batched").decompress(opened)
    assert all(got[n].tobytes() == want[n].tobytes() for n in want)


# ---- the stacked strategy --------------------------------------------------

@pytest.mark.parametrize("case", ["equal", "ragged"])
def test_vmap_holds_the_bound_and_decodes_as_encoded(case):
    fields = CASES[case][0]
    sess = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu",
                              engine="batched", field_batching="vmap",
                              group_size=0)
    arc = sess.compress(fields, rel_eb=REL_EB)
    assert arc["timing"]["strategies"] == {"cloud,precip,w": "vmap"}
    dec = sess.decompress(arc)
    for name, x in fields.items():
        e = arc["fields"][name]
        assert _max_err(dec[name], x) <= e["abs_eb"]
        # The encoder's final field, from its own helpers: bit for bit.
        rec = port_sz.decompress(e["conv"], device="cpu")
        inputs, _, _ = online_trainer.make_dataset(rec, x, e["abs_eb"])
        resid = online_trainer.predict_residual(
            neurlz.decode_entry_net(e, "cpu"), inputs)
        final, mask = neurlz.enhance_and_mask(x, rec, resid, e["abs_eb"],
                                              sess.config)
        assert final.numpy().tobytes() == dec[name].tobytes()
        assert int(mask.sum()) == e["outliers"]["count"]
    if case == "equal":
        # Equal counts: the stacked trajectory is the serial one.
        serial = _serial("equal")
        for name in fields:
            np.testing.assert_allclose(arc["fields"][name]["loss_history"],
                                       serial["fields"][name]["loss_history"],
                                       rtol=1e-6)


@pytest.mark.parametrize("group_size", [0, 1, 2])
def test_vmap_degrades_injected_fields(group_size):
    """``train.precip`` injected under ``vmap``: ``precip`` alone degrades,
    to the serial engine's conv-only entry and reason, also where it leaves
    its group nothing to train (``group_size`` 1), and the other fields
    train stacked within the bound."""
    sess = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu",
                              engine="batched", field_batching="vmap",
                              group_size=group_size, faults=_faults())
    arc = sess.compress(FIELDS, rel_eb=REL_EB)
    serial = _serial("fault")
    assert arc["timing"]["degraded_fields"] == ["precip"]
    assert set(arc["timing"]["strategies"].values()) == {"vmap"}
    e = arc["fields"]["precip"]
    assert e["degraded"] == "injected"
    assert arc_io.dumps(e) == arc_io.dumps(serial["fields"]["precip"])
    dec = sess.decompress(arc)
    for name, x in FIELDS.items():
        assert _max_err(dec[name], x) <= arc["fields"][name]["abs_eb"]
        assert ("degraded" in arc["fields"][name]) == (name == "precip")


@pytest.mark.parametrize("case", ["equal", "ragged"])
def test_stacked_losses_match_reference_epoch_vmapped(case):
    """The reference's initial weights, Adam state and batches carried
    across: the port's ``train_stacked`` follows ``_epoch_vmapped``'s
    per-epoch losses to 1e-4 (float32 sums in another order)."""
    fields = CASES[case][0]
    datasets = []
    for name, x in fields.items():
        arc, rec = port_sz.compress(x, REL_EB, device="cpu")
        inp, tgt, _ = online_trainer.make_dataset(rec, x, arc["abs_eb"])
        datasets.append((inp, tgt))
    counts = [inp.shape[0] for inp, _ in datasets]
    n = max(counts)

    def pad(a):
        return np.pad(a, ((0, n - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))
    xs = np.stack([pad(i) for i, _ in datasets])
    ys = np.stack([pad(t) for _, t in datasets])
    batch = min(10, n)
    steps = max(1, n // batch)

    tcfg = ref_trainer.TrainConfig(epochs=EPOCHS, seed=SEED)
    key = jax.random.PRNGKey(SEED)
    init = ref_dnn.init_params(key, ref_dnn.SkippingDNNConfig(c_in=1))
    params_st = ref_dnn.stack_params([init] * 3)
    opt_st = jax.tree.map(lambda *a: jnp.stack(a), *[adamw_init(init)] * 3)
    n_valid = jnp.asarray(counts, jnp.int32)
    ref_losses, schedule = [], []
    for e in range(EPOCHS):
        ekey = jax.random.fold_in(key, e)
        schedule.append(np.asarray(ref_trainer.epoch_batches(ekey, n, steps,
                                                             batch)))
        params_st, opt_st, ml = ref_be._epoch_vmapped(
            params_st, opt_st, jnp.asarray(xs), jnp.asarray(ys), ekey,
            jnp.asarray(e * steps, jnp.int32), n_valid, steps=steps,
            batch=batch, total_steps=steps * EPOCHS, reg=True, skip=True,
            base_lr=tcfg.lr, min_lr_frac=tcfg.min_lr_frac, loss=tcfg.loss,
            lowering="eager")
        ref_losses.append(np.asarray(ml))

    tree = port_dnn.params_from_jax(jax.tree.map(np.asarray, init))
    stacked = port_dnn.stack_params([tree] * 3)
    for v in port_dnn.tree_leaves(stacked):
        v.requires_grad_()
    got = online_trainer.train_stacked(
        stacked, xs, ys, online_trainer.TrainConfig(epochs=EPOCHS, seed=SEED),
        n_valid=counts, schedule=np.stack(schedule))
    assert got.shape == (EPOCHS, 3)
    np.testing.assert_allclose(got.numpy(), np.stack(ref_losses), rtol=1e-4)


def test_stacked_bit_parity_is_cached_per_signature():
    cfg = port_dnn.SkippingDNNConfig()
    port_be._stacked_parity.clear()
    ok = port_be.stacked_bit_parity(cfg, (20, 24), 9, 2, "cpu")
    assert list(port_be._stacked_parity) == [((1, (4, 4, 6, 6, 8), True, True),
                                              (20, 24), 9, 2, "cpu")]
    assert port_be.stacked_bit_parity(cfg, (20, 24), 9, 2, "cpu") is ok
    # Other widths run other layer shapes: a signature of their own.
    wide = port_dnn.SkippingDNNConfig(widths=(4, 6, 6, 8, 8))
    port_be.stacked_bit_parity(wide, (20, 24), 9, 2, "cpu")
    assert len(port_be._stacked_parity) == 2
    assert ((1, (4, 6, 6, 8, 8), True, True), (20, 24), 9, 2, "cpu") \
        in port_be._stacked_parity


# ---- strict mode with weights archived below float32 ----------------------

@pytest.mark.parametrize("engine", ["serial", "batched"])
@pytest.mark.parametrize("weight_dtype", ["float16", "bfloat16"])
def test_strict_bound_holds_at_reduced_weight_dtype(engine, weight_dtype):
    """The encoder masks with the weights as archived, so the decoder's
    rounded weights push no point past the bound (hurricane seed 1,
    ``bfloat16``: one point of ``precip`` over it before)."""
    sess = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu",
                              engine=engine, weight_dtype=weight_dtype)
    arc = sess.compress(FIELDS, rel_eb=REL_EB)
    dec = sess.decompress(arc)
    for name, x in FIELDS.items():
        e = arc["fields"][name]
        assert e["weights"]["dtype"] == weight_dtype
        assert _max_err(dec[name], x) <= e["abs_eb"]
    if engine == "batched":
        serial = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu",
                                    weight_dtype=weight_dtype).compress(
            FIELDS, rel_eb=REL_EB)
        assert arc_io.dumps(arc["fields"]) == arc_io.dumps(serial["fields"])


def _fail_second_call(fn):
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise MemoryError("out of memory")
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("strategy", ["unroll", "vmap"])
def test_memory_error_degrades_what_it_reaches(monkeypatch, strategy):
    """Host out-of-memory in training: under ``unroll`` the field it hits
    degrades alone, with the serial engine's entry and reason; under
    ``vmap`` the stacked group it hits degrades."""
    real = online_trainer.train_epochs
    monkeypatch.setattr(online_trainer, "train_epochs", _fail_second_call(real))
    serial = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED,
                                device="cpu").compress(FIELDS, rel_eb=REL_EB)
    assert serial["timing"]["degraded_fields"] == ["precip"]
    monkeypatch.setattr(online_trainer, "train_epochs", _fail_second_call(real))
    monkeypatch.setattr(online_trainer, "train_stacked",
                        _fail_second_call(online_trainer.train_stacked))
    arc = repro_torch.NeurLZ(epochs=EPOCHS, seed=SEED, device="cpu",
                             engine="batched", field_batching=strategy,
                             group_size=2).compress(FIELDS, rel_eb=REL_EB)
    if strategy == "unroll":
        assert arc_io.dumps(arc["fields"]) == arc_io.dumps(serial["fields"])
        assert arc["fields"]["precip"]["degraded"] == "error:MemoryError"
    else:
        # Groups (cloud, precip) and (w): the second stacked call is w's.
        assert arc["timing"]["degraded_fields"] == ["w"]
        assert arc["fields"]["w"] == neurlz.pack_degraded_entry(
            neurlz.NeurLZConfig(), arc["fields"]["w"]["conv"],
            arc["fields"]["w"]["abs_eb"], "error:MemoryError")
    dec = arc.decode_all()
    for name, x in FIELDS.items():
        assert _max_err(dec[name], x) <= arc["fields"][name]["abs_eb"]
