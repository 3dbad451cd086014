"""The port's checkpoints, restart drills and training driver against the
JAX package, on the CPU.

``params.bin`` and ``opt.bin`` hold the same bytes as the reference's for
the same tree, raw and with NeurLZ-compressed weights (the ``szlike``
Lorenzo archives of the two packages are byte-identical), and each package
restores the other's directory.  The lossy cases use a small tree of 2-D,
3-D and 4-D leaves, so the reference compiles its eager Lorenzo ops for few
shapes.
"""
import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, FailureInjector,
                                    SimulatedFailure, run_with_restarts)
from repro_torch.core import archive as port_archive
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as train_lib
from repro_torch.models import model as M
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamWState, tree_items, tree_leaves

EB = 1e-5


def small_tree(seed=0):
    """Leaves of 1, 2, 3 and 4 dimensions (the 4-D one reshaped to
    [shape[0], -1] by the lossy path), float32."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32) * 0.02
    return {"embed": draw(64, 40), "ln_f": draw(40),
            "layers": {"w": draw(2, 40, 24), "ln": draw(2, 40),
                       "experts": draw(2, 3, 8, 20)}}


def qwen_state():
    """The reference's reduced qwen3-4b parameters and its AdamW state
    after one update, as numpy trees."""
    jcfg = jconfigs.get_reduced("qwen3-4b")
    jm = JM.build_model(jcfg, model_axis=1)
    with jax.enable_x64(False):
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
        _, opt = jadamw.adamw_update(g, jadamw.adamw_init(jp), jp, lr=1e-3)
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, opt)


def to_port(tree):
    return M.params_from_jax(tree, "cpu")


def port_opt(jopt):
    return AdamWState(step=int(jopt.step), mu=to_port(jopt.mu), nu=to_port(jopt.nu))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def meta_without_times(path):
    with open(path) as f:
        meta = json.load(f)
    return {k: v for k, v in meta.items() if k not in ("time", "save_seconds")}


def leaves_np(tree):
    return [np.asarray(a.float() if isinstance(a, torch.Tensor) and
                       a.dtype == torch.bfloat16 else a) for a in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the files, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_checkpoint_bytes_equal_reference(tmp_path, dtype):
    jp, jopt = qwen_state()
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    extra = {"stream": {"seed": 0, "step": 5}, "loss": 1.5}
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(5, jp, jopt, extra=extra)
    params = to_port(jp)
    assert tree_leaves(params)[0].dtype == getattr(torch, dtype)
    CheckpointManager(str(tmp_path / "port"), device="cpu").save(
        5, params, port_opt(jopt), extra=extra)
    for name in ("params.bin", "opt.bin"):
        assert (read(tmp_path / "port" / "step_5" / name)
                == read(tmp_path / "ref" / "step_5" / name)), name
    assert (meta_without_times(tmp_path / "port" / "step_5" / "meta.json")
            == meta_without_times(tmp_path / "ref" / "step_5" / "meta.json"))
    assert read(tmp_path / "port" / "manifest.json") == read(
        tmp_path / "ref" / "manifest.json")

    # The keys are the reference's: parameter paths, and .step / .mu/<path>
    # / .nu/<path> for the optimizer's NamedTuple.
    opt_keys = list(msgpack.unpackb(jckpt.codec.decompress_sniffed(
        read(tmp_path / "port" / "step_5" / "opt.bin")), raw=False))
    assert opt_keys[0] == ".step" and ".mu/layers/attn/w_q_in" in opt_keys

    # Each package restores the other's directory, exactly.
    p2, o2, meta = CheckpointManager(str(tmp_path / "ref"), device="cpu").restore(
        5, params, port_opt(jopt))
    assert meta["extra"] == extra and o2.step == int(jopt.step)
    for a, b in zip(leaves_np(p2), jax.tree.leaves(jp)):
        assert a.tobytes() == np.asarray(b, a.dtype).tobytes()
    for a, b in zip(leaves_np(o2.mu) + leaves_np(o2.nu),
                    jax.tree.leaves(jopt.mu) + jax.tree.leaves(jopt.nu)):
        assert a.tobytes() == np.asarray(b).tobytes()
    jp2, jo2, _ = jckpt.CheckpointManager(str(tmp_path / "port")).restore(5, jp, jopt)
    for a, b in zip(jax.tree.leaves(jp2) + jax.tree.leaves(jo2),
                    jax.tree.leaves(jp) + jax.tree.leaves(jopt)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_lossy_checkpoint_bytes_equal_reference_and_restore_both_ways(tmp_path):
    tree = small_tree()
    jckpt.CheckpointManager(str(tmp_path / "ref"), lossy_weights_eb=EB).save(1, tree)
    params = to_port(tree)
    port = CheckpointManager(str(tmp_path / "port"), lossy_weights_eb=EB,
                             device="cpu")
    port.save(1, params)
    assert (read(tmp_path / "port" / "step_1" / "params.bin")
            == read(tmp_path / "ref" / "step_1" / "params.bin"))
    assert (meta_without_times(tmp_path / "port" / "step_1" / "meta.json")
            == meta_without_times(tmp_path / "ref" / "step_1" / "meta.json"))
    entries = msgpack.unpackb(jckpt.codec.decompress_sniffed(
        read(tmp_path / "port" / "step_1" / "params.bin")), raw=False)
    assert {k: e["kind"] for k, e in entries.items()} == {
        "embed": "szlike", "layers/experts": "szlike", "layers/ln": "szlike",
        "layers/w": "szlike", "ln_f": "raw"}

    # The restored weights: within eb · range where lossy, exact where not,
    # and the same bits whichever package restores whichever directory.
    got, _, _ = port.restore(1, params)
    want, _, _ = jckpt.CheckpointManager(str(tmp_path / "ref")).restore(1, tree)
    cross, _, _ = CheckpointManager(str(tmp_path / "ref"), device="cpu").restore(
        1, params)
    back, _, _ = jckpt.CheckpointManager(str(tmp_path / "port")).restore(1, tree)
    for a, w, c, b, x in zip(leaves_np(got), jax.tree.leaves(want),
                             leaves_np(cross), jax.tree.leaves(back),
                             jax.tree.leaves(tree)):
        assert a.tobytes() == np.asarray(w).tobytes() == c.tobytes() \
            == np.asarray(b).tobytes()
        if x.ndim >= 2:
            lim = EB * float(x.max() - x.min())
            assert np.abs(a.astype(np.float64) - x).max() <= lim
        else:
            assert a.tobytes() == x.tobytes()


def test_retention_manifest_and_a_lost_step_directory_as_reference(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ref = jckpt.CheckpointManager(str(tmp_path / "ref"), keep=2)
    port = CheckpointManager(str(tmp_path / "port"), keep=2, device="cpu")
    assert port.latest_step() is None and port.manifest() == {"steps": []}
    for s in (1, 2, 3, 4):
        ref.save(s, tree)
        port.save(s, to_port(tree))
    for mgr, root in ((ref, tmp_path / "ref"), (port, tmp_path / "port")):
        assert mgr.manifest()["steps"] == [3, 4]
        assert sorted(os.listdir(root)) == ["manifest.json", "step_3", "step_4"]
        assert mgr.latest_step() == 4
        # A step whose directory was lost: the newest complete one.
        import shutil
        shutil.rmtree(root / "step_4")
        assert mgr.latest_step() == 3
        assert mgr.manifest()["steps"] == [3, 4]
    # A save over an interrupted one (its .tmp left behind) publishes.
    os.makedirs(tmp_path / "port" / "step_5.tmp")
    port.save(5, to_port(tree))
    assert port.latest_step() == 5 and not (tmp_path / "port" / "step_5.tmp").exists()


_BF16_SCRIPT = """
import sys
sys.modules["ml_dtypes"] = None          # no numpy bfloat16 dtype anywhere
import numpy as np, torch
from repro_torch.checkpoint import CheckpointManager
vals = np.load(sys.argv[1])
tree = {"a": torch.from_numpy(vals).to(torch.bfloat16), "b": torch.ones(3)}
mgr = CheckpointManager(sys.argv[2], device="cpu")
mgr.save(1, tree)
back, _, _ = mgr.restore(1, tree)
assert back["a"].dtype == torch.bfloat16
sys.stdout.write(back["a"].view(torch.int16).numpy().tobytes().hex())
"""


@functools.lru_cache(maxsize=None)
def zamba2_bf16_tree():
    """The reference's reduced zamba2-7b in bfloat16, its ``A_log``, ``D``
    and ``dt_bias`` float32 (as its init keeps them) and filled with
    values of a trained model's spread, so the lossy codec has a range to
    bound."""
    import dataclasses

    jcfg = dataclasses.replace(jconfigs.get_reduced("zamba2-7b"), dtype="bfloat16")
    with jax.enable_x64(False):
        jp = jax.tree.map(np.asarray, jax.jit(JM.build_model(jcfg).init)(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    for stack in ("mamba_units", "mamba_rem"):
        for name in ("A_log", "D", "dt_bias"):
            leaf = jp[stack]["mamba"][name]
            assert leaf.dtype == np.float32 and leaf.ndim >= 2
            jp[stack]["mamba"][name] = rng.standard_normal(leaf.shape).astype(np.float32)
    return jp


@pytest.mark.parametrize("eb", [None, EB])
def test_mixed_dtype_checkpoint_bytes_equal_reference_both_ways(tmp_path, eb):
    """A bfloat16 tree with float32 leaves: raw, the bfloat16 leaves as
    their bits and the float32 ones as they are; lossy, the float32 leaves
    of 2 or more dimensions through ``szlike`` Lorenzo (within eb · range)
    and the bfloat16 ones raw.  The same bytes as the reference's, and each
    package restores the other's directory to the same bits."""
    jp = zamba2_bf16_tree()
    jckpt.CheckpointManager(str(tmp_path / "ref"), lossy_weights_eb=eb).save(1, jp)
    params = to_port(jp)
    port = CheckpointManager(str(tmp_path / "port"), lossy_weights_eb=eb, device="cpu")
    port.save(1, params)
    assert (read(tmp_path / "port" / "step_1" / "params.bin")
            == read(tmp_path / "ref" / "step_1" / "params.bin"))
    entries = msgpack.unpackb(jckpt.codec.decompress_sniffed(
        read(tmp_path / "port" / "step_1" / "params.bin")), raw=False)
    lossy = {k for k, e in entries.items() if e["kind"] == "szlike"}
    assert lossy == (set() if eb is None else {
        f"{s}/mamba/{n}" for s in ("mamba_units", "mamba_rem")
        for n in ("A_log", "D", "dt_bias")})
    got, _, _ = port.restore(1, params)
    cross, _, _ = CheckpointManager(str(tmp_path / "ref"), device="cpu").restore(1, params)
    back, _, _ = jckpt.CheckpointManager(str(tmp_path / "port")).restore(1, jp)
    for (path, a), c, b, x in zip(tree_items(got), tree_leaves(cross),
                                  jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == c.dtype and str(a.dtype).split(".")[1] == str(x.dtype)
        bits = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        assert bits.numpy().tobytes() == (c.view(torch.int16) if c.dtype == torch.bfloat16
                                          else c).numpy().tobytes()
        assert bits.numpy().tobytes() == np.asarray(b).tobytes()
        if "/".join(path) in lossy:
            lim = eb * float(x.max() - x.min())
            assert np.abs(a.numpy().astype(np.float64) - x).max() <= lim
        else:
            assert bits.numpy().tobytes() == x.tobytes()


def test_bfloat16_checkpoint_reads_back_without_ml_dtypes(tmp_path):
    import ml_dtypes
    vals = (np.random.default_rng(2).standard_normal((5, 7)) * 3).astype(np.float32)
    np.save(tmp_path / "vals.npy", vals)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__),
                                                   "..", "src"))
    out = subprocess.run([sys.executable, "-c", _BF16_SCRIPT,
                          str(tmp_path / "vals.npy"), str(tmp_path / "port")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = vals.astype(ml_dtypes.bfloat16)
    assert bytes.fromhex(out.stdout) == want.tobytes()
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(
        1, {"a": want, "b": np.ones(3, np.float32)})
    assert (read(tmp_path / "port" / "step_1" / "params.bin")
            == read(tmp_path / "ref" / "step_1" / "params.bin"))


def test_neurlz_grad_archive_bytes_equal_reference():
    grads = small_tree(seed=4)
    want = jgc.neurlz_grad_archive(grads, rel_eb=1e-3)
    got = grad_compress.neurlz_grad_archive(to_port(grads), rel_eb=1e-3,
                                            device="cpu")
    assert sorted(got["arcs"]) == sorted(want["arcs"]) == [
        "embed", "layers/w"]       # 1-D and small leaves are skipped
    for k in want["arcs"]:
        assert port_archive.dumps(got["arcs"][k]) == jckpt._arc_to_bytes(
            want["arcs"][k])
    for k in ("raw_bytes", "comp_bytes", "ratio"):
        assert got[k] == want[k]


# ---------------------------------------------------------------------------
# restarts and the driver
# ---------------------------------------------------------------------------

def _drill(tmp_path, fail_at=None, steps=6):
    """The reference's resume drill: a reduced qwen3-4b trained for
    ``steps`` steps with a checkpoint after each, failing at ``fail_at``
    and resumed by ``run_with_restarts``."""
    cfg = configs.get_reduced("qwen3-4b")
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    attempts = []

    def run():
        attempts.append(mgr.latest_step())
        injector = FailureInjector(fail_at if len(attempts) == 1 else None)
        model = M.build_model(cfg, model_axis=1)
        params, opt = M.init_train_state(model, seed=0, device="cpu")
        stream = TokenStream(cfg.vocab_size, 2, 32, seed=0)
        start = mgr.latest_step() or 0
        if start:
            params, opt, meta = mgr.restore(start, params, opt)
            params = model.load_params(params)
            stream.restore(meta["extra"]["stream"])
        step_fn = M.make_train_step(model, lr=1e-3)
        for step in range(start, steps):
            batch = {"tokens": torch.from_numpy(stream.next_batch())}
            params, opt, _ = step_fn(params, opt, batch, step)
            injector.maybe_fail(step)
            mgr.save(step + 1, params, opt, extra={"stream": stream.checkpoint()})
        return params, opt
    params, opt = run_with_restarts(run)
    return params, opt, attempts


def test_resume_after_a_failure_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    ref_p, ref_o, _ = _drill(tmp_path / "a")
    got_p, got_o, attempts = _drill(tmp_path / "b", fail_at=3)
    assert attempts == [None, 3]        # failed after step 3, resumed there
    assert got_o.step == ref_o.step == 6
    for a, b in zip(tree_leaves(got_p) + tree_leaves(got_o.mu) + tree_leaves(got_o.nu),
                    tree_leaves(ref_p) + tree_leaves(ref_o.mu) + tree_leaves(ref_o.nu)):
        assert torch.equal(a, b)


def test_run_with_restarts_gives_up_after_max_restarts():
    calls = []

    def always_fails():
        calls.append(1)
        raise SimulatedFailure("boom")
    with pytest.raises(SimulatedFailure):
        run_with_restarts(always_fails, max_restarts=2)
    assert len(calls) == 3


def _args(tmp_path, **kw):
    a = dict(arch="qwen3-4b", preset="reduced", steps=6, batch=2, seq=32, lr=3e-3,
             seed=0, microbatch=1, ckpt_dir=str(tmp_path), ckpt_every=2, keep=3,
             resume=True, lossy_ckpt_eb=None, fail_at_step=None,
             step_deadline=120.0, log_every=0, device="cpu")
    a.update(kw)
    return types.SimpleNamespace(**a)


def test_launch_train_resumes_and_reports_like_reference(tmp_path):
    """``launch.train.train`` at the reduced preset, failing at step 3
    under ``run_with_restarts``: the restart resumes at the step-2
    checkpoint, the report carries the reference driver's keys, the loss
    falls, and the final checkpoint equals an uninterrupted run's."""
    attempts = []

    def make():
        attempts.append(len(attempts))
        return train_lib.train(_args(tmp_path / "a", fail_at_step=3 if len(
            attempts) == 1 else None))
    rep = run_with_restarts(make)
    assert len(attempts) == 2
    assert set(rep) >= {"arch", "steps", "first_loss", "last_loss", "wall_s",
                        "watchdog", "resumed_from"}
    assert rep["resumed_from"] == 2     # steps 0-3 ran, step 2 was saved
    whole = train_lib.train(_args(tmp_path / "b"))
    assert whole["resumed_from"] == 0 and whole["last_loss"] < whole["first_loss"]
    assert whole["watchdog"]["steps"] == 6 and rep["watchdog"]["steps"] == 4
    assert rep["last_loss"] == whole["last_loss"]
    for name in ("params.bin", "opt.bin"):
        assert read(tmp_path / "a" / "step_6" / name) == read(
            tmp_path / "b" / "step_6" / name)


def test_launch_train_advances_the_stream_for_a_vlm_arch(tmp_path):
    """llava-next-34b (vlm) trains on its demo batches, yet the token
    stream advances on every step, as the reference driver's does
    (``src/repro/launch/train.py:64-69``): each checkpoint's
    ``extra.stream`` equals the reference stream's after as many
    batches."""
    from repro.data.tokens import TokenStream as RefTokenStream

    args = _args(tmp_path, arch="llava-next-34b", steps=4, seq=16)
    train_lib.train(args)
    cfg = jconfigs.get_reduced("llava-next-34b")
    for step in (2, 4):
        ref = RefTokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
        for _ in range(step):
            ref.next_batch()
        meta = json.loads((tmp_path / f"step_{step}" / "meta.json").read_text())
        assert meta["extra"]["stream"] == ref.checkpoint() == {"seed": 0, "step": step}


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("holds the no-GPU error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lib.train(_args(tmp_path, device=None))
