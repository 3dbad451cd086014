"""The port's sharding rules and abstract trees against the JAX package's.

For each of the ten configs at full width (``build_model(cfg,
model_axis=16)``): the port's ``abstract_params`` / ``abstract_opt_state``
/ ``abstract_cache`` leaves (path, shape, dtype) equal the reference's
``jax.eval_shape`` trees (traced, not compiled), and ``param_pspecs``,
``opt_pspecs``, ``cache_pspecs`` (batch 128, 1 and 4) and
``input_pspecs`` equal the reference's on ``{pod:2, data:16, model:16}``,
``{data:16, model:16}`` and ``{data:1, model:1}``.  The reference's own
cases (``tests/test_sharding.py``) run on the port as one parametrised
test.  No device, no process group: the rules read a mesh's shape.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sh
from repro.models import model as ref_M
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState

torch.set_num_threads(1)

ARCHS = list(configs.ARCHS)
MESHES = {"pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "16x16": {"data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1}}
CACHE_BATCHES = (128, 1, 4)
CACHE_LEN = 2048


def _key(k) -> str:
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "name"):
        return f".{k.name}"
    return str(k.idx)


def _ref_flat(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _port_flat(tree, prefix=()) -> dict:
    """``{path: leaf}`` in the reference's flatten order (sorted keys, a
    NamedTuple's fields as ``.name``); a spec (a tuple) is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_flat(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, AdamWState):
        out = {}
        for name in tree._fields:
            out.update(_port_flat(getattr(tree, name), prefix + (f".{name}",)))
        return out
    return {"/".join(prefix): tree}


def _leaves(flat: dict) -> list:
    return [(p, tuple(int(d) for d in leaf.shape), np.dtype(leaf.dtype).name
             if not isinstance(leaf, torch.Tensor) else str(leaf.dtype)[6:])
            for p, leaf in flat.items()]


def _specs(flat: dict) -> list:
    return [(p, tuple(s)) for p, s in flat.items()]


@functools.lru_cache(maxsize=None)
def _ref(arch):
    model = ref_M.build_model(ref_configs.get_config(arch), model_axis=16)
    params = ref_M.abstract_params(model)
    return model, params, ref_M.abstract_opt_state(params)


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = M.build_model(configs.get_config(arch), model_axis=16)
    params = M.abstract_params(model)
    return model, params, M.abstract_opt_state(params)


def _has_cache(arch) -> bool:
    return configs.get_config(arch).family != "audio"


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_reference(arch):
    rmodel, rparams, ropt = _ref(arch)
    pmodel, pparams, popt = _port(arch)
    assert all(leaf.device.type == "meta" for leaf in _port_flat(pparams).values())
    assert _leaves(_port_flat(pparams)) == _leaves(_ref_flat(rparams))
    assert _leaves(_port_flat(popt)) == _leaves(_ref_flat(ropt))
    if _has_cache(arch):
        rc = ref_M.abstract_cache(rmodel, 4, CACHE_LEN)
        pc = M.abstract_cache(pmodel, 4, CACHE_LEN)
        assert _leaves(_port_flat(pc)) == _leaves(_ref_flat(rc))
    else:
        with pytest.raises(ValueError):
            M.abstract_cache(pmodel, 4, CACHE_LEN)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_opt_cache_specs_match_reference(arch, mesh):
    ref_mesh = SimpleNamespace(shape=MESHES[mesh])
    port_mesh = mesh_lib.MeshShape(dict(MESHES[mesh]))
    rmodel, rparams, _ = _ref(arch)
    pmodel, pparams, _ = _port(arch)
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    rspecs = ref_sh.param_pspecs(rparams, ref_mesh)
    pspecs = sh.param_pspecs(pparams, port_mesh)
    assert _specs(_port_flat(pspecs)) == _specs(_ref_flat(rspecs, is_spec))
    assert _specs(_port_flat(sh.opt_pspecs(pspecs))) == _specs(
        _ref_flat(ref_sh.opt_pspecs(rspecs), is_spec))
    if not _has_cache(arch):
        return
    for batch in CACHE_BATCHES:
        rc = ref_sh.cache_pspecs(ref_M.abstract_cache(rmodel, batch, CACHE_LEN),
                                 ref_mesh, batch)
        pc = sh.cache_pspecs(M.abstract_cache(pmodel, batch, CACHE_LEN),
                             port_mesh, batch)
        assert _specs(_port_flat(pc)) == _specs(_ref_flat(rc, is_spec)), batch


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    pcfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        rshape = ref_configs.SHAPES[name]
        if pcfg.family == "audio" and shape.kind == "decode":
            with pytest.raises(ValueError):
                M.input_specs(pcfg, shape)
            continue
        pin, rin = M.input_specs(pcfg, shape), ref_M.input_specs(rcfg, rshape)
        assert _leaves(pin) == _leaves(rin), name
        for mesh in MESHES.values():
            for seq_shard in (False, True):
                got = sh.input_pspecs(pin, mesh_lib.MeshShape(dict(mesh)),
                                      seq_shard=seq_shard)
                want = ref_sh.input_pspecs(rin, SimpleNamespace(shape=mesh),
                                           seq_shard=seq_shard)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (name, mesh)


# ---- the reference's own cases (tests/test_sharding.py), on the port -------

MESH = mesh_lib.make_production_mesh(multi_pod=True)
P = sh.P


def _param_rules_qwen():
    specs = sh.param_pspecs(_port("qwen3-4b")[1], MESH)
    assert specs["embed"] == P("model", "data")
    assert specs["layers"]["attn"]["w_q_in"] == P(None, "data", "model")
    assert specs["layers"]["attn"]["w_o_out"] == P(None, "model", "data")
    assert specs["layers"]["ln1"] == P()


def _param_rules_moe_expert_parallel():
    specs = sh.param_pspecs(_port("deepseek-moe-16b")[1], MESH)
    assert specs["layers"]["moe"]["w_experts_up"] == P(None, "model", "data", None)
    assert specs["layers"]["moe"]["w_experts_down"] == P(None, "model", None, "data")


def _divisibility_guard_drops_axis():
    assert sh._guard(("model", "data"), (49155, 1536), MESH) == P(None, "data")


def _batch_axes_for():
    assert sh.batch_axes_for(MESH, 256) == ("pod", "data")
    assert sh.batch_axes_for(MESH, 16) == ("data",)
    assert sh.batch_axes_for(MESH, 1) is None


def _cache_rules_kv_fallback_to_head_dim():
    model = _port("qwen3-8b")[0]             # kv=8: cannot shard over model=16
    specs = sh.cache_pspecs(M.abstract_cache(model, 128, 1024), MESH, 128)
    assert specs["layers"]["k"][-1] == "model"


def _cache_rules_seq_parallel_when_batch_1():
    model = _port("zamba2-7b")[0]
    specs = sh.cache_pspecs(M.abstract_cache(model, 1, 2048), MESH, 1)
    assert "data" in specs["attn"]["k"]


def _constrain_noop_without_mesh():
    sh.set_active_mesh(None)
    x = torch.zeros((4, 4))
    assert sh.constrain(x, ("batch", None)) is x


REFERENCE_CASES = [_param_rules_qwen, _param_rules_moe_expert_parallel,
                   _divisibility_guard_drops_axis, _batch_axes_for,
                   _cache_rules_kv_fallback_to_head_dim,
                   _cache_rules_seq_parallel_when_batch_1,
                   _constrain_noop_without_mesh]


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=lambda f: f.__name__[1:])
def test_reference_sharding_cases(case):
    case()


def test_production_mesh_shapes():
    assert mesh_lib.make_production_mesh().shape == {"data": 16, "model": 16}
    assert MESH.shape == {"pod": 2, "data": 16, "model": 16}
    assert list(MESH.shape) == ["pod", "data", "model"]


def test_spec_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.placements(P(("data", "pod")), mesh)


def test_abstract_params_allocate_nothing_and_init_needs_a_generator():
    model = M.build_model(configs.get_config("qwen3-4b"), model_axis=16)
    with pytest.raises(ValueError):
        model.init(None, device="cpu")
    p = M.abstract_params(model)
    assert p["embed"].is_meta and tuple(p["embed"].shape) == (151936, 2560)
    assert not list(model.parameters())       # not registered on the model
