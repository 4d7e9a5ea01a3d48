"""The port's sharding rules (``launch/sharding.py``) against the JAX
package's (``repro/launch/sharding.py``), spec for spec, as tuples:
``param_specs`` for all ten archs in quant none, ``serve_w8a8`` and
``serve_w4a8``, under the four policies, on the (1, 1), (16, 16) and
(2, 16, 16) meshes; ``batch_specs`` on every ``SHAPES`` cell; and
``cache_specs`` on every decode cell with ``mlstm_state_shard`` both
ways. Both packages read only the mesh's axis names and sizes, so stand-in
meshes take the place of devices on both sides (JAX's functions read
``axis_names`` and ``devices.shape``, the port's ``mesh_dim_names`` and
``shape``). Then ``to_shardings`` / ``placements``: an entry on tensor
dim d is ``Shard(d)`` on its mesh dim (a tuple of axes on each of them),
the rest ``Replicate()``; and ``mesh.make_production_mesh`` refuses a
world of another size."""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models.lm.config import SHAPES as JSHAPES
from repro_torch import configs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models.lm.config import SHAPES

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
QUANTS = ("none", "serve_w8a8", "serve_w4a8")
POLICIES = ("tp", "fsdp", "zero3", "cp")
DECODE = [s for s in SHAPES if s.kind == "decode"]


def _jax_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _port_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _jax_items(specs):
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return [(jshd._path_str(p), tuple(s)) for p, s in pairs]


def _port_items(specs):
    return [(k, tuple(s)) for k, s in shd.spec_items(specs)]


@functools.lru_cache(maxsize=None)
def _jax_params(arch, quant):
    return jsteps.abstract_params(jconfigs.get_config(arch,
                                                      quant_mode=quant))


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, shape):
    cell = next(s for s in JSHAPES if s.shape_name == shape)
    return jsteps.abstract_cache(jconfigs.get_config(arch), cell)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_jax(arch, quant, policy):
    jcfg = jconfigs.get_config(arch, quant_mode=quant)
    cfg = configs.get_config(arch, quant_mode=quant)
    params = steps.abstract_params(cfg)
    for name in MESHES:
        want = _jax_items(jshd.param_specs(_jax_params(arch, quant), jcfg,
                                           _jax_mesh(name), policy))
        got = _port_items(shd.param_specs(params, cfg, _port_mesh(name),
                                          policy))
        assert got == want, (arch, quant, policy, name)
        assert all(isinstance(s, shd.PartitionSpec) for _, s in
                   shd.spec_items(shd.param_specs(params, cfg,
                                                  _port_mesh(name), policy)))


@pytest.mark.parametrize("cell", [s.shape_name for s in SHAPES])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_specs_match_jax(arch, cell):
    jcell = next(s for s in JSHAPES if s.shape_name == cell)
    tcell = next(s for s in SHAPES if s.shape_name == cell)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name in MESHES:
        for policy in POLICIES:
            want = jshd.batch_specs(jcfg, jcell, _jax_mesh(name), policy)
            got = shd.batch_specs(cfg, tcell, _port_mesh(name), policy)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (name, policy)


@pytest.mark.parametrize("state_shard", [False, True])
@pytest.mark.parametrize("cell", [s.shape_name for s in DECODE])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_match_jax(arch, cell, state_shard):
    jcell = next(s for s in JSHAPES if s.shape_name == cell)
    tcell = next(s for s in SHAPES if s.shape_name == cell)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    cache = steps.abstract_cache(cfg, tcell)
    for name in MESHES:
        want = _jax_items(jshd.cache_specs(
            _jax_cache(arch, cell), jcfg, jcell, _jax_mesh(name),
            mlstm_state_shard=state_shard))
        got = _port_items(shd.cache_specs(cache, cfg, tcell,
                                          _port_mesh(name),
                                          mlstm_state_shard=state_shard))
        assert got == want, (name,)


def test_to_shardings_gives_the_stated_placements():
    mesh = _port_mesh("2x16x16")
    P = shd.P
    specs = {"a": P(None, ("pod", "data"), "model"), "b": P(),
             "c": (P("model", None), P(None, "data")),
             "d": P(("pod", "data", "model"))}
    sh = shd.to_shardings(specs, mesh)
    assert sh["a"].placements == (Shard(1), Shard(1), Shard(2))
    assert sh["b"].placements == (Replicate(),) * 3
    assert sh["c"][0].placements == (Replicate(), Replicate(), Shard(0))
    assert sh["c"][1].placements == (Replicate(), Shard(1), Replicate())
    assert sh["d"].placements == (Shard(0),) * 3
    assert sh["a"].spec == specs["a"] and sh["a"].mesh is mesh
    assert shd.local_shape((4, 64, 32), specs["a"], mesh) == (4, 2, 2)
    assert repr(P(None, "model")) == "P(None, 'model')"
    # a mesh dim of one device holds the whole tensor dim: replicated
    one = _port_mesh("1x1")
    assert shd.placements(P("data", "model"), one) == (Replicate(),) * 2
    assert shd.placements(P(None, "model"), SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(4, 1))) == \
        (Replicate(), Replicate())
    assert shd.placements(P("model", "data"), SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(4, 1))) == \
        (Shard(1), Replicate())


def test_big_weights_are_sharded_on_the_production_mesh():
    """The port's twin of ``tests/test_distributed.py``'s check: on the
    16x16 mesh qwen1.5-110b's large matrices are not replicated."""
    cfg = configs.get_config("qwen1.5-110b")
    flat = dict(shd.spec_items(shd.param_specs(
        steps.abstract_params(cfg), cfg, _port_mesh("16x16"))))
    for key in ["embed", "lm_head", "blocks/attn/wq", "blocks/mlp/wg"]:
        assert any(s is not None for s in flat[key]), key


def test_production_mesh_refuses_another_world():
    with pytest.raises(RuntimeError, match="has 1"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
