"""The port's dry run (``launch/dryrun.run_cell``) on a 2 x 2 fake mesh, a
test-only mesh shape (the production meshes' 256 and 512 ranks are the
CLI's; ``chip_smoke.py`` phase 13 runs those): one train, one prefill and
one decode cell of musicgen-large's smoke config, whose 4 heads divide
the model axis. Each record has the keys of the JAX ``run_cell``'s record
(read from its source: the JAX dry run forces 512 host devices when
imported), its argument bytes are the sum of the local shards' bytes of
the step's arguments (computed here from the spec trees), its analytic
fields equal the JAX ``costs`` on the JAX smoke config, and it counted
FLOPs and collectives. A cell whose q/k/v view DTensor refuses (qwen2's
smoke config: 7 heads over a model axis of 2) now runs to its record
after a reshard of that view, logged beside the record and inside its
collectives; a step that fails for any other reason still returns its
record, with ``"error"``. ``run_cell`` opens and destroys its own fake
process group.
"""
import ast
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch import costs as jcosts
from repro.models.lm.config import SHAPES as JSHAPES
from repro_torch import configs, tree
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.reshard import reshard_totals
from repro_torch.models.lm.config import SHAPES

ROOT = Path(__file__).resolve().parents[1]
ARCH = "musicgen-large"
MESH = (2, 2)


def _jax_record_keys():
    """(top-level keys, memory keys) of the dict literal ``rec`` in the
    JAX ``run_cell``."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    keys = [k.value for k in rec.keys]
    mem = rec.values[keys.index("memory")]
    return set(keys), {k.value for k in mem.keys}


def _sharded_bytes(abstract, specs, mesh_axes):
    flat = dict(shd.spec_items(specs))
    total = 0
    for k, x in tree.items(abstract):
        split = math.prod(
            math.prod(mesh_axes[a] for a in (s if isinstance(s, tuple)
                                             else (s,)))
            for s in flat[k] if s is not None)
        total += x.numel() * x.element_size() // split
    return total


def _argument_bytes(cell):
    """Local bytes of the step's arguments: the parameters (and AdamW's
    two moments, placed alike, and its int32 step count), the batch, and
    a decode's cache."""
    cfg = configs.get_smoke_config(ARCH)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=MESH)
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    params = steps.abstract_params(cfg)
    n_params = _sharded_bytes(params, shd.param_specs(params, cfg, mesh),
                              axes)
    b_specs = shd.batch_specs(cfg, cell, mesh)
    n_batch = _sharded_bytes(steps.input_specs(cfg, cell), b_specs, axes)
    if cell.kind == "train":
        return 3 * n_params + 4 + n_batch
    if cell.kind == "prefill":
        return n_params + n_batch
    cache = steps.abstract_cache(cfg, cell)
    return n_params + n_batch + _sharded_bytes(
        cache, shd.cache_specs(cache, cfg, cell, mesh), axes)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_writes_the_reference_record(shape):
    rec = dryrun.run_cell(ARCH, shape, "single", mesh_shape=MESH,
                          smoke=True)
    assert not dist.is_initialized()
    assert "error" not in rec, rec.get("error")
    keys, mem_keys = _jax_record_keys()
    assert set(rec) == keys and set(rec["memory"]) == mem_keys
    cell = next(s for s in SHAPES if s.shape_name == shape)
    jcell = next(s for s in JSHAPES if s.shape_name == shape)
    assert (rec["kind"], rec["seq_len"], rec["global_batch"],
            rec["n_devices"]) == (cell.kind, cell.seq_len,
                                  cell.global_batch, 4)
    assert rec["memory"]["argument_bytes"] == _argument_bytes(cell)
    assert rec["memory"]["output_bytes"] > 0
    jcfg = jconfigs.get_smoke_config(ARCH)
    assert rec["analytic_flops"] == pytest.approx(
        jcosts.cell_flops(jcfg, jcell), rel=1e-12)
    assert rec["model_flops"] == pytest.approx(
        jcosts.model_flops(jcfg, jcell), rel=1e-12)
    want = jcosts.cell_hbm_bytes(jcfg, jcell)
    assert rec["analytic_hbm_bytes"].keys() == want.keys()
    for k in want:
        assert rec["analytic_hbm_bytes"][k] == pytest.approx(want[k],
                                                             rel=1e-12)
    assert (rec["param_count"], rec["active_param_count"]) == (
        jcfg.param_count(), jcfg.active_param_count())
    assert rec["flops"] > 0 and rec["bytes_accessed"] == -1
    assert sum(rec["collective_counts"].values()) > 0
    assert set(rec["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


def test_a_cell_dtensor_refuses_runs_after_a_logged_reshard():
    rec, reshards = dryrun.run_cell_and_reshards(
        "qwen2-0.5b", "prefill_32k", "single", mesh_shape=MESH, smoke=True)
    assert not dist.is_initialized()
    assert "error" not in rec, rec.get("error")
    keys, mem_keys = _jax_record_keys()
    assert set(rec) == keys and set(rec["memory"]) == mem_keys
    assert rec["flops"] > 0
    assert any(e["op"] == "aten.view.default" for e in reshards)
    n, nbytes, counts = reshard_totals(reshards)
    assert n >= 1 and sum(nbytes.values()) > 0
    for kind in nbytes:
        assert rec["collective_bytes"][kind] >= nbytes[kind]
        assert rec["collective_counts"][kind] >= counts[kind]


def test_a_step_that_fails_otherwise_keeps_its_error(monkeypatch):
    def broken(cfg):
        def step(params, batch):
            raise ValueError("not DTensor's refusal")
        return step
    monkeypatch.setattr(dryrun, "make_prefill_step", broken)
    rec, reshards = dryrun.run_cell_and_reshards(
        "qwen2-0.5b", "prefill_32k", "single", mesh_shape=MESH, smoke=True)
    assert not dist.is_initialized()
    assert rec["error"] == "ValueError: not DTensor's refusal"
    assert reshards == []
    assert rec["flops"] == -1 and rec["analytic_flops"] > 0


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_meta_shards_have_dtensors_local_shape(mesh_kind):
    """``sharding.local_shape`` (the shape of each meta shard the dry run
    builds) is DTensor's own local shape on rank 0 for every leaf of every
    cell's parameters, batch and decode cache, under every policy, on the
    production mesh: no spec the rules give splits a dim unevenly."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, names = dryrun._MESHES[mesh_kind]
    n = 0
    with dryrun.fake_world(shape, names) as mesh:
        for arch in configs.ARCH_IDS:
            cfg = configs.get_config(arch)
            params = steps.abstract_params(cfg)
            trees = []
            for policy in ("tp", "fsdp", "zero3", "cp"):
                trees.append((params, shd.param_specs(params, cfg, mesh,
                                                      policy)))
                for cell in configs.shapes_for(arch):
                    trees.append((steps.input_specs(cfg, cell),
                                  shd.batch_specs(cfg, cell, mesh, policy)))
            for cell in configs.shapes_for(arch):
                if cell.kind == "decode":
                    cache = steps.abstract_cache(cfg, cell)
                    trees.append((cache, shd.cache_specs(cache, cfg, cell,
                                                         mesh)))
            for values, specs in trees:
                flat = dict(shd.spec_items(specs))
                for k, v in tree.items(values):
                    want, _ = compute_local_shape_and_global_offset(
                        v.shape, mesh, shd.placements(flat[k], mesh))
                    assert shd.local_shape(v.shape, flat[k], mesh) == \
                        tuple(want), (arch, k, flat[k])
                    n += 1
    assert not dist.is_initialized() and n > 500
