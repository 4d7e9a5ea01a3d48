"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never quietly fall back to the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_examples import twin

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_leaves_jax_and_repro_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _modules())
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_lm_prefill_modules_are_imported():
    """The import check above covers the prefill slice: the step
    functions, every config module of the port's registry and the
    measurement tools behind chip_smoke.py's bounds."""
    mods = set(_modules())
    assert {"repro_torch.launch.steps",
            "repro_torch.configs.so3krates_paper",
            "repro_torch.tools.lm_prefill_gap",
            "repro_torch.tools.so3_grad_conditioning"} <= mods
    from repro_torch import configs
    for arch in configs.ARCH_IDS:
        assert configs._module(arch).__name__ in mods


def test_the_lm_train_modules_are_imported():
    """The import check above covers the training slice: the launcher,
    the token pipeline, the gradient compression, the tree helper and
    the tool behind chip_smoke.py phase 11's bounds."""
    assert {"repro_torch.launch.train", "repro_torch.data.tokens",
            "repro_torch.optim.compression", "repro_torch.tree",
            "repro_torch.tools.lm_train_gap"} <= set(_modules())


def test_the_lm_family_modules_are_imported():
    """The import check above covers the MoE, Mamba2-hybrid and xLSTM
    slice: the three block modules, the four configs and the routing
    tool behind chip_smoke.py phase 12's card-against-CPU gate."""
    assert {"repro_torch.models.lm.moe", "repro_torch.models.lm.ssm",
            "repro_torch.models.lm.xlstm", "repro_torch.tools.moe_routing",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.zamba2_1p2b",
            "repro_torch.configs.xlstm_1p3b"} <= set(_modules())


def test_the_distribution_modules_are_imported():
    """The import check above covers the distribution layer: the mesh,
    the sharding rules, the cost model, the collective counter and the
    dry run."""
    assert {"repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.costs", "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dryrun"} <= set(_modules())


def test_the_capture_module_is_imported():
    """The import check above covers the captured programs (the served
    loops' CUDA graphs), which import no CUDA at module import."""
    assert "repro_torch.captured" in set(_modules())
    from repro_torch import captured
    assert captured._STREAMS == {}


TWINS = ("quickstart", "train_so3krates_qat", "md_stability",
         "serve_quantized_lm", "train_lm_distributed")


def test_no_source_file_imports_jax_or_repro():
    """The port's package and the examples' twins (``examples/*_torch.py``,
    one per reference script)."""
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {p.name for p in twins} == {f"{n}_torch.py" for n in TWINS}
    offenders = []
    for path in list(PKG.rglob("*.py")) + twins:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert offenders == []


def test_obs_imports_no_torch():
    """The health plane (metrics, traces, exporters, SLOs, anomaly
    detectors, timeline) is stdlib only: its monitor and exporter threads
    run beside the replica workers and never touch the card. Every import
    of ``repro_torch/obs`` is a standard-library module or another obs
    module, so none reaches torch, JAX or the JAX package."""
    obs = PKG / "obs"
    names = {p.stem for p in obs.glob("*.py")}
    assert {"metrics", "trace", "export", "slo", "anomaly",
            "timeline"} <= names
    offenders = []
    for path in obs.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if top in sys.stdlib_module_names or top == "__future__":
                    continue
                if mod == "repro_torch.obs" or mod.startswith(
                        "repro_torch.obs."):
                    continue
                offenders.append(f"{path.name}: {mod}")
    assert offenders == []


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.models.so3krates import So3kratesConfig, init_params
    from repro_torch.serving import QuantizedEngine
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import build_lm
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm.attention import init_kv_cache
    from repro_torch.models.lm.transformer import init_cache, init_lm
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.cluster import ClusterPool
    from repro_torch.server import load_engine
    from repro_torch.weights import (lm_params_from_numpy, params_from_numpy,
                                     qparams_from_numpy)
    from repro_torch.data.synthetic_md import make_ff, sample_dataset_md
    from repro_torch.training import pipeline, so3_trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = So3kratesConfig(feat=8, vec_feat=2, n_layers=1, n_rbf=4,
                          dir_bits=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantizedEngine.from_config(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({})
    lm_cfg = get_smoke_config("qwen2-0.5b")
    for entry in (lambda: init_lm(lm_cfg), lambda: init_cache(lm_cfg, 1, 4),
                  lambda: init_kv_cache(lm_cfg, 1, 4, torch.float32),
                  lambda: lm_params_from_numpy({}),
                  lambda: build_lm(lm_cfg),
                  lambda: qparams_from_numpy({}),
                  lambda: load_engine("no_such_artifact.npz"),
                  lambda: ClusterPool.from_config(cfg),
                  lambda: ClusterPool.from_tiers(cfg),
                  lambda: ClusterPool.from_artifact("no_such_artifact.npz"),
                  lambda: ClusterPool.from_quantized(cfg, {}, None),
                  lambda: CheckpointManager(".").restore(0, like={}),
                  lambda: make_local_mesh(),
                  lambda: make_ff(),
                  lambda: sample_dataset_md(0, 1, stride=1),
                  lambda: so3_trainer.train(cfg, {}, so3_trainer.TrainConfig()),
                  lambda: so3_trainer.evaluate(cfg, {}, {}),
                  lambda: pipeline.load_params("no_such_params.npz"),
                  lambda: pipeline.latency_eval(cfg, {}),
                  lambda: pipeline.main(fast=True)) + tuple(
                      (lambda m: lambda: m.main([]))(twin(name))
                      for name in TWINS):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    with pytest.raises(RuntimeError):
        init_params(cfg, device="cuda")
    assert init_params(cfg, device="cpu")["embed"].device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_build_needs_nvcc_not_an_import():
    """Importing the kernel modules builds nothing; the build directory
    is keyed by a hash of the sources under the checkout."""
    from repro_torch.kernels import _build
    assert _build._lib is None or torch.cuda.is_available()
    root = _build._build_root()
    assert root == ROOT / "build" / "repro_torch"
    assert len(_build._source_hash()) == 16
    for name in _build.SOURCES:
        assert (PKG / "kernels" / "csrc" / name).exists()


def test_every_kernel_source_is_built_or_hashed():
    """Every file under csrc is compiled (``SOURCES``) or included by
    one and hashed with them (``HEADERS``), so an edit rebuilds."""
    from repro_torch.kernels import _build
    csrc = {p.name for p in (PKG / "kernels" / "csrc").iterdir()}
    assert csrc == set(_build.SOURCES) | set(_build.HEADERS)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """``chip_smoke.py`` must exit non-zero and print no result when there
    is no card, and when it sits in a directory without the repo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the smoke run would run for real")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=script.parent, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
