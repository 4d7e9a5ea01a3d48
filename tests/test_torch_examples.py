"""The five examples' twins on the port (``examples/*_torch.py``), on the
CPU at tiny sizes.

Each twin does what its reference script does through ``repro_torch``
alone. Here each ``main`` runs with ``--device cpu`` (the twins that
drive a launcher run it in a process of its own, as the reference does)
and the lines it prints are checked; the twins' defaults and the
launchers' argument lists are the reference scripts', read from their
source.
"""
import ast
import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Each twin on one CPU thread, here and in the launchers' processes:
    the twins run thousands of small ops, and with several test workers on
    the machine every op's parallel region waits on threads that other
    workers' processes hold (~25x slower than alone)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def twin(name):
    """The twin of ``examples/<name>.py``, imported from its file."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _defaults(path):
    """{flag: default} of the ``add_argument`` calls in a script."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            for kw in node.keywords:
                if kw.arg == "default":
                    try:
                        value = ast.literal_eval(kw.value)
                    except ValueError:          # an expression: its text
                        value = ast.unparse(kw.value)
                    out[node.args[0].value] = value
    return out


def _string_lists(path):
    """Every list literal of a script whose items are strings, a name
    standing in as ``{name}`` and ``sys.executable`` left out."""
    lists = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.List) and node.elts:
            items = [e.value if isinstance(e, ast.Constant)
                     else "{%s}" % e.id if isinstance(e, ast.Name) else None
                     for e in node.elts
                     if ast.unparse(e) != "sys.executable"]
            if all(isinstance(i, str) for i in items):
                lists.append(items)
    return lists


def test_the_twins_defaults_are_the_references():
    ref = _defaults(EXAMPLES / "md_stability.py")
    mine = _defaults(EXAMPLES / "md_stability_torch.py")
    assert ref == {k: mine[k] for k in ref}
    assert {"--device", "--frames", "--epochs", "--ckpt"} == \
        set(mine) - set(ref)
    assert _defaults(EXAMPLES / "train_so3krates_qat_torch.py") == {
        "--device": None, "--frames": 128, "--epochs": 30, "--qat-epochs": 8}
    ref_src = (EXAMPLES / "train_so3krates_qat.py").read_text()
    for n in ("sample_dataset(jax.random.PRNGKey(0), 128)", "epochs=30",
              "epochs=8, warmup_epochs=2", "n_rot=4, n_cfg=4"):
        assert n in ref_src


def test_the_launchers_argument_lists_are_the_references():
    lm = twin("train_lm_distributed")
    (cmd,) = [c for c in _string_lists(EXAMPLES / "train_lm_distributed.py")
              if "--arch" in c]
    assert cmd[:2] == ["-m", "repro.launch.train"]
    assert lm.launcher_args() == cmd[2:]
    serve = twin("serve_quantized_lm")
    ref = _string_lists(EXAMPLES / "serve_quantized_lm.py")
    (lm_cmd,) = [c for c in ref if "lm" in c]
    (so3_cmd,) = [c for c in ref if "so3" in c]
    src = (EXAMPLES / "serve_quantized_lm.py").read_text()
    runs = ast.literal_eval(re.search(r"for quant, kv in (\[.*\]):",
                                      src).group(1))
    assert tuple(runs) == serve.LM_RUNS
    want = [[a.replace("{quant}", q) for a in lm_cmd[2:]]
            + (["--kv-quant"] if kv else []) for q, kv in runs]
    assert [a for _, a in serve.runs()] == want + [so3_cmd[2:]]


def test_quickstart_twin(capsys):
    twin("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "codebook: 4096 points" in out
    assert "(100% within)" in out
    assert "tangent to S^2" in out
    assert "attention rows sum to 1.0000" in out
    assert "W4A8 matmul on cpu: weight bytes 16384 vs fp32 131072 (8x)" \
        in out
    assert out.rstrip().endswith("quickstart OK")


def test_train_so3krates_qat_twin(capsys):
    twin("train_so3krates_qat").main(["--device", "cpu", "--frames", "8",
                                      "--epochs", "2", "--qat-epochs", "3"])
    out = capsys.readouterr().out
    assert "== FP32 training ==" in out and "fp32: E-MAE" in out
    for name in ("GAQ W4A8", "naive INT8"):
        assert f"== QAT finetune: {name} ==" in out
        assert re.search(rf"{name}: E-MAE [\d.]+ meV, F-MAE [\d.]+ meV/A, "
                         r"LEE [\d.]+ meV/A", out), name


def test_md_stability_twin(capsys, tmp_path):
    twin("md_stability").main([
        "--device", "cpu", "--frames", "8", "--epochs", "2", "--steps",
        "100", "--ckpt", str(tmp_path / "no_checkpoint.npz")])
    out = capsys.readouterr().out
    assert "serving mode=w8a8 device=cpu" in out
    assert re.search(r"NVE \(w8a8, device-resident\) 100 steps @0.25fs x1 "
                     r"replica\(s\): drift -?[\d.]+ meV/atom/ps, "
                     r"blew_up=False", out)
    mae = float(re.search(r"served vs fp32 forces on 8 test frames: MAE "
                          r"([\d.]+)", out).group(1))
    assert mae < 0.05
    assert "served-model LEE: mean" in out


def test_serve_quantized_lm_twin(capfd):
    twin("serve_quantized_lm").main(["--device", "cpu"])
    out = capfd.readouterr().out
    for quant, kv in (("none", False), ("serve_w8a8", True),
                      ("serve_w4a8", True)):
        assert (f"arch=qwen2-smoke quant={quant} kv_quant={kv} "
                "device=cpu") in out
    assert len(re.findall(r"decode: [\d.]+ tok/s", out)) == 3
    assert "workload=so3 mode=w8a8 device=cpu" in out
    assert "infer_batch: 8 molecules (6-24 atoms)" in out
    assert "served-model LEE: mean" in out


def test_train_lm_distributed_twin(capfd, tmp_path):
    twin("train_lm_distributed").main(["--device", "cpu", "--steps", "12",
                                       "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "step     0 loss" in out and "step    11 loss" in out
    assert re.search(r"done: first loss [\d.]+ -> last [\d.]+", out)
    assert (tmp_path / "step_11").exists()
