"""Nothing the benchmark imports is JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench.common import FORBIDDEN, HERE, ROOT


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "perfbench", "__future__",
                           "dataclasses", "math", "time", "typing"), \
                (path, name)
            if top == "perfbench":
                assert name.startswith("perfbench.reference"), (path, name)


def test_loading_every_module_and_the_program_leaves_jax_out():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import perfbench.run as r\n"
        "from perfbench.common import HERE, load_module\n"
        "for kind in ('drivers', 'metrics', 'rooflines'):\n"
        "    for p in sorted((HERE / kind).glob('*.py')):\n"
        "        load_module(kind, p.stem)\n"
        "import repro_torch.md.engine, repro_torch.server.scheduler\n"
        "import repro_torch.training.so3_trainer\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_whole_name_compare(monkeypatch):
    import types

    import perfbench.run as r
    before = set(r.forbidden_modules())
    for name in ("repro_torch_lookalike", "jaxfoo", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(r.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.lookalike",
                        types.ModuleType("repro.lookalike"))
    assert "repro" in r.forbidden_modules()
