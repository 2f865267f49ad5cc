"""No run loads JAX or the JAX package, and the reference loads nothing of
the program."""
import ast
import json
import subprocess
import sys

import pytest

from cardbench import bench

ENV_CODE = "import sys; sys.path[:0] = [{src!r}, {repo!r}]\n"


def _python(code: str) -> subprocess.CompletedProcess:
    head = ENV_CODE.format(src=str(bench.REPO / "src"), repo=str(bench.REPO))
    return subprocess.run([sys.executable, "-c", head + code], capture_output=True, text=True,
                          timeout=600, cwd=bench.REPO)


def test_cardbench_whole_names_are_compared():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1, "repro": 1, "jax.numpy": 1,
            "flax.linen": 1, "jaxlib": 1}
    assert bench.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib", "repro"]


def test_cardbench_a_tiny_run_loads_no_jax_in_a_fresh_process(tmp_path):
    code = f"""
import json, pathlib
from cardbench.tests import tiny
import cardbench.run as R
from cardbench import bench
for name in (tiny.TRAIN, tiny.DECODE):
    root = pathlib.Path({str(tmp_path)!r}) / name
    root.mkdir()
    R.execute(tiny.run(tiny.cell(root, name)))
print(json.dumps(bench.forbidden_modules()))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cardbench_a_run_that_loads_jax_prints_no_result(tmp_path):
    code = f"""
import pathlib, sys, types
from cardbench.tests import tiny
import cardbench.run as R
sys.modules["repro"] = types.ModuleType("repro")
try:
    R.execute(tiny.run(tiny.cell(pathlib.Path({str(tmp_path)!r}), tiny.DECODE)))
except ImportError as e:
    print("refused:", e)
"""
    out = _python(code)
    assert "refused:" in out.stdout and "'repro'" in out.stdout, out.stderr[-2000:]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((bench.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_cardbench_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("repro_torch", "repro", "jax", "jaxlib", "flax"), (path.name, name)
        if top == "cardbench":
            assert name.startswith("cardbench.reference"), (path.name, name)


def test_cardbench_no_file_of_the_benchmark_imports_jax():
    for path in bench.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("repro", "jax", "jaxlib", "flax"), (path, name)
