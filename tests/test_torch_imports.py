"""The port stands alone: no JAX and nothing of the JAX package, and entry
points that run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.space import SchedulePlan
from repro_torch.kernels import _build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.launch import train
    from repro_torch.training.train_step import (
        make_prefill_step, make_serve_step, make_train_step,
    )
    from repro_torch.training.trainer import Trainer

    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_prefill_step(cfg, None, SchedulePlan())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_step(cfg, None, SchedulePlan())
    params = transformer.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-3-2b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, None, SchedulePlan())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, None, SchedulePlan())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "2"]) == 0
    assert "completed 3/3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_serve_cli_runs_the_moe_and_mamba_archs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "2"]) == 0
    assert "completed 3/3 requests" in capsys.readouterr().out


def test_kernel_build_is_keyed_on_source_into_an_ignored_directory():
    for name in ("rmsnorm", "flash_attention", "moe_gemm", "selective_scan", "quantize"):
        path = _build.library_path(name)
        assert path.parent == ROOT / "build" / "repro_torch"
        assert path == _build.library_path(name)  # deterministic
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_the_measurement_modules_are_among_the_scanned_files():
    """The measurement layer (core/measure*.py, launch/measure.py and the
    stub CLI) is held to the same no-JAX rule as the rest of the port."""
    for rel in ("core/measure.py", "core/measure_stub.py", "core/measure_fleet.py",
                "launch/measure.py", "launch/dryrun_stub.py"):
        assert PORT / rel in PORT_FILES


def test_the_distribution_modules_are_among_the_scanned_files():
    """The distribution layer (rules, collectives, the parallel context, the
    mesh, the int8 ring) is held to the same no-JAX rule, and imports with
    no process group or device touched."""
    for rel in ("sharding/rules.py", "sharding/collectives.py", "sharding/parallel.py",
                "launch/mesh.py", "training/grad_compress.py"):
        assert PORT / rel in PORT_FILES
    import torch.distributed as dist

    from repro_torch.launch import mesh  # noqa: F401
    from repro_torch.sharding import collectives, parallel, rules  # noqa: F401
    from repro_torch.training import grad_compress  # noqa: F401

    assert not dist.is_initialized()
