"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled for ``sm_90a`` at first use into ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``).  A library's file name
carries a hash of its source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  ``build`` starts one ``nvcc`` per
missing library, all at once.  A failed compile raises with ``nvcc``'s
stderr; there is no other path to the kernel.  ``launcher`` resolves a
library's launch function once, with its ``argtypes`` and ``restype`` set,
so that a wrapper's launch costs a dictionary lookup and the ctypes call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[str, Tuple[ctypes.CDLL, Any]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when the library was built."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every missing library of ``names`` in parallel; return their paths."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = paths[n].with_name(f"{paths[n].name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ))
        errors = []
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{err}{out}")
                continue
            paths[n].with_suffix(".ptxas.txt").write_text(out + err)
            os.replace(tmp, paths[n])  # atomic: a reader never sees half a library
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


class LaunchCounter:
    """How many times a wrapper launched its kernel (never its plain version),
    and with which tiles."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.tiles: set = set()

    def add(self, tile=None) -> None:
        self.count += 1
        if tile is not None:
            self.tiles.add(tile)

    def reset(self) -> None:
        self.count = 0
        self.tiles = set()


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (its ``cudaGetLastError()``)."""
    if err:
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        msg = describe(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def launcher(name: str, symbol: str, argtypes: Sequence[Any], restype: Any = ctypes.c_int):
    """``(library, function)`` for ``symbol`` of ``csrc/<name>.cu``, built and
    loaded at the first call, its ``argtypes`` and ``restype`` set then and
    cached: later calls only look it up."""
    hit = _launchers.get(symbol)
    if hit is None:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        hit = _launchers[symbol] = (lib, fn)
    return hit


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device: what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
