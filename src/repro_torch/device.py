"""Where the port's entry points run.

Entry points default to ``device="cuda"``.  On a machine without a CUDA
device they raise rather than quietly run on the CPU; the CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.  The
``meta`` device holds shapes and no data: the dry run
(``launch/dryrun_impl.py``) builds its steps there.
"""
from __future__ import annotations

import ctypes
import os
import time

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu' (and dry runs on 'meta'), "
                         f"not {dev.type!r}")
    return dev


# this process's CUDA context: its creation's seconds and the card memory it
# took, recorded once by ``open_context`` (a context is per process, so the
# record is too)
CONTEXT: dict = {}


class _Memory(ctypes.Structure):  # nvmlMemory_t
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


def nvml_used_bytes(index: int):
    """Device memory in use on card ``index`` as NVML counts it (every
    process's), read without creating a CUDA context; None where NVML
    cannot be loaded."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    lib.nvmlInit_v2.argtypes = []
    lib.nvmlShutdown.argtypes = []
    lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    lib.nvmlDeviceGetMemoryInfo.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Memory)]
    for fn in (lib.nvmlInit_v2, lib.nvmlShutdown, lib.nvmlDeviceGetHandleByIndex_v2,
               lib.nvmlDeviceGetMemoryInfo):
        fn.restype = ctypes.c_int  # nvmlReturn_t: 0 is success
    if lib.nvmlInit_v2() != 0:
        return None
    try:
        handle, mem = ctypes.c_void_p(), _Memory()
        if (lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)) != 0
                or lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem)) != 0):
            return None
        return int(mem.used)
    finally:
        lib.nvmlShutdown()


def open_context(dev: torch.device) -> dict:
    """Make sure this process has a CUDA context on ``dev`` (a no-op on the
    CPU), and, when this call creates it, record what it cost in
    ``CONTEXT``: ``seconds`` and ``bytes``, the rise in the card's used
    memory (NVML, all processes: another process allocating at the same
    moment adds to it).  A context made earlier by other code is recorded
    as ``{"preexisting": True}``."""
    if dev.type != "cuda" or CONTEXT:
        return CONTEXT
    if torch.cuda.is_initialized():
        CONTEXT["preexisting"] = True
        return CONTEXT
    index = dev.index if dev.index is not None else 0
    used0 = nvml_used_bytes(index)
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    used1 = nvml_used_bytes(index)
    CONTEXT.update(pid=os.getpid(), seconds=seconds,
                   bytes=None if used0 is None or used1 is None else used1 - used0)
    return CONTEXT
