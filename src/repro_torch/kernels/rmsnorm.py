"""RMSNorm: the CUDA kernel's wrapper, its launch counter and its plain version.

Replaces the Pallas TPU kernel ``rmsnorm`` of ``src/repro/kernels/rmsnorm.py``
(``pallas_call`` at line 45, body ``_kernel`` at line 17).  The kernel is
``csrc/rmsnorm.cu``: bound by bytes (one read and one write per element, a
few operations each), so it reads each row once with 16-byte vector loads,
reduces the f32 sum of squares in registers and shuffles, and writes the row
once; a ragged width is masked, never padded.

A CPU tensor takes the plain version (``ref.rmsnorm``); a CUDA tensor
launches the kernel or raises.  Where autograd records (grad enabled and an
input that requires grad), the launch goes through ``RMSNormFn``: the JAX
package has no backward kernel for RMSNorm, so its backward recomputes the
plain version from the saved ``x`` and ``w`` and returns its gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

LAUNCHES = _build.LaunchCounter("rmsnorm")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


class RMSNormFn(torch.autograd.Function):
    """``launch(x, w)`` forward; backward by recompute through ``ref.rmsnorm``.

    Saves only ``x`` and ``w``.  ``launch`` is the kernel on the card (the
    tests pass the plain version to check the backward on the CPU).
    """

    @staticmethod
    def forward(ctx, x, w, eps, launch):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return launch(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd, wd = x.detach().requires_grad_(), w.detach().requires_grad_()
            y = rmsnorm_plain(xd, wd, eps=ctx.eps)
            gx, gw = torch.autograd.grad(y, (xd, wd), gy)
        return gx, gw, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x (..., d)``, ``w (d,)`` -> ``x * rsqrt(mean(x^2) + eps) * w`` in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"rmsnorm kernel takes float32 or bfloat16, not {x.dtype}")
    if w.dtype != x.dtype or w.device != x.device or tuple(w.shape) != (d,):
        raise ValueError(
            f"rmsnorm weight must be ({d},) {x.dtype} on {x.device}; got "
            f"{tuple(w.shape)} {w.dtype} on {w.device}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and w")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, eps, lambda a, b: _launch(a, b, eps))
    return _launch(x, w, eps)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    d = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = int(
        d % (16 // x.element_size()) == 0
        and all(t.data_ptr() % 16 == 0 for t in (x, w, y))
    )
    lib, fn = _launcher()
    err = fn(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
        _DTYPE_CODES[x.dtype], vec, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, "rmsnorm", err)
    LAUNCHES.add()
    return y
