"""RMSNorm: the CUDA kernels' wrappers, their launch counters and their plain versions.

Replaces the Pallas TPU kernel ``rmsnorm`` of ``src/repro/kernels/rmsnorm.py``
(``pallas_call`` at line 45, body ``_kernel`` at line 17), and gives it the
backward the JAX package takes with ``jax.vjp`` of ``ref.rmsnorm``.  Both
kernels are ``csrc/rmsnorm.cu``: bound by bytes, a row to a warp (or to a
small group of warps for wide rows) held in registers, reduced with
shuffles and written once; the backward's ``dw`` is reduced through
per-block partial rows and a second, column-wise kernel (deterministic, no
atomics).

A CPU tensor takes the plain version (``ref.rmsnorm`` /
``ref.rmsnorm_backward``); a CUDA tensor launches the kernel or raises; a
meta tensor runs the CUDA branch's checks and allocations and records the
launch instead of making it (``work.dry_launch``: the dry run).
Where autograd records (grad enabled and an input that requires grad), the
forward goes through ``RMSNormFn``, which saves ``x`` and ``w`` and whose
backward launches the backward kernel (``rmsnorm_backward``).  ``LAUNCHES``
counts forward launches, ``BWD_LAUNCHES`` backward ones (each of those is
two kernels: ``dx`` with the partial ``dw`` rows, then their sum).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain
from repro_torch.kernels.ref import rmsnorm_backward as rmsnorm_backward_plain

LAUNCHES = _build.LaunchCounter("rmsnorm")
BWD_LAUNCHES = _build.LaunchCounter("rmsnorm_backward")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_ARGS = (_P, _P, _P, _LL, _I, _F, _I, _I, _P)
_BWD_ARGS = (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _F, _I, _I, _P)
# what a row may hold (csrc/rmsnorm.cu): 8 warps x 8 vectors of 16 bytes a
# thread, or 8 warps x 16 elements a thread on the ragged path
_VEC_BYTES_MAX = 8 * 32 * 8 * 16
_SCALAR_MAX = 8 * 32 * 16
_PARTIAL_ROWS = 1024  # backward: at most this many blocks' partial dw rows


class RMSNormFn(torch.autograd.Function):
    """``launch(x, w)`` forward; ``launch_backward(x, w, gy) -> (dx, dw)`` backward.

    Saves only ``x`` and ``w``: ``inv`` is recomputed per row.  On the card
    both are the kernels; the tests pass the plain versions to check the
    Function on the CPU.
    """

    @staticmethod
    def forward(ctx, x, w, launch, launch_backward):
        ctx.save_for_backward(x, w)
        ctx.launch_backward = launch_backward
        return launch(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw = ctx.launch_backward(x, w, gy.contiguous())
        return (gx if ctx.needs_input_grad[0] else None,
                gw if ctx.needs_input_grad[1] else None, None, None)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x (..., d)``, ``w (d,)`` -> ``x * rsqrt(mean(x^2) + eps) * w`` in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    vec = _check(x, w, "rmsnorm")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, lambda a, b: _launch(a, b, eps, vec),
                               lambda a, b, g: rmsnorm_backward(a, b, g, eps=eps))
    return _launch(x, w, eps, vec)


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor, *, eps: float = 1e-6):
    """``(dx, dw)`` of ``rmsnorm(x, w)`` for the output gradient ``gy``:
    ``dx`` in x.dtype, ``dw`` in w.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_backward_plain(x, w, gy, eps=eps)
    vec = _check(x, w, "rmsnorm_backward")
    if (gy.dtype != x.dtype or gy.shape != x.shape or gy.device != x.device
            or not gy.is_contiguous()):
        raise ValueError(f"rmsnorm_backward: gy must be a contiguous {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}; got {tuple(gy.shape)} {gy.dtype} on {gy.device}")
    vec = vec and gy.data_ptr() % 16 == 0
    d = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    partial = torch.empty((min(rows, _PARTIAL_ROWS), d), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        needs = (x.requires_grad, w.requires_grad) if x.requires_grad or w.requires_grad else (True, True)
        plain = work.autograd_products(("rmsnorm", work.signature(x, w), eps, needs),
                                       lambda a, b: rmsnorm_plain(a, b, eps=eps), (x, w), needs, gy)
        work.dry_launch(BWD_LAUNCHES.name, work.rmsnorm_backward(x.numel(), d, _NAMES[x.dtype]), plain)
        return dx, dw
    lib, fn = _build.launcher("rmsnorm", "rmsnorm_backward_launch", _BWD_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), gy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
             partial.data_ptr(), partial.shape[0], rows, d, eps, _DTYPE_CODES[x.dtype], vec,
             _build.stream(x))
    if err:
        _build.check(lib, "rmsnorm", err)
    BWD_LAUNCHES.add()
    return dx, dw


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> bool:
    """Raise on what the kernels do not take; return whether rows are read
    in 16-byte vectors (a width of whole vectors, x and w 16-byte aligned;
    an output from ``torch.empty_like`` is aligned by the allocator)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on cuda, cpu or meta tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes float32 or bfloat16, not {x.dtype}")
    d = x.shape[-1]
    if w.dtype != x.dtype or w.device != x.device or w.shape != (d,):
        raise ValueError(
            f"{name} weight must be ({d},) {x.dtype} on {x.device}; got "
            f"{tuple(w.shape)} {w.dtype} on {w.device}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous x and w")
    esize = x.element_size()
    vec = d * esize % 16 == 0 and (x.data_ptr() | w.data_ptr()) % 16 == 0
    if d > (_VEC_BYTES_MAX // esize if vec else _SCALAR_MAX):
        raise ValueError(f"{name} kernel holds a row in registers: d={d} in {x.dtype} is too wide")
    return vec


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float, vec: bool) -> torch.Tensor:
    d = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    if x.device.type == "meta":
        plain = work.plain_products(("fwd", ("rmsnorm", work.signature(x, w), eps, (True, True))),
                                    lambda: rmsnorm_plain(x, w, eps=eps))
        work.dry_launch(LAUNCHES.name, work.rmsnorm(x.numel(), d, _NAMES[x.dtype]), plain)
        return y
    lib, fn = _build.launcher("rmsnorm", "rmsnorm_launch", _FWD_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, eps, _DTYPE_CODES[x.dtype], vec,
             _build.stream(x))
    if err:
        _build.check(lib, "rmsnorm", err)
    LAUNCHES.add()
    return y
