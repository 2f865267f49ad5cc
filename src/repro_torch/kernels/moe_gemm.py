"""Grouped MoE GEMM: the CUDA kernel's wrapper, its launch counter and its plain version.

Replaces the Pallas TPU kernel ``moe_gemm`` of ``src/repro/kernels/moe_gemm.py``
(``pallas_call`` at line 69, body ``_kernel`` at line 30): ``x (E,C,d) .
w (E,d,f) -> (E,C,f)``, f32 accumulation over ``d`` in ``block_d`` steps,
output in ``x.dtype``.  The kernel is ``csrc/moe_gemm.cu``: about as bound
by bytes as by operations at the prefill shapes and by the weights' bytes at
decode; bf16 runs on the tensor cores (``mma.sync``, f32 accumulate) with
the f32 accumulator in registers across the ``block_d`` loop; f32 runs in
true f32 (no TF32).

The tile is the caller's: ``kernels/geometry.moe_gemm_launch`` applies the
JAX kernel's clamp (``min(block, dim)``), raises ``ValueError`` where the JAX
kernel asserts divisibility or the tile does not fit a Hopper block, and
changes nothing else.  ``LAUNCHES.tiles`` records every tile launched since
the last reset.

A CPU tensor takes the plain version (``ref.moe_gemm``); a CUDA tensor
launches the kernel or raises.  Where autograd records (grad enabled and an
input that requires grad), the launch goes through ``MoeGemmFn``, whose
backward is two more grouped GEMMs of the same form, each a launch of the
same kernel with the same tile: ``dx = dy . w^T`` as ``(E,C,f) . (E,f,d)``
and ``dw = x^T . dy`` as ``(E,d,C) . (E,C,f)``, on transposed copies made
contiguous first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.geometry import moe_gemm_launch
from repro_torch.kernels.ref import moe_gemm as moe_gemm_plain

LAUNCHES = _build.LaunchCounter("moe_gemm")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _launcher():
    lib = _build.load("moe_gemm")
    fn = lib.moe_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def moe_gemm(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
    *,
    block_c: int = 128,
    block_f: int = 128,
    block_d: int = 256,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"moe_gemm kernel takes float32 or bfloat16, not {x.dtype}")
    E, C, d = x.shape
    if w.dtype != x.dtype or w.device != x.device or w.ndim != 3 or tuple(w.shape[:2]) != (E, d):
        raise ValueError(
            f"w must be ({E}, {d}, f) {x.dtype} on {x.device}; got "
            f"{tuple(w.shape)} {w.dtype} on {w.device}"
        )
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGemmFn.apply(x, w, lambda a, b: _launch(a, b, block_c, block_f, block_d))
    return _launch(x, w, block_c, block_f, block_d)


class MoeGemmFn(torch.autograd.Function):
    """``gemm(x, w)`` forward; backward ``dx = gemm(dy, w^T)``, ``dw = gemm(x^T, dy)``.

    ``gemm`` is the kernel on the card, so the backward launches it twice
    (the tests pass the plain version to check the formulas on the CPU).
    """

    @staticmethod
    def forward(ctx, x, w, gemm):
        ctx.save_for_backward(x, w)
        ctx.gemm = gemm
        return gemm(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.contiguous()
        gx = ctx.gemm(gy, w.transpose(1, 2).contiguous()) if ctx.needs_input_grad[0] else None
        gw = ctx.gemm(x.transpose(1, 2).contiguous(), gy) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def _launch(x, w, block_c: int, block_f: int, block_d: int) -> torch.Tensor:
    E, C, d = x.shape
    f = w.shape[2]
    launch = moe_gemm_launch(E, C, d, f, _DTYPE_NAMES[x.dtype], block_c, block_f, block_d)
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    for name, t in (("x", x), ("w", w), ("out", out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_gemm kernel takes contiguous, 16-byte aligned {name}")
    lib, fn = _launcher()
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
        launch.block_c, launch.block_f, launch.block_d, launch.threads, launch.smem_bytes,
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, "moe_gemm", err)
    LAUNCHES.add(tile=(launch.block_c, launch.block_f, launch.block_d))
    return out
