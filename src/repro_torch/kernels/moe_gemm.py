"""Grouped MoE GEMM: the CUDA kernel's wrapper, its launch counter and its plain version.

Replaces the Pallas TPU kernel ``moe_gemm`` of ``src/repro/kernels/moe_gemm.py``
(``pallas_call`` at line 69, body ``_kernel`` at line 30): ``x (E,C,d) .
w (E,d,f) -> (E,C,f)``, f32 accumulation over ``d``, output in ``x.dtype``.
The kernel is ``csrc/moe_gemm.cu``: about as bound by bytes as by
operations at the prefill shapes and by the weights' bytes at decode; bf16
is a TMA -> wgmma pipeline (a producer warpgroup streams ``d`` 64 deep into
a ring of shared-memory stages, consumer warpgroups multiply on the tensor
cores with f32 accumulators in registers); f32 runs in true f32 (no TF32).

Either operand may be given as stored transposed: ``x_t`` means ``x`` is
``(E, d, C)`` and the product uses ``x^T``, ``w_t`` means ``w`` is ``(E, f,
d)``.  The bf16 kernel reads a transposed operand as it lies in memory; the
f32 kernel takes contiguous operands, so the wrapper copies a transposed
one for it.

The tile is the caller's: ``kernels/geometry.moe_gemm_launch`` applies the
JAX kernel's clamp (``min(block, dim)``), raises ``ValueError`` where the JAX
kernel asserts divisibility or the tile does not fit a Hopper block, and
changes nothing else.  ``LAUNCHES.tiles`` records every tile launched since
the last reset.

A CPU tensor takes the plain version (``ref.moe_gemm``, with the same
layout flags); a CUDA tensor launches the kernel or raises; a meta tensor
runs the CUDA branch's checks (the tile against the shapes included) and
allocations and records the launch instead of making it
(``work.dry_launch``: the dry run).  Where autograd
records (grad enabled and an input that requires grad), the launch goes
through ``MoeGemmFn``, whose backward is two more grouped GEMMs of the same
form, each a launch of the same kernel with the same tile, on the saved
operands as they are stored: ``dx = dy . w^T`` with ``w`` read transposed
and ``dw = x^T . dy`` with ``x`` read transposed; nothing is copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.geometry import moe_gemm_launch
from repro_torch.kernels.ref import moe_gemm as moe_gemm_plain

LAUNCHES = _build.LaunchCounter("moe_gemm")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 12 + (ctypes.c_void_p,)


def moe_gemm(
    x: torch.Tensor,  # (E, C, d), or (E, d, C) with x_t
    w: torch.Tensor,  # (E, d, f), or (E, f, d) with w_t
    *,
    block_c: int = 128,
    block_f: int = 128,
    block_d: int = 256,
    x_t: bool = False,
    w_t: bool = False,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w, x_t=x_t, w_t=w_t)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gemm runs on cuda, cpu or meta tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"moe_gemm kernel takes float32 or bfloat16, not {x.dtype}")
    E = x.shape[0]
    d = x.shape[1] if x_t else x.shape[2]
    want = (E, None, d) if w_t else (E, d, None)
    if (w.dtype != x.dtype or w.device != x.device or w.ndim != 3
            or any(a is not None and a != b for a, b in zip(want, w.shape))):
        raise ValueError(
            f"w must be {'(E, f, d)' if w_t else '(E, d, f)'} with E={E}, d={d}, {x.dtype} on "
            f"{x.device}; got {tuple(w.shape)} {w.dtype} on {w.device}"
        )
    tile = (block_c, block_f, block_d)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGemmFn.apply(x, w, x_t, w_t, lambda a, b, at, bt: _launch(a, b, tile, at, bt))
    return _launch(x, w, tile, x_t, w_t)


class MoeGemmFn(torch.autograd.Function):
    """``gemm(x, w)`` forward; backward ``dx = gemm(dy, w^T)``, ``dw = gemm(x^T, dy)``.

    ``gemm(a, b, a_t, b_t)`` multiplies ``a`` and ``b`` as stored, each read
    transposed where its flag is set, so the backward hands the kernel the
    saved operands and their layouts, never a transposed copy.  A forward
    on a transposed operand takes the transposed form of its gradient.
    ``gemm`` is the kernel on the card (the tests pass the plain version to
    check the formulas on the CPU).
    """

    @staticmethod
    def forward(ctx, x, w, x_t, w_t, gemm):
        ctx.save_for_backward(x, w)
        ctx.x_t, ctx.w_t, ctx.gemm = x_t, w_t, gemm
        return gemm(x, w, x_t, w_t)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        x_t, w_t, gemm = ctx.x_t, ctx.w_t, ctx.gemm
        gy = gy.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:  # dX = dY.W^T, or dX^T = W.dY^T for an x stored (E,d,C)
            gx = gemm(w, gy, w_t, True) if x_t else gemm(gy, w, False, not w_t)
        if ctx.needs_input_grad[1]:  # dW = X^T.dY, or dW^T = dY^T.X for a w stored (E,f,d)
            gw = gemm(gy, x, True, x_t) if w_t else gemm(x, gy, not x_t, False)
        return gx, gw, None, None, None


def _launch(x, w, tile, x_t: bool, w_t: bool) -> torch.Tensor:
    if x.dtype == torch.float32 and (x_t or w_t):  # the f32 kernel takes contiguous operands
        x = x.transpose(1, 2).contiguous() if x_t else x
        w = w.transpose(1, 2).contiguous() if w_t else w
        x_t = w_t = False
    E = x.shape[0]
    C, d = (x.shape[2], x.shape[1]) if x_t else (x.shape[1], x.shape[2])
    f = w.shape[1] if w_t else w.shape[2]
    launch = moe_gemm_launch(E, C, d, f, _DTYPE_NAMES[x.dtype], *tile, x_t=x_t, w_t=w_t)
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    for name, t in (("x", x), ("w", w), ("out", out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_gemm kernel takes contiguous, 16-byte aligned {name}")
    if x.device.type == "meta":
        plain = work.plain_products(("fwd", ("moe_gemm", work.signature(x, w), x_t, w_t)),
                                    lambda: moe_gemm_plain(x, w, x_t=x_t, w_t=w_t))
        work.dry_launch(LAUNCHES.name, work.moe_gemm(E, C, d, f, _DTYPE_NAMES[x.dtype]), plain,
                        tile=(launch.block_c, launch.block_f, launch.block_d))
        return out
    lib, fn = _build.launcher("moe_gemm", "moe_gemm_launch", _ARGS)
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
        launch.block_c, launch.block_f, launch.block_d, launch.threads, launch.smem_bytes,
        _DTYPE_CODES[x.dtype], int(x_t), int(w_t),
        _build.stream(x),
    )
    if err:
        _build.check(lib, "moe_gemm", err)
    LAUNCHES.add(tile=(launch.block_c, launch.block_f, launch.block_d))
    return out
