"""Primitives of the reference: products at a stated precision, norms,
rotary positions, the loss and the rowwise int8 rule.

Everything computes in float32 with TF32 off (``strict_float32``).  The
``float8`` precision is the control: each operand of a product is rounded
to float8 e4m3 under a per-tensor scale (amax / 448), the usual recipe of
an fp8 GEMM, and the product accumulates in float32.  Its gradient passes
the rounding straight through.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "float8")
E4M3_MAX = 448.0


def strict_float32() -> None:
    """Products in true float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "float8":
        return _Float8.apply(x)
    raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` with both operands at ``precision``, accumulated in float32."""
    return operand(a, precision) @ operand(b, precision)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions, split-half (not interleaved), over the whole head.
    ``x (..., S, D)``, ``positions`` broadcastable to ``(..., S)``."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp - gold`` over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def quantize_rows(x: torch.Tensor):
    """Rowwise symmetric int8 over the last axis: ``scale = amax / 127`` (1
    where the row is zero), codes ``round(x / scale)`` half to even within
    +-127.  Returns ``(codes int8, scale float32 (..., 1))``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.tensor(127.0, device=x.device), 1.0)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
