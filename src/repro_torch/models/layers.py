"""Shared layer primitives: norms, positional encodings, activations, init."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm(x: torch.Tensor, w: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    if kind == "rmsnorm":
        return ops.rmsnorm(x, w, eps=eps)
    # layernorm (no bias, like most modern stacks)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    if kind == "silu":
        return F.silu(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard and partial; split-half, not interleaved)
# ---------------------------------------------------------------------------
def _rope_freqs(rot_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)


def _apply_rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, R); cos/sin: (B, 1, S, R/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(
    x: torch.Tensor,  # (B, H, S, D)
    positions: torch.Tensor,  # (B, S) int
    theta: float,
    rotary_pct: float = 1.0,
) -> torch.Tensor:
    D = x.shape[-1]
    rot_dim = int(D * rotary_pct)
    rot_dim -= rot_dim % 2
    freqs = _rope_freqs(rot_dim, theta, x.device)  # (rot_dim/2,)
    ang = positions.float()[:, None, :, None] * freqs  # (B,1,S,R/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    xr = _apply_rot(xr.float(), cos, sin).to(x.dtype)
    return torch.cat([xr, xp], dim=-1) if rot_dim < D else xr


def apply_positions(q, k, cfg, positions):
    """Rotate q/k according to cfg.pos_kind ('rope'); else identity."""
    if cfg.pos_kind == "rope":
        return (
            rope(q, positions, cfg.rope_theta, cfg.rotary_pct),
            rope(k, positions, cfg.rope_theta, cfg.rotary_pct),
        )
    if cfg.pos_kind == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet: ROADMAP item A2")
    return q, k


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device, scale: float = 0.02) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)
