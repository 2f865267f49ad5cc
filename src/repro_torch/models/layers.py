"""Shared layer primitives: norms, positional encodings, activations, init."""
from __future__ import annotations

import math

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
# Rotary embeddings (standard, partial, and Qwen2-VL multimodal M-RoPE;
# split-half, not interleaved)
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


def mrope(
    x: torch.Tensor,  # (B, H, S, D)
    positions: torch.Tensor,  # (B, 3, S) int: temporal / height / width
    theta: float,
    sections=(16, 24, 24),  # half-dim split (Qwen2-VL: 16+24+24 = 64 = D/2)
) -> torch.Tensor:
    """Each section of the rotary half-dim takes its angle from one position
    component; the f32 order of operations is ``rope``'s."""
    D = x.shape[-1]
    half = D // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to half of head_dim {D}")
    freqs = _rope_freqs(D, theta, x.device)  # (half,)
    ang = positions.float()[..., None] * freqs  # (B, 3, S, half)
    parts, off = [], 0
    for comp, sec in enumerate(sections):
        parts.append(ang[:, comp, :, off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)[:, None]  # (B, 1, S, half)
    return _apply_rot(x.float(), torch.cos(ang), torch.sin(ang)).to(x.dtype)


def sinusoidal_pe(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(B, S) -> (B, S, d) f32: the classic transformer sinusoid (MusicGen)."""
    half = d_model // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * idx / half)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_positions(q, k, cfg, positions):
    """Rotate q/k according to cfg.pos_kind ('rope'/'mrope'); else identity."""
    if cfg.pos_kind == "rope":
        return (
            rope(q, positions, cfg.rope_theta, cfg.rotary_pct),
            rope(k, positions, cfg.rope_theta, cfg.rotary_pct),
        )
    if cfg.pos_kind == "mrope":
        secs = mrope_sections(cfg.resolved_head_dim)
        return (
            mrope(q, positions, cfg.rope_theta, secs),
            mrope(k, positions, cfg.rope_theta, secs),
        )
    return q, k


def mrope_sections(head_dim: int):
    """The (temporal, height, width) split of the rotary half-dim."""
    half = head_dim // 2
    if half == 64:
        return (16, 24, 24)  # Qwen2-VL published split
    t = half // 4
    rest = half - t
    h = rest // 2
    return (t, h, rest - h)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device, scale: float = 0.02) -> torch.Tensor:
    """N(0, scale^2) weights in ``dtype``, drawn in f32.  A stacked leaf (3-D
    and more) is drawn one period at a time, so that its f32 draw never
    exists whole: deepseek-67b's ``w_up`` at 40 layers is 27 GiB in f32."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if len(shape) > 2 else (out,)):
        part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32, device=device).mul_(scale))
    return out
