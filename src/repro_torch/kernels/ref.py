"""Plain PyTorch versions of the ported kernels.

The same arithmetic as the JAX package's oracles (``repro/kernels/ref.py``):
the CPU path of every wrapper, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    groups = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(groups, dim=1).float()
    vv = v.repeat_interleave(groups, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) * scale
    if causal:
        # queries are the LAST S positions of the Skv-long key sequence
        qpos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vv)
    return out.to(q.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)
