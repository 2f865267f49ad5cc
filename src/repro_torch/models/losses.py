"""Losses: next-token cross-entropy with an f32 logsumexp, optional z-loss.

The counterpart of the JAX package's ``models/losses.py``.
"""
from __future__ import annotations

import torch


def cross_entropy(
    logits: torch.Tensor,  # (..., V)
    labels: torch.Tensor,  # (...,) integer
    *,
    z_loss: float = 0.0,
) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll.mean()


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted LM loss: predict tokens[t+1] from logits[t]."""
    return cross_entropy(logits[:, :-1, :], tokens[:, 1:])
