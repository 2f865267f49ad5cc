"""Losses: next-token cross-entropy with an f32 logsumexp, optional z-loss.

The counterpart of the JAX package's ``models/losses.py``.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import collectives as cc


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


def cross_entropy_vocab_parallel(
    logits: torch.Tensor,  # (..., V / n): this rank's slice of the vocabulary
    labels: torch.Tensor,  # (...,) integer, over the whole vocabulary
    mesh,
    axes="model",
    *,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """``cross_entropy`` of logits split over ``axes`` by vocabulary (rank
    ``i`` holds ids ``[i V/n, (i+1) V/n)``), without gathering them: the
    row max and the sum of exponentials add up over the group, and the gold
    logit comes from the rank that holds it.  Every rank gets the same
    value; each rank's gradient is its slice's."""
    lf = logits.float()
    v_loc = lf.shape[-1]
    m = cc.all_reduce_max(lf.amax(dim=-1, keepdim=True), mesh, axes)
    lse = torch.log(cc.all_reduce_sum(torch.exp(lf - m).sum(dim=-1), mesh, axes)) + m[..., 0]
    local = labels.long() - mesh.index(axes) * v_loc
    hit = (local >= 0) & (local < v_loc)
    gold = torch.gather(lf, -1, torch.where(hit, local, 0)[..., None])[..., 0]
    gold = cc.all_reduce_sum(torch.where(hit, gold, 0.0), mesh, axes)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll.mean()


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted LM loss: predict tokens[t+1] from logits[t]."""
    return cross_entropy(logits[:, :-1, :], tokens[:, 1:])
