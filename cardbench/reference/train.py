"""A training step in plain float32: the loss, every gradient, and AdamW
with the configuration's moments.

The step runs layer by layer so that it fits beside a 7 B model's weights
on one card: a forward without autograd keeps each layer's input, then
each layer is run again under autograd from its input, last first, and
back-propagated.  Weights stay in the dtype they are stored in and are cast
to float32 one period at a time; gradients are float32.

AdamW follows the equations the benchmark's traffic file states: linear
warm-up then cosine decay, the gradients clipped by their global norm,
bias-corrected moments, decoupled weight decay on leaves of two or more
axes, the new weight rounded to its stored dtype, and the moments of a leaf
of two or more axes whose last axis has at least 16 elements kept as
rowwise int8 codes and scales when ``moment_dtype`` is int8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

import torch

from cardbench.reference import model as M
from cardbench.reference.ops import cross_entropy, dequantize_rows, quantize_rows


def leaves(tree: dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def loss_and_grads(params: dict, m: M.Model, inputs: torch.Tensor, labels: torch.Tensor,
                   prec: str = "float32"):
    """``(loss, {path: float32 gradient})`` of the next-token loss
    (``labels[:, 1:]`` from ``logits[:, :-1]``) over ``inputs (B, S)``."""
    B, S = inputs.shape
    positions = torch.arange(S, device=inputs.device)[None].expand(B, S)
    grads = {path: torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
             for path, leaf in leaves(params)}
    layers = M.slots(m)
    with torch.no_grad():
        h = params["embed"][inputs].float()
        kept = []
        for p, i, slot in layers:
            kept.append(h)
            h = M.layer(M.period_slice(params["blocks"][f"b{i}"], p), m, slot, h, positions, prec)
    top = {k: params[k].detach().float().requires_grad_()  # a tensor of its own: its .grad is this step's
           for k in ("final_norm", "embed" if m.tie_embeddings else "head")}
    h = h.requires_grad_()
    with torch.enable_grad():
        out = M.logits(top, m, h, prec)
        loss = cross_entropy(out[:, :-1], labels[:, 1:])
        loss.backward()
    for k, t in top.items():
        grads[k] += t.grad
    gh = h.grad
    del top, out, h
    for (p, i, slot), x in zip(reversed(layers), reversed(kept)):
        w = M.period_slice(params["blocks"][f"b{i}"], p)
        named = dict(leaves(w))
        for t in named.values():
            t.requires_grad_()
        x = x.requires_grad_()
        with torch.enable_grad():
            M.layer(w, m, slot, x, positions, prec).backward(gh)
        for path, t in named.items():
            grads[f"blocks.b{i}.{path}"][p] += t.grad
        gh = x.grad
        kept.pop()
    grads["embed"].index_add_(0, inputs.reshape(-1), gh.reshape(-1, gh.shape[-1]))
    return loss.detach(), grads


@dataclasses.dataclass(frozen=True)
class AdamW:
    peak_lr: float
    warmup_steps: int
    total_steps: int
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip_norm: float
    moment_dtype: str  # float32 | int8

    def lr(self, step: int, device) -> torch.Tensor:
        s = torch.tensor(float(step), device=device)
        if step < self.warmup_steps:
            return self.peak_lr * s / max(self.warmup_steps, 1)
        prog = torch.clamp((s - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        return self.peak_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))

    def int8(self, shape) -> bool:
        return self.moment_dtype == "int8" and len(shape) >= 2 and shape[-1] >= 16


def moment_zeros(params: dict, oc: AdamW) -> Dict[str, object]:
    def zero(leaf):
        if oc.int8(leaf.shape):
            return (torch.zeros(leaf.shape, dtype=torch.int8, device=leaf.device),
                    torch.zeros(leaf.shape[:-1] + (1,), dtype=torch.float32, device=leaf.device))
        return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)

    return {"mu": {p: zero(t) for p, t in leaves(params)},
            "nu": {p: zero(t) for p, t in leaves(params)}}


def moment_value(mom, index=...) -> torch.Tensor:
    """A moment's float32 value (its int8 codes times their scales)."""
    if isinstance(mom, tuple):
        return dequantize_rows(mom[0][index], mom[1][index])
    return mom[index]


def _store(mom, index, value: torch.Tensor) -> None:
    if isinstance(mom, tuple):
        q, s = quantize_rows(value)
        mom[0][index] = q
        mom[1][index] = s
    else:
        mom[index] = value


@torch.no_grad()
def adamw_step(params: dict, grads: Dict[str, torch.Tensor], state: dict, oc: AdamW, step: int):
    """One AdamW step (``step`` counts from 1) in place on ``params`` and
    ``state``; returns the global gradient norm."""
    device = grads["final_norm"].device
    gnorm = torch.sqrt(sum(torch.linalg.vector_norm(g) ** 2 for g in grads.values()))
    scale = torch.clamp(oc.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = oc.lr(step, device)
    bc1 = 1.0 - oc.b1 ** torch.tensor(float(step), device=device)
    bc2 = 1.0 - oc.b2 ** torch.tensor(float(step), device=device)
    for path, p in leaves(params):
        g_all, mu, nu = grads[path], state["mu"][path], state["nu"][path]
        for index in (range(p.shape[0]) if p.ndim >= 3 else [...]):  # a period at a time
            g = g_all[index] * scale
            m = oc.b1 * moment_value(mu, index) + (1 - oc.b1) * g
            v = oc.b2 * moment_value(nu, index) + (1 - oc.b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
            if p.ndim >= 2:
                delta = delta + oc.weight_decay * p[index].float()
            p[index] = (p[index].float() - lr * delta).to(p.dtype)
            _store(mu, index, m)
            _store(nu, index, v)
    return gnorm
