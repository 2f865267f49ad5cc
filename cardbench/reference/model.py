"""The models' layers in plain float32, with autograd where training needs it.

``Model`` holds the sizes the reference reads from a configuration file
of ``cardbench/configs/``.  Weights are dicts of the benchmark's own leaves
(``cardbench/weights.py`` names them: ``blocks.b<i>.<mixer>.<leaf>``,
stacked over periods), cast to float32 one period at a time by the caller.

The equations follow the program's, which the configuration files state
where they depart from the published model: pre-norm blocks with an RMS
norm of eps ``norm_eps``; Mamba-1 with a causal depthwise conv, ``dt =
softplus(dt_raw @ dt_w + dt_b)`` and ``A = -exp(A_log)``; GQA attention with
split-half rotary positions; top-k MoE whose weights are renormalised over
the k, with a per-expert capacity that drops the pairs past it in
(token, k) order; SwiGLU MLPs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from cardbench.reference.ops import mm, rmsnorm, rope, softplus


@dataclasses.dataclass(frozen=True)
class Model:
    d_model: int
    n_layers: int
    vocab_size: int
    period: Tuple[Tuple[str, str], ...]  # (mixer, mlp) of each slot of the layer period
    norm_eps: float
    tie_embeddings: bool = False
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    d_ff: int = 0
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    capacity_block: int = 128  # the capacity's rounding where a group has this many tokens
    d_inner: int = 0
    ssm_state: int = 0
    dt_rank: int = 0
    conv_width: int = 4

    @classmethod
    def from_file(cls, cfg: dict) -> "Model":
        sizes = dict(cfg["sizes"])
        sizes["period"] = tuple(tuple(s) for s in sizes["period"])
        return cls(**sizes)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------
class Scan(torch.autograd.Function):
    """``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t``, ``y_t = <h_t, C_t> + D u_t``
    in float32, walked step by step over time; the backward in closed form,
    the adjoint ``g_t = gy_t C_t + exp(dt_{t+1} A) g_{t+1}`` walked back.
    ``u, dt (B, L, Di)``, ``A (Di, N)``, ``Bm, Cm (B, L, N)``, ``D (Di,)``."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D):
        a = torch.exp(dt[..., None] * A)  # (B, L, Di, N)
        h = (dt * u)[..., None] * Bm[:, :, None, :]
        hs, as_ = h.unbind(1), a.unbind(1)
        for t in range(1, len(hs)):
            hs[t].addcmul_(as_[t], hs[t - 1])
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, a, h)
        return torch.einsum("bldn,bln->bld", h, Cm) + u * D

    @staticmethod
    def backward(ctx, gy):
        u, dt, A, Bm, Cm, D, a, h = ctx.saved_tensors
        g = gy[..., None] * Cm[:, :, None, :]
        gs, as_ = g.unbind(1), a.unbind(1)
        for t in range(len(gs) - 2, -1, -1):
            gs[t].addcmul_(as_[t + 1], gs[t + 1])
        dC = torch.einsum("bld,bldn->bln", gy, h)
        dB = torch.einsum("bldn,bld->bln", g, dt * u)
        gB = torch.einsum("bldn,bln->bld", g, Bm)
        du = gB * dt + D * gy
        ddt = gB * u
        g.mul_(a)  # g_t a_t h_{t-1}: the decay's share of the gradient
        g[:, 1:].mul_(h[:, :-1])
        g[:, 0].zero_()
        ddt = ddt + torch.einsum("bldn,dn->bld", g, A)
        dA = torch.einsum("bldn,bld->dn", g, dt)
        return du, ddt, dA, dB, dC, (gy * u).sum(dim=(0, 1))


def conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: ``x (B, L, Di)``, ``w (K, Di)``."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + L] * w[i] for i in range(K)) + b


def mamba(p: dict, m: Model, x: torch.Tensor, prec: str) -> torch.Tensor:
    xi, z = mm(x, p["in_proj"], prec).chunk(2, dim=-1)
    xc = F.silu(conv_causal(xi, p["conv_w"], p["conv_b"]))
    dt_raw, Bm, Cm = torch.split(mm(xc, p["x_proj"], prec), [m.dt_rank, m.ssm_state, m.ssm_state],
                                 dim=-1)
    dt = softplus(mm(dt_raw, p["dt_w"], prec) + p["dt_b"])
    y = Scan.apply(xc, dt, -torch.exp(p["A_log"]), Bm.contiguous(), Cm.contiguous(), p["Dp"])
    return mm(y * F.silu(z), p["out_proj"], prec)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def qkv(p: dict, m: Model, x: torch.Tensor, positions: torch.Tensor, prec: str):
    """``x (..., S, d)`` -> rotated ``q (..., H, S, hd)``, ``k`` and ``v (..., Hkv, S, hd)``."""
    *lead, S, _ = x.shape
    hd = m.head_dim

    def heads(w, n):
        return mm(x, w, prec).reshape(*lead, S, n, hd).transpose(-3, -2)

    q, k, v = heads(p["wq"], m.n_heads), heads(p["wk"], m.n_kv_heads), heads(p["wv"], m.n_kv_heads)
    pos = positions[..., None, :]
    return rope(q, pos, m.rope_theta), rope(k, pos, m.rope_theta), v


def attend(q, k, v, qpos, kpos, prec: str) -> torch.Tensor:
    """Softmax attention of ``q (..., H, Sq, hd)`` over ``k, v (..., Hkv, Sk,
    hd)``: a query at position ``qpos`` sees the keys at ``kpos <= qpos``.
    Returns ``(..., Sq, H * hd)``."""
    H, Hkv, hd = q.shape[-3], k.shape[-3], q.shape[-1]
    g = H // Hkv
    qg = q.reshape(*q.shape[:-3], Hkv, g, q.shape[-2], hd)
    s = mm(qg, k.transpose(-1, -2)[..., None, :, :], prec) * hd ** -0.5
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v[..., None, :, :], prec)  # (..., Hkv, g, Sq, hd)
    o = o.reshape(*q.shape[:-3], H, q.shape[-2], hd).transpose(-3, -2)
    return o.reshape(*o.shape[:-2], H * hd)


def attention(p: dict, m: Model, x: torch.Tensor, positions: torch.Tensor, prec: str):
    """Causal self-attention over the whole sequence: ``x (B, S, d)``."""
    q, k, v = qkv(p, m, x, positions, prec)
    pos = positions[0]
    return mm(attend(q, k, v, pos, pos, prec), p["wo"], prec)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def swiglu(x, w_gate, w_up, w_down, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, prec)) * mm(x, w_up, prec), w_down, prec)


def capacity(n_tokens: int, m: Model) -> int:
    """Per-expert capacity of a group of ``n_tokens`` routed together,
    rounded up to ``capacity_block`` (to 8 in a smaller group)."""
    block = m.capacity_block if n_tokens >= m.capacity_block else 8
    c = max(int(n_tokens * m.experts_per_token * m.capacity_factor / m.n_experts), block)
    return (c + block - 1) // block * block


def moe(p: dict, m: Model, x: torch.Tensor, prec: str) -> torch.Tensor:
    """Top-k MoE of ``x (G, T, d)``: each of the G groups of T tokens is
    routed together, each expert taking at most ``capacity(T)`` of a group's
    pairs in (token, k) order."""
    G, T, d = x.shape
    k = m.experts_per_token
    probs = torch.softmax(x @ p["router"], dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)  # (G, T, k)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(topi.reshape(G, T * k), m.n_experts)  # a group's pairs in (token, k) order
    place = (onehot.cumsum(1) * onehot).sum(-1) - 1  # the pair's place among its expert's
    keep = (place < capacity(T, m)).reshape(G, T, k)
    xt, y = x.reshape(G * T, d), torch.zeros((G * T, d), dtype=x.dtype, device=x.device)
    topi, topw, keep = topi.reshape(G * T, k), topw.reshape(G * T, k), keep.reshape(G * T, k)
    for e in range(m.n_experts):
        tok, j = torch.nonzero((topi == e) & keep, as_tuple=True)
        if tok.numel():
            out = swiglu(xt[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e], prec)
            y = y.index_add(0, tok, out * topw[tok, j, None])
    return y.reshape(G, T, d)


def mlp(p: dict, m: Model, kind: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    """The MLP of ``x (..., T, d)``; an MoE routes each row of T tokens together."""
    if kind == "moe":
        return moe(p, m, x.reshape(-1, *x.shape[-2:]), prec).reshape(x.shape)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], prec)


# ---------------------------------------------------------------------------
# A layer over a whole sequence (training)
# ---------------------------------------------------------------------------
def layer(p: dict, m: Model, slot: Tuple[str, str], h: torch.Tensor, positions: torch.Tensor,
          prec: str) -> torch.Tensor:
    """One pre-norm layer, ``h (B, S, d)`` float32; ``p`` the slot's weights
    of one period in float32.  An MoE routes the whole batch together, as
    the training step does."""
    mixer, kind = slot
    hn = rmsnorm(h, p["norm1"], m.norm_eps)
    if mixer == "mamba":
        h = h + mamba(p["mamba"], m, hn, prec)
    else:
        h = h + attention(p["attn"], m, hn, positions, prec)
    if kind == "none":
        return h
    hn = rmsnorm(h, p["norm2"], m.norm_eps)
    return h + mlp(p["mlp"], m, kind, hn.reshape(1, -1, hn.shape[-1]), prec).reshape(h.shape)


def logits(params: dict, m: Model, h: torch.Tensor, prec: str) -> torch.Tensor:
    hn = rmsnorm(h, params["final_norm"], m.norm_eps)
    if m.tie_embeddings:
        return mm(hn, params["embed"].T, prec)
    return mm(hn, params["head"], prec)


def slots(m: Model) -> List[Tuple[int, int, Tuple[str, str]]]:
    """``(period, slot index, (mixer, mlp))`` of every layer, in order."""
    return [(p, i, s) for p in range(m.n_periods) for i, s in enumerate(m.period)]


def period_slice(tree: dict, p: int, dtype=torch.float32) -> dict:
    """Period ``p`` of a stacked subtree, each leaf cast to ``dtype``: tensors
    of their own, whatever gradient autograd gives them."""
    return {k: period_slice(v, p, dtype) if isinstance(v, dict) else v[p].detach().to(dtype)
            for k, v in tree.items()}
