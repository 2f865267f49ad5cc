"""Jamba's hybrid model in plain float32: the Mamba mixer with its inner
norms, GQA attention without positions, top-k MoE without renormalisation.

The equations are those of ``transformers``' ``modeling_jamba`` (its slow
path), written again here: a pre-norm stack whose period holds Mamba-1 and
attention mixers and dense or MoE SwiGLU MLPs (``Model.period``).  The
Mamba mixer (``JambaMambaMixer``): ``in_proj`` to ``x`` and the gate ``z``;
a causal depthwise conv of width ``conv_width`` with bias, then silu; then
``x_proj`` to ``(dt, B, C)``, each through an RMS norm of its own learned
weight at eps ``norm_eps``; ``dt = softplus(dt @ dt_w + dt_b)``,
``A = -exp(A_log)``; ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
``y_t = <h_t, C_t> + D x_t``; out ``(y * silu(z)) @ out_proj``.  The MoE
(``JambaSparseMoeBlock``): softmax over every expert, the top k of it as
the weights, not renormalised.  Attention: softmax of ``q k^T / sqrt(hd)``
over GQA groups, causal, no rotary or other positional encoding.

Where the configuration file's ``departures`` say the program departs
from the published model (the MoE's capacity), this file follows the
program, as ``model.py`` does.

Sizes come from a configuration file's ``sizes`` and the ``d_inner`` of its
``hybrid`` group (``model_of``); weights are the benchmark's leaves
(``blocks.b<i>.mamba.dt_norm`` ...), stacked over periods, taken one period
at a time by the caller (``model.period_slice``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cardbench.reference import model as M
from cardbench.reference.ops import mm, rmsnorm, softplus

NORMS = ("dt_norm", "B_norm", "C_norm")  # the mixer's inner norms, of dt, B and C


def model_of(cfg: dict) -> M.Model:
    """The sizes of a hybrid configuration file."""
    return dataclasses.replace(M.Model.from_file(cfg), d_inner=cfg["hybrid"]["d_inner"])


# ---------------------------------------------------------------------------
# The Mamba mixer, over a sequence from a given state
# ---------------------------------------------------------------------------
def ssm_inputs(p: dict, m: M.Model, xc: torch.Tensor, prec: str):
    """``dt (B, L, Di)``, ``B`` and ``C (B, L, N)`` of the conv's output ``xc``."""
    parts = torch.split(mm(xc, p["x_proj"], prec), [m.dt_rank, m.ssm_state, m.ssm_state], dim=-1)
    dt_raw, Bm, Cm = (rmsnorm(t, p[name], m.norm_eps) for t, name in zip(parts, NORMS))
    return softplus(mm(dt_raw, p["dt_w"], prec) + p["dt_b"]), Bm, Cm


def mamba(p: dict, m: M.Model, x: torch.Tensor, prec: str, conv: Optional[torch.Tensor] = None,
          ssm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mixer over ``x (B, L, d)``, from the conv window ``conv (B, K - 1,
    Di)`` (the inputs of the conv before ``x``'s first position) and the SSM
    state ``ssm (B, Di, N)``; both zero where None (a sequence's start).
    Returns the mixer's output ``(B, L, d)``, the conv window after ``x``'s
    last position and the SSM state there."""
    B, L, _ = x.shape
    K, Di = m.conv_width, m.d_inner
    xi, z = mm(x, p["in_proj"], prec).chunk(2, dim=-1)
    if conv is None:
        conv = xi.new_zeros((B, K - 1, Di))
    xp = torch.cat([conv.float(), xi], dim=1)  # (B, K - 1 + L, Di)
    xc = F.silu(sum(xp[:, i:i + L] * p["conv_w"][i] for i in range(K)) + p["conv_b"])
    dt, Bm, Cm = ssm_inputs(p, m, xc, prec)
    A = -torch.exp(p["A_log"])  # (Di, N)
    h = xi.new_zeros((B, Di, m.ssm_state)) if ssm is None else ssm.float().clone()
    ys = []
    for t in range(L):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * xc[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + xc * p["Dp"]
    return mm(y * F.silu(z), p["out_proj"], prec), xp[:, L:], h


# ---------------------------------------------------------------------------
# Attention without positions
# ---------------------------------------------------------------------------
def qkv(p: dict, m: M.Model, x: torch.Tensor, prec: str):
    """``x (..., S, d)`` -> ``q (..., H, S, hd)``, ``k`` and ``v (..., Hkv, S, hd)``."""
    *lead, S, _ = x.shape

    def heads(w, n):
        return mm(x, w, prec).reshape(*lead, S, n, m.head_dim).transpose(-3, -2)

    return heads(p["wq"], m.n_heads), heads(p["wk"], m.n_kv_heads), heads(p["wv"], m.n_kv_heads)


def attention(p: dict, m: M.Model, x: torch.Tensor, prec: str) -> torch.Tensor:
    """Causal self-attention over the whole sequence: ``x (B, S, d)``."""
    q, k, v = qkv(p, m, x, prec)
    pos = torch.arange(x.shape[-2], device=x.device)
    return mm(M.attend(q, k, v, pos, pos, prec), p["wo"], prec)


# ---------------------------------------------------------------------------
# MoE: the softmax's top k as they are
# ---------------------------------------------------------------------------
def route(p: dict, m: M.Model, x: torch.Tensor):
    """``(weights, experts)`` of ``x (..., d)``: the top ``experts_per_token``
    of the softmax over every expert, not renormalised."""
    return torch.topk(torch.softmax(x @ p["router"], dim=-1), m.experts_per_token, dim=-1)


def moe(p: dict, m: M.Model, x: torch.Tensor, prec: str) -> torch.Tensor:
    """Top-k MoE of ``x (G, T, d)``: each of the G groups of T tokens routed
    together, each expert taking at most ``model.capacity(T)`` of a group's
    pairs in (token, k) order (the program's capacity; the published block
    drops none)."""
    G, T, d = x.shape
    k = m.experts_per_token
    topw, topi = route(p, m, x)  # (G, T, k)
    onehot = F.one_hot(topi.reshape(G, T * k), m.n_experts)
    place = (onehot.cumsum(1) * onehot).sum(-1) - 1  # the pair's place among its expert's
    keep = (place < M.capacity(T, m)).reshape(G * T, k)
    xt, y = x.reshape(G * T, d), torch.zeros((G * T, d), dtype=x.dtype, device=x.device)
    topi, topw = topi.reshape(G * T, k), topw.reshape(G * T, k)
    for e in range(m.n_experts):
        tok, j = torch.nonzero((topi == e) & keep, as_tuple=True)
        if tok.numel():
            out = M.swiglu(xt[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e], prec)
            y = y.index_add(0, tok, out * topw[tok, j, None])
    return y.reshape(G, T, d)


def mlp(p: dict, m: M.Model, kind: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    """The MLP of ``x (..., T, d)``; an MoE routes each row of T tokens together."""
    if kind == "moe":
        return moe(p, m, x.reshape(-1, *x.shape[-2:]), prec).reshape(x.shape)
    return M.swiglu(x, p["w_gate"], p["w_up"], p["w_down"], prec)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------
@torch.no_grad()
def forward(params: dict, m: M.Model, tokens: torch.Tensor, prec: str,
            by_step: bool = False) -> torch.Tensor:
    """Logits ``(B, S, vocab)`` of ``tokens (B, S)`` from an empty state; an
    MoE routes the whole batch together, as the program's prefill does, or
    with ``by_step`` each position's B tokens together, as a decode step
    does (the capacity, and so which pairs drop, depends on the group)."""
    h = params["embed"][tokens].float()
    for p, i, (mixer, kind) in M.slots(m):
        w = M.period_slice(params["blocks"][f"b{i}"], p)
        hn = rmsnorm(h, w["norm1"], m.norm_eps)
        if mixer == "mamba":
            h = h + mamba(w["mamba"], m, hn, prec)[0]
        else:
            h = h + attention(w["attn"], m, hn, prec)
        if kind != "none":
            hn = rmsnorm(h, w["norm2"], m.norm_eps)
            if by_step:
                h = h + mlp(w["mlp"], m, kind, hn.transpose(0, 1), prec).transpose(0, 1)
            else:
                h = h + mlp(w["mlp"], m, kind, hn.reshape(1, -1, hn.shape[-1]), prec).reshape(h.shape)
    top = {k: params[k].float() for k in ("final_norm", "embed" if m.tie_embeddings else "head")}
    return M.logits(top, m, h, prec)
