"""Mixture-of-Experts MLP: top-k routing, sort-based capacity dispatch.

The counterpart of the JAX package's ``models/moe.py``: sort the (token,
expert) pairs by expert with a stable sort, scatter them into a
capacity-padded ``(E, C, d)`` buffer, run the three grouped GEMMs (``ops.moe_gemm``, the CUDA kernel on the card), and
combine with the routing weights.  A pair past its expert's capacity is
dropped: it adds 0 to slot 0 of its expert (``index_put_`` with
``accumulate=True``, as the JAX ``.at[se, pos].add``), never overwriting it.

Over a mesh (``par``, the MLP's ``ParamView``) routing and grouping stay
local to each rank's batch rows, as in the JAX package's shard_map
expert-parallel path (``_forward_ep_shard_map``), in one of three modes
(``_mode``):

* ``ep``: every model rank routes and groups the same tokens (replicated
  over ``model``) and runs only its ``E / tp`` experts, sliced out of the
  grouped buffer; their outputs go into the full ``(E, C, d)`` buffer, the
  combine runs as on one device, and the partial results add up over
  ``model`` in bf16 (the reference's combine all-reduce).  The capacity is
  the reference's ``capacity(T_local, block=8)``;
* ``tp``: every rank runs every expert at its ``d_ff / tp`` columns
  (``w_up``/``w_gate`` column-, ``w_down`` row-split); the f32 combine adds
  up over ``model``;
* ``dense``: every model rank runs everything, with the expert weights
  gathered where the rules split them; one device is this mode.

In ``tp`` and ``dense`` the capacity is the one-device formula at the
rank's token count: over a data split each rank dispatches its own rows,
which equals the one-device dispatch of those rows (a microbatch's) and
differs from the reference's global dispatch only where a pair is dropped
(ROADMAP Queue C).

Routing ties: ``torch.topk`` does not specify which of two equal
probabilities comes first, ``jax.lax.top_k`` takes the lower index; random
router weights make a tie improbable, and the tests use tie-free logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ops import KernelTiles
from repro_torch.models import layers
from repro_torch.runtime.tracing import span
from repro_torch.sharding.parallel import local_view

CAPACITY_FACTOR = 1.25


def _mode(par) -> str:
    """``ep`` where the context runs expert parallelism
    (``train_step.moe_dist_for``) and the rules split the experts over
    ``model``, else ``tp`` where they split ``d_ff`` there, else ``dense``."""
    if par.ctx.moe_ep and par.on_model("w_up", 0):
        return "ep"
    return "tp" if par.on_model("w_up", 2) else "dense"


def capacity(n_tokens: int, cfg: ModelConfig, block: int = 8) -> int:
    """Static per-expert capacity, rounded up to the MoE GEMM tile."""
    c = int(n_tokens * cfg.experts_per_token * CAPACITY_FACTOR / cfg.n_experts)
    c = max(c, block)
    return ((c + block - 1) // block) * block


def init(cfg: ModelConfig, gen: torch.Generator, device, n_periods: int = 0) -> dict:
    """Weights of one MoE slot; with ``n_periods`` a stacked leading axis.
    The router is f32 whatever the model dtype, as in the JAX package."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = getattr(torch, cfg.dtype)
    o_scale = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    lead = (n_periods,) if n_periods else ()
    p = {
        "router": layers.dense_init(gen, lead + (d, E), torch.float32, device),
        "w_up": layers.dense_init(gen, lead + (E, d, f), dt, device),
        "w_down": layers.dense_init(gen, lead + (E, f, d), dt, device, scale=o_scale),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = layers.dense_init(gen, lead + (E, d, f), dt, device)
    return p


def route(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """(router probs (T, E) f32, top-k weights renormalised (T, k), top-k experts (T, k))."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    topw, topi = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def dispatch(topi: torch.Tensor, topw: torch.Tensor, E: int, C: int):
    """Sort-based dispatch of the (token, expert) pairs: (sorted expert,
    sorted token, sorted weight, keep, slot within the expert)."""
    T, k = topi.shape
    flat_e = topi.reshape(-1)
    flat_t = torch.arange(T, device=topi.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], topw.reshape(-1)[order]
    if flat_e.device.type == "meta":  # bincount has no meta kernel: its shape is (E,)
        counts = torch.empty((E,), dtype=torch.long, device="meta")
    else:
        # the CUDA bincount reads its input's min and max to the host: two waits
        with span("sync.moe_counts", waits=2 if flat_e.is_cuda else 0):
            counts = torch.bincount(flat_e, minlength=E)
    seg_start = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos = torch.arange(T * k, device=topi.device) - seg_start[se]  # rank within expert
    keep = pos < C
    return se, st, sw, keep, torch.where(keep, pos, 0)


def group(xt: torch.Tensor, se, st, keep, pos, E: int, C: int) -> torch.Tensor:
    """The capacity-padded ``(E, C, d)`` buffer of the kept pairs' tokens; a
    dropped pair adds 0 to slot 0 of its expert."""
    grouped = torch.zeros((E, C, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    src = torch.where(keep[:, None], xt[st], 0).to(xt.dtype)
    return grouped.index_put_((se, pos), src, accumulate=True)


def forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    tiles: KernelTiles,
    par=None,
) -> torch.Tensor:
    """``x`` and the result in the residual layout of ``par`` (the MLP's
    ``ParamView``, one device's by default)."""
    par = par or local_view(p)
    mode, ctx, E = _mode(par), par.ctx, cfg.n_experts
    region = mode != "dense"
    want = {"ep": {"w_up": 0, "w_gate": 0, "w_down": 0},
            "tp": {"w_up": 2, "w_gate": 2, "w_down": 1}}.get(mode, {})
    w = {k: par.w(p, k, want=want.get(k), tp=region) for k in p}
    x = ctx.enter(x, region)  # the input's gradient adds up over the model ranks
    B, S, d = x.shape
    T = B * S
    if mode == "ep":
        C = capacity(T, cfg, block=8)
    else:
        C = capacity(T, cfg, block=tiles.moe_block_c if T >= tiles.moe_block_c else 8)
    xt = x.reshape(T, d)
    with span("moe.route"):
        _, topw, topi = route(w, cfg, xt)
    with span("moe.dispatch"):
        se, st, sw, keep, pos = dispatch(topi, topw, E, C)
        grouped = group(xt, se, st, keep, pos, E, C)
        if mode == "ep":
            E_loc = E // ctx.tp
            r = ctx.tp_rank
            grouped = grouped[r * E_loc:(r + 1) * E_loc]
    with span("moe.experts"):
        out = _experts(grouped, w, cfg, tiles, x.dtype)  # (E or E / tp, C, d)
        if mode == "ep":
            # the rank's experts in the full (E, C, d) slot layout, zero elsewhere
            out = torch.cat([out.new_zeros((r * E_loc, C, d)), out,
                             out.new_zeros(((ctx.tp - r - 1) * E_loc, C, d))])
    with span("moe.combine"):
        y = _combine(out, se, st, sw, keep, pos, T)
        if mode == "ep":
            # the combine in bf16: each token's k experts live on at most k ranks
            y = y.to(torch.bfloat16)
        return ctx.exit(y.reshape(B, S, d), region).to(x.dtype)


def _experts(grouped, p: dict, cfg: ModelConfig, tiles: KernelTiles, dtype) -> torch.Tensor:
    """The expert FFN of the grouped buffer: three grouped GEMMs (two without
    swiglu), ``(E, C, d) -> (E, C, d)``."""
    up = ops.moe_gemm(grouped, p["w_up"], tiles=tiles)
    if cfg.act == "swiglu":
        gate = ops.moe_gemm(grouped, p["w_gate"], tiles=tiles)
        hidden = F.silu(gate.float()) * up.float()
    else:
        hidden = layers.activate(up.float(), cfg.act)
    return ops.moe_gemm(hidden.to(dtype), p["w_down"], tiles=tiles)


def _combine(out, se, st, sw, keep, pos, T: int) -> torch.Tensor:
    """Each token's kept pairs' outputs, weighted and summed in f32: ``(T, d)``."""
    gathered = out[se, pos] * sw[:, None].to(out.dtype)
    gathered = torch.where(keep[:, None], gathered, 0)
    y = torch.zeros((T, out.shape[-1]), dtype=torch.float32, device=out.device)
    return y.index_add_(0, st, gathered.float())


def aux_loss(router_probs: torch.Tensor, topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss (optional, used by the trainer)."""
    me = router_probs.mean(dim=0)
    ce = torch.bincount(topi.reshape(-1), minlength=n_experts) / topi.numel()
    return n_experts * torch.sum(me * ce)
