"""GQA attention block: prefill forward + KV-cache decode step.

Parameters keep the JAX layout: ``wq (d, H*hd)`` etc., applied as ``x @ w``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ops import KernelTiles
from repro_torch.models import layers
from repro_torch.runtime.tracing import span
from repro_torch.sharding import collectives as cc
from repro_torch.sharding.parallel import local_view


def init(cfg: ModelConfig, gen: torch.Generator, device, n_periods: int = 0) -> dict:
    """Weights of one attention slot; with ``n_periods`` a stacked leading axis."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    dt = getattr(torch, cfg.dtype)
    o_scale = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    lead = (n_periods,) if n_periods else ()
    return {
        "wq": layers.dense_init(gen, lead + (d, H * hd), dt, device),
        "wk": layers.dense_init(gen, lead + (d, Hkv * hd), dt, device),
        "wv": layers.dense_init(gen, lead + (d, Hkv * hd), dt, device),
        "wo": layers.dense_init(gen, lead + (H * hd, d), dt, device, scale=o_scale),
    }


def _project(p, x, cfg):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def _project_heads(p, x, cfg, par):
    """q, k, v of this rank's heads, and ``wo``, under ``par`` (a
    ``ParamView``); the input as the region reads it, and whether the
    region is head-parallel.

    Head-parallel when ``wq`` is split over ``model`` by whole heads: the
    rank runs query heads ``[r H/tp, (r+1) H/tp)`` and their KV heads, ``wo``
    row-split.  ``wk``/``wv`` split by whole KV heads are used as stored; a
    column split that cuts a head (``n_kv_heads`` below ``tp``, which XLA
    tolerates and the local kernel cannot) or none is gathered on use and
    the rank's KV heads' columns taken.  Otherwise every rank runs every
    head."""
    H, Hkv, hd, tp = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, par.ctx.tp
    heads_tp = par.on_model("wq", 1) and H % tp == 0
    x = par.ctx.enter(x, heads_tp)
    B, S, _ = x.shape
    if not heads_tp:
        w = {k: par.w(p, k) for k in p}
        return (*_project(w, x, cfg), w["wo"], x, False)
    Hl, g = H // tp, H // Hkv
    if Hl % g and g % Hl:
        raise ValueError(f"{Hl} query heads a rank do not map onto whole KV groups of {g}")
    lo = par.ctx.tp_rank * Hl // g
    n_kv = max(1, Hl // g)
    q = (x @ par.w(p, "wq", want=1, tp=True)).reshape(B, S, Hl, hd).transpose(1, 2)
    kv = []
    for name in ("wk", "wv"):
        if par.on_model(name, 1) and Hkv % tp == 0:
            w = par.w(p, name, want=1, tp=True)
        else:
            w = par.w(p, name, tp=True)[:, lo * hd:(lo + n_kv) * hd]
        kv.append((x @ w).reshape(B, S, n_kv, hd).transpose(1, 2))
    return (q, *kv, par.w(p, "wo", want=0, tp=True), x, True)


def forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,
    *,
    tiles: KernelTiles,
    par=None,
) -> torch.Tensor:
    """``x`` and the result are in the residual layout of ``par`` (a
    ``ParamView``, one device's by default; ``ParallelContext.enter`` /
    ``exit``), the flash kernel runs at this rank's heads
    (``_project_heads``) and ``wo``'s partial sums add up over ``model``."""
    par = par or local_view(p)
    q, k, v, wo, x, heads_tp = _project_heads(p, x, cfg, par)
    B, S, _ = x.shape
    q, k = layers.apply_positions(q, k, cfg, positions)
    # the kernel takes (B, H, S, hd) in contiguous memory
    o = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, tiles=tiles)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return par.ctx.exit(o @ wo, heads_tp)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               kv_dtype: str = "bf16", n_periods: int = 0, par=None) -> dict:
    """The KV cache of ``batch`` rows over ``max_len`` positions; given ``par``
    (a ``ParallelContext``), only this rank's shard of each leaf, by the
    rules' cache spec (a rank never holds the whole cache)."""
    lead = (n_periods,) if n_periods else ()
    shape = lead + (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)

    def leaf(name, shape, make, dt):
        if par is not None:
            shape = par.cache_local_shape(name, shape, bool(lead))
        return make(shape, dtype=dt, device=device)

    if kv_dtype == "int8":
        # rowwise (per b, h, position) symmetric int8 codes and an f32 scale
        # that starts at one, as in the JAX package
        return {
            "k": leaf("k", shape, torch.zeros, torch.int8),
            "v": leaf("v", shape, torch.zeros, torch.int8),
            "k_s": leaf("k_s", shape[:-1] + (1,), torch.ones, torch.float32),
            "v_s": leaf("v_s", shape[:-1] + (1,), torch.ones, torch.float32),
        }
    return {
        "k": leaf("k", shape, torch.zeros, dtype),
        "v": leaf("v", shape, torch.zeros, dtype),
    }


def _quant_kv(x: torch.Tensor):
    """``x (B, Hkv, 1, hd)`` -> int8 codes of its shape and f32 scales
    ``(B, Hkv, 1, 1)``: the quantize kernel over a contiguous ``(B*Hkv, hd)``
    view, one row per head."""
    B, Hkv, _, hd = x.shape
    q, s = ops.quantize_int8(x.reshape(B * Hkv, hd).contiguous())
    return q.view(B, Hkv, 1, hd), s.view(B, Hkv, 1, 1)


def _write_at_cur_(c: torch.Tensor, new: torch.Tensor, cur: torch.Tensor, commit, o: int) -> None:
    """Write ``new (B,Hkv,1,hd)`` in place at global position ``cur``
    (scalar, or ``(B,)`` per row) into ``c (B,Hkv,L,hd)``, which holds
    positions ``[o, o + L)``: in the rows whose ``cur`` lies there and that
    ``commit`` holds (every row when it is None); the other rows keep their
    slot."""
    L = c.shape[2]
    rows = torch.arange(c.shape[0], device=c.device)
    at = cur.expand(c.shape[0])
    hit = (at >= o) & (at < o + L)
    if commit is not None:
        hit = hit & commit
    pos = (at - o).clamp(0, L - 1)
    c[rows, :, pos] = torch.where(hit[:, None, None], new[:, :, 0], c[rows, :, pos])


def _project_decode(p, x, cfg, par, Hc: int):
    """q of the heads this rank runs, the new K/V of the ``Hc`` KV heads its
    cache holds, ``wo`` and whether the region is head-parallel.

    Head-parallel as ``_project_heads``; K/V are the rank's KV heads where
    the cache splits them over ``model``, else every KV head (``wk``/``wv``
    gathered on use where they are split), which every model rank then
    writes alike."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    heads_tp = par.on_model("wq", 1) and H % par.ctx.tp == 0
    x = par.ctx.enter(x, heads_tp)
    B = x.shape[0]
    split_kv = Hc < cfg.n_kv_heads

    def proj(name, n):
        w = par.w(p, name, want=1 if heads_tp and (name == "wq" or split_kv) else None, tp=heads_tp)
        return (x @ w).reshape(B, 1, n, hd).transpose(1, 2)

    q = proj("wq", H // par.ctx.tp if heads_tp else H)
    wo = par.w(p, "wo", want=0 if heads_tp else None, tp=heads_tp)
    return q, proj("wk", Hc), proj("wv", Hc), wo, heads_tp


def decode_step(
    p: dict,
    cfg: ModelConfig,
    cache: dict,
    x: torch.Tensor,  # (B, 1, d)
    cur: torch.Tensor,  # int position of the new token: scalar, or (B,) per-row
    commit=None,  # (B,) bool: the rows whose new K/V is written; None = all
    *,
    par=None,
) -> Tuple[torch.Tensor, dict]:
    """Attend one new token per row and write its K/V into ``cache`` in place
    (the JAX step returns a new cache instead).  A row outside ``commit``
    attends over its cache as it stands, so its output is not that row's
    next step; the serving engine discards it.

    An int8 cache (``k_s`` / ``v_s`` scales, ``init_cache(kv_dtype="int8")``)
    takes each new K and V row through the quantize kernel and is never
    dequantized: the scales fold into the logits and the probabilities, as
    in the JAX package.  The attention over the cache is
    ``ops.decode_attention``: on the card a kernel that reads the codes as
    stored, on the CPU the plain version (int8 -> bf16 -> f32 products).

    ``par`` (a ``ParamView``, one device's by default) with its context's
    decode layout (``ParallelContext.for_decode``): ``x`` holds this rank's
    rows and ``cache`` its shard.  Heads split over ``model`` as in
    ``forward``; where the cache keeps every KV head, every model rank
    writes them all and reads its q heads' groups.  Where the cache's
    positions are split (over ``model``, or the whole mesh for batch-1
    long context) the rank holds ``[o, o + L)``, writes the new row only
    where ``cur`` lies there, masks by global position, and the partial
    softmaxes combine from each rank's log-sum-exp
    (``collectives.softmax_combine``); a rank
    that runs only some q heads then attends with every head (q gathered
    over ``model``: the other model ranks hold other positions of them)."""
    par = par or local_view(p)
    ctx = par.ctx
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    cur = torch.as_tensor(cur, dtype=torch.long, device=x.device)
    per_row = cur.ndim == 1  # continuous batching: each row at its own length
    Hc, L = cache["k"].shape[1], cache["k"].shape[2]  # the KV heads and positions this rank holds
    seq_axes = ctx.kv_seq_axes()
    o = ctx.mesh.index(seq_axes) * L if seq_axes else 0  # the first position this rank holds

    with span("attn.project"):
        q, k_new, v_new, wo, heads_tp = _project_decode(p, x, cfg, par, Hc)
        pos = cur[:, None] if per_row else cur.expand(B, 1)
        if cfg.pos_kind == "mrope":  # a decoded token: the same id in all three components
            pos = pos[:, None, :].expand(B, 3, 1)
        q, k_new = layers.apply_positions(q, k_new, cfg, pos)
    k, v = cache["k"], cache["v"]
    int8_kv = "k_s" in cache
    with span("attn.cache_write"):
        if int8_kv:
            (kq, ks), (vq, vs) = _quant_kv(k_new), _quant_kv(v_new)
            _write_at_cur_(k, kq, cur, commit, o)
            _write_at_cur_(v, vq, cur, commit, o)
            _write_at_cur_(cache["k_s"], ks, cur, commit, o)
            _write_at_cur_(cache["v_s"], vs, cur, commit, o)
        else:
            _write_at_cur_(k, k_new.to(k.dtype), cur, commit, o)
            _write_at_cur_(v, v_new.to(v.dtype), cur, commit, o)
    with span("attn.attend"):
        k_s, v_s = cache.get("k_s"), cache.get("v_s")
        Hq = q.shape[1]
        every_head = heads_tp and "model" in seq_axes
        if every_head:
            q = cc.all_gather_raw(q, ctx.mesh, "model", 1)
        elif heads_tp and Hc == cfg.n_kv_heads:
            # the whole cache's KV heads: read the groups of this rank's q heads
            g = cfg.n_heads // cfg.n_kv_heads
            lo, n_kv = ctx.tp_rank * Hq // g, max(1, Hq // g)
            k, v = k[:, lo:lo + n_kv], v[:, lo:lo + n_kv]
            if int8_kv:
                k_s, v_s = k_s[:, lo:lo + n_kv], v_s[:, lo:lo + n_kv]
        # GQA-grouped masked attention over the cache as stored (a view of
        # some KV heads is read in place); f32, as the JAX package's
        att, lse = ops.decode_attention(q[:, :, 0], k, v, k_s, v_s, cur, o, hd ** -0.5)
        att = cc.softmax_combine(att, lse, ctx.mesh, seq_axes).to(x.dtype)
        att = att.reshape(B, -1, 1, hd)
        if every_head:
            att = att[:, ctx.tp_rank * Hq:(ctx.tp_rank + 1) * Hq]
        att = att.transpose(1, 2).reshape(B, 1, -1)
    with span("attn.out"):
        return ctx.exit(att @ wo, heads_tp), cache
