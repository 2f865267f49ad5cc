"""Model composition: a stack of ``n_periods`` copies of the layer period.

The counterpart of the JAX package's ``models/transformer.py``.  Parameters
are a plain dict with the JAX pytree's nesting (``blocks.b0.attn.wq`` ...)
and its stacked leading ``n_periods`` axis; the ``lax.scan`` over periods is
a Python loop over that axis.  A slot's mixer is attention or Mamba and its
MLP dense, MoE or none, so every arch's layer plan runs (Jamba's 8-layer
period of 1 attention + 7 Mamba with MoE every other slot included).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import DEFAULT_TILES, KernelTiles
from repro_torch.models import attention, layers, mamba, moe
from repro_torch.runtime.tracing import span
from repro_torch.sharding.parallel import ParallelContext, local_shape, shard_tree


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _mlp_init(cfg: ModelConfig, gen, device, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    o_scale = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    p = {
        "w_up": layers.dense_init(gen, (n, d, f), dt, device),
        "w_down": layers.dense_init(gen, (n, f, d), dt, device, scale=o_scale),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = layers.dense_init(gen, (n, d, f), dt, device)
    return p


def _block_init(cfg: ModelConfig, spec: LayerSpec, gen, device, n: int) -> dict:
    dt = getattr(torch, cfg.dtype)
    p: dict = {"norm1": torch.ones((n, cfg.d_model), dtype=dt, device=device)}
    if spec.mixer == "attn":
        p["attn"] = attention.init(cfg, gen, device, n_periods=n)
    else:
        p["mamba"] = mamba.init(cfg, gen, device, n_periods=n)
    if spec.mlp != "none":
        p["norm2"] = torch.ones((n, cfg.d_model), dtype=dt, device=device)
        p["mlp"] = (moe.init(cfg, gen, device, n_periods=n) if spec.mlp == "moe"
                    else _mlp_init(cfg, gen, device, n))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn on ``device`` from a seeded ``torch.Generator``
    (the same layout as the JAX ``init_params``, not the same numbers)."""
    device = resolve_device(device)
    plan = cfg.layer_plan()
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    n = cfg.n_periods
    params = {
        "blocks": {f"b{i}": _block_init(cfg, spec, gen, device, n) for i, spec in enumerate(plan)},
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.input_kind == "tokens":  # an embeddings arch takes its frontend's vectors
        params["embed"] = layers.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device)
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt, device)
    return params


def _meta_tree(cfg: ModelConfig) -> dict:
    """Every parameter leaf, whole, as a meta tensor (nothing allocated)."""
    plan, gen, meta, n = cfg.layer_plan(), torch.Generator(), torch.device("meta"), cfg.n_periods
    dt = getattr(torch, cfg.dtype)
    tree = {"blocks": {f"b{i}": _block_init(cfg, spec, gen, meta, n) for i, spec in enumerate(plan)},
            "final_norm": torch.empty((cfg.d_model,), dtype=dt, device=meta)}
    if cfg.input_kind == "tokens":
        tree["embed"] = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt, device=meta)
    if not cfg.tie_embeddings:
        tree["head"] = torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt, device=meta)
    return tree


def param_shapes(cfg: ModelConfig) -> dict:
    """The global shape of every parameter leaf, by the tree's nesting, with
    nothing allocated (the leaves are drawn on the meta device)."""
    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in t.items()}

    return shapes(_meta_tree(cfg))


def meta_params(cfg: ModelConfig, par=None) -> dict:
    """The dry run's weights: every leaf an empty meta tensor in its dtype,
    of this rank's shard shape under ``par`` (a ``ParallelContext``;
    whole without one)."""
    def leaves(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = leaves(v, f"{prefix}{k}.")
                continue
            shape = tuple(v.shape)
            if par is not None:
                shape = local_shape(shape, par.flat_specs[prefix + k], par.mesh)
            out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
        return out

    return leaves(_meta_tree(cfg))


def period_params(tree: dict, i: int) -> dict:
    """Period ``i`` of a stacked parameter or cache tree (views, no copy)."""
    return {k: period_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def unbind_periods(tree: dict, n: int) -> list:
    """The ``n`` periods of a stacked tree, each leaf ``unbind(0)`` once
    (views, no copy).  Under autograd one ``unbind``'s backward stacks the
    periods' gradients of a leaf once, where ``n`` selects (``period_params``)
    would each allocate a zero tensor of the whole leaf and sum them."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unbind_periods(v, n) if isinstance(v, dict) else v.unbind(0)
        for period, part in zip(out, parts, strict=True):
            period[k] = part
    return out


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------
def _mlp_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, par) -> torch.Tensor:
    """Column / row split over ``model`` when ``ffn_tp`` split ``w_up``
    there (``par``, a ``ParamView``), else every rank's whole MLP."""
    tp = par.on_model("w_up", 1)
    p = {k: par.w(p, k, want=(0 if k == "w_down" else 1) if tp else None, tp=tp) for k in p}
    x = par.ctx.enter(x, tp)
    up = x @ p["w_up"]
    if cfg.act == "swiglu":
        h = F.silu((x @ p["w_gate"]).float()) * up.float()
    else:
        h = layers.activate(up.float(), cfg.act)
    return par.ctx.exit(h.to(x.dtype) @ p["w_down"], tp)


def _embed(params: dict, cfg: ModelConfig, inputs: torch.Tensor, positions, par) -> torch.Tensor:
    """Token ids through the table, or a stub frontend's ``(B, S, d)``
    embeddings cast to the model dtype; plus the sinusoid for a sinusoidal
    arch (of the temporal component for ``(B, 3, S)`` positions).  The
    result is in the residual layout; a table split over the vocabulary
    over ``model`` is looked up where each rank holds the id (a masked
    lookup: the partial sums add up over ``model``)."""
    dt = getattr(torch, cfg.dtype)
    top = par.view()
    vocab_tp = cfg.input_kind == "tokens" and top.on_model("embed", 0)
    if vocab_tp:
        table = top.w(params, "embed", want=0, tp=True)
        local = inputs - par.tp_rank * table.shape[0]
        hit = (local >= 0) & (local < table.shape[0])
        h = par.exit(table[torch.where(hit, local, 0)] * hit[..., None].to(table.dtype), True)
    else:
        h = top.w(params, "embed")[inputs] if cfg.input_kind == "tokens" else inputs.to(dt)
    if cfg.pos_kind == "sinusoidal":
        pos = positions if positions.ndim == 2 else positions[:, 0]
        pe = layers.sinusoidal_pe(pos, cfg.d_model).to(h.dtype)
        h = h + par.local_rows(pe) if vocab_tp else h + pe
    return h if vocab_tp else par.exit(h, False)


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor, par) -> torch.Tensor:
    """The rank's rows over the whole sequence, their vocab split over
    ``model`` where the table is (``vocab_split``)."""
    top = par.view()
    h = layers.norm(h, top.w(params, "final_norm", tp=par.seq), cfg.norm)
    name, vdim = ("embed", 0) if cfg.tie_embeddings else ("head", 1)
    tp = top.on_model(name, vdim)
    h = par.enter(h, tp)
    w = top.w(params, name, want=vdim if tp else None, tp=tp)
    return h @ w.T if cfg.tie_embeddings else h @ w


def vocab_split(cfg: ModelConfig, par) -> bool:
    """Whether ``forward`` under ``par`` returns vocab-split logits."""
    name, vdim = ("embed", 0) if cfg.tie_embeddings else ("head", 1)
    return par.view().on_model(name, vdim)


def _mlp_slot(bp, spec, cfg, h, tiles, par):
    """The block's MLP half: ``h`` plus its dense or MoE MLP of ``norm2(h)``."""
    if spec.mlp == "none":
        return h
    hn = layers.norm(h, par.w(bp, "norm2", tp=par.ctx.seq), cfg.norm)
    if spec.mlp == "moe":
        return h + moe.forward(bp["mlp"], cfg, hn, tiles=tiles, par=par.sub("mlp"))
    return h + _mlp_forward(bp["mlp"], cfg, hn, par.sub("mlp"))


def _block_forward(bp, spec, cfg, h, positions, tiles, par):
    hn = layers.norm(h, par.w(bp, "norm1", tp=par.ctx.seq), cfg.norm)
    if spec.mixer == "attn":
        h = h + attention.forward(bp["attn"], cfg, hn, positions, tiles=tiles, par=par.sub("attn"))
    else:
        h = h + mamba.forward(bp["mamba"], cfg, hn, tiles=tiles, par=par.sub("mamba"))
    return _mlp_slot(bp, spec, cfg, h, tiles, par)


def _period_forward(pp, h, positions, plan, cfg, tiles, par):
    for i, spec in enumerate(plan):
        h = _block_forward(pp[f"b{i}"], spec, cfg, h, positions, tiles, par.view("blocks", f"b{i}"))
    return h


# the products without batch dims: what XLA's dots_with_no_batch_dims_saveable keeps
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """The JAX package's ``_maybe_remat`` over one period.

    ``"full"`` (``nothing_saveable``) is ``torch.utils.checkpoint`` without
    re-entry: the backward re-runs the whole period, its kernels included.
    ``"dots"`` (``dots_with_no_batch_dims_saveable``) is selective
    checkpointing that saves the outputs of ``aten.mm`` / ``aten.addmm`` --
    the projections, router and MLP products, which are 2-D once PyTorch has
    flattened the batch -- and recomputes everything else: ``bmm`` (the
    plain attention and grouped GEMM on the CPU), the hand kernels (whose
    launches are no aten product), norms and activations.  Where it differs
    from XLA: the policy sees PyTorch's ops after dispatch, not XLA's
    ``dot_general``s after fusion, so a product XLA would fuse into a
    neighbour and a product PyTorch lowers to ``bmm`` although it has no
    batch dim are both recomputed; XLA may also rematerialise or CSE
    differently.  Without grad recording there is nothing to save, and the
    period runs as it is.
    """
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy),
        )
    raise ValueError(f"unknown remat policy {remat!r}; expected none, dots or full")


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def forward(
    params: dict,
    cfg: ModelConfig,
    inputs: torch.Tensor,  # (B,S) tokens or (B,S,d) embeddings
    positions: torch.Tensor,  # (B,S), or (B,3,S) for mrope
    *,
    tiles: KernelTiles = DEFAULT_TILES,
    remat: str = "none",
    par=None,
) -> torch.Tensor:
    """Logits ``(B, S, V)``.  Records autograd only where the caller does
    (the prefill step runs it under ``torch.no_grad``); ``remat`` applies
    per period, as in the JAX package.

    ``par`` (``sharding.parallel.ParallelContext``; one device's by
    default): the parameters are this rank's shards, ``inputs`` /
    ``positions`` its batch rows, and the logits its rows over the whole
    sequence, vocab-split over ``model`` where ``vocab_split`` says so."""
    plan = cfg.layer_plan()
    par = (par or ParallelContext.local(params)).for_seq(inputs.shape[1])
    h = _embed(params, cfg, inputs, positions, par)
    body = _maybe_remat(_period_forward, remat)
    for pp in unbind_periods(params["blocks"], cfg.n_periods):
        h = body(pp, h, positions, plan, cfg, tiles, par)
    return _logits(params, cfg, h, par)


# ---------------------------------------------------------------------------
# Decode (serve_step) with per-slot caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype: str = "bf16",
               device="cuda", par=None) -> dict:
    """Stacked (n_periods leading dim) cache matching the block structure, of
    ``batch`` rows over ``max_len`` positions; given ``par`` (a
    ``ParallelContext``), only this rank's shard of each leaf
    (``ShardingRules.cache_pspecs``)."""
    return _cache_tree(cfg, batch, max_len, kv_dtype, resolve_device(device), par)


def _cache_tree(cfg, batch, max_len, kv_dtype, device, par=None) -> dict:
    plan = cfg.layer_plan()
    dt = getattr(torch, cfg.dtype)
    return {
        f"b{i}": (
            attention.init_cache(cfg, batch, max_len, dt, device, kv_dtype, n_periods=cfg.n_periods,
                                 par=par)
            if spec.mixer == "attn"
            else mamba.init_cache(cfg, batch, dt, device, n_periods=cfg.n_periods, par=par)
        )
        for i, spec in enumerate(plan)
    }


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, kv_dtype: str = "bf16") -> dict:
    """The global shape of every leaf of the cache of ``batch`` rows over
    ``max_len`` positions (nothing allocated)."""
    meta = _cache_tree(cfg, batch, max_len, kv_dtype, torch.device("meta"))
    return {b: {name: tuple(leaf.shape) for name, leaf in c.items()} for b, c in meta.items()}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, par, kv_dtype: str = "bf16") -> dict:
    """The spec of every leaf of that cache under ``par``."""
    return {b: {name: par.cache_spec(name, shape) for name, shape in c.items()}
            for b, c in cache_shapes(cfg, batch, max_len, kv_dtype).items()}


def shard_cache(cache: dict, par) -> dict:
    """A whole cache (``init_cache`` without ``par``, e.g. built on one
    process) -> this rank's shard of each leaf on the mesh's device, by the
    same specs as ``init_cache(par=par)`` allocates (``shard_tree``)."""
    specs = {b: {name: par.cache_spec(name, leaf.shape) for name, leaf in c.items()}
             for b, c in cache.items()}
    return shard_tree(cache, specs, par.mesh)


@torch.no_grad()
def decode_step(
    params: dict,
    cfg: ModelConfig,
    cache: dict,
    inputs: torch.Tensor,  # (B,1) tokens or (B,1,d) embeddings
    cur,  # int position of the new token: scalar, or (B,) per-row
    commit=None,  # (B,) bool: the rows whose new cache state is written; None = all
    *,
    tiles: KernelTiles = DEFAULT_TILES,
    par=None,
) -> Tuple[torch.Tensor, dict]:
    """(logits (B, V), cache).  Where the JAX step returns a new cache tree,
    this one writes the new token's K/V, conv window and SSM state into
    ``cache`` in place, in the rows of ``commit`` only: the logits of a row
    outside it are not its next step's (see ``attention.decode_step``).
    ``tiles`` reaches the MoE MLP's grouped GEMMs.

    ``par`` (``ParallelContext`` with its decode layout,
    ``for_decode``; one device's by default): ``params`` and ``cache`` are
    this rank's shards, ``inputs`` / ``cur`` / ``commit`` its rows, and the
    logits its rows', vocab-split over ``model`` where ``vocab_split`` says
    so."""
    plan = cfg.layer_plan()
    device = inputs.device
    cur = torch.as_tensor(cur, dtype=torch.long, device=device)
    pos = cur[:, None] if cur.ndim == 1 else cur.expand(inputs.shape[0], 1)  # each row's own
    par = par or ParallelContext.local(params)
    with span("decode.embed"):
        h = _embed(params, cfg, inputs, pos, par)
    for p in range(cfg.n_periods):
        pp = period_params(params["blocks"], p)
        pc = period_params(cache, p)  # views: the writes land in the stacked cache
        for i, spec in enumerate(plan):
            bp, bv = pp[f"b{i}"], par.view("blocks", f"b{i}")
            hn = layers.norm(h, bv.w(bp, "norm1"), cfg.norm)
            if spec.mixer == "attn":
                mixed, _ = attention.decode_step(bp["attn"], cfg, pc[f"b{i}"], hn, cur, commit,
                                                 par=bv.sub("attn"))
            else:
                mixed, _ = mamba.decode_step(bp["mamba"], cfg, pc[f"b{i}"], hn, commit,
                                             par=bv.sub("mamba"))
            h = _mlp_slot(bp, spec, cfg, h + mixed, tiles, bv)
    with span("decode.logits"):
        return _logits(params, cfg, h[:, -1, :], par), cache  # (B, V)
