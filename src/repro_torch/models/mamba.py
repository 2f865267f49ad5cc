"""Mamba-1 block: causal conv + selective scan; O(1)-state decode step.

The counterpart of the JAX package's ``models/mamba.py``.  ``forward`` runs
the scan through ``ops.selective_scan`` (the CUDA kernel on the card);
``decode_step`` advances the conv window and the f32 SSM state by one token
with the plain ``selective_scan_step`` and, unlike the JAX step, writes the
new state into the cache in place, in the rows of ``commit`` only.  Where
``cfg.mamba_inner_norms`` (Jamba's mixer) ``dt``, ``B`` and ``C`` pass an RMS
norm of their own learned weights (``dt_norm``, ``B_norm``, ``C_norm``) right
after ``x_proj``.

Spans (``runtime.tracing``; ``step`` None outside a serve step):
``mamba.project`` (``in_proj``), ``mamba.conv`` (the window, the conv and
silu), ``mamba.ssm`` (``x_proj``, the norms, ``dt`` and the scan or its
step), ``mamba.out`` (the gate and ``out_proj``) and, in the decode step,
``mamba.state_write`` (the conv window's and the state's commits).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ops import KernelTiles
from repro_torch.models import layers
from repro_torch.runtime.tracing import span
from repro_torch.sharding import collectives as cc
from repro_torch.sharding.parallel import local_view


def init(cfg: ModelConfig, gen: torch.Generator, device, n_periods: int = 0) -> dict:
    """Weights of one Mamba slot; with ``n_periods`` a stacked leading axis.
    ``A_log`` and ``Dp`` are f32 whatever the model dtype, as in the JAX package;
    the inner norms' weights (``cfg.mamba_inner_norms``) start at one."""
    d, Di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, K = cfg.resolved_dt_rank, cfg.conv_width
    dt = getattr(torch, cfg.dtype)
    o_scale = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    lead = (n_periods,) if n_periods else ()
    # S4D-real initialization for A: A[d, n] = -(n + 1)
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(lead + (Di, N))
    p = {
        "in_proj": layers.dense_init(gen, lead + (d, 2 * Di), dt, device),
        "conv_w": layers.dense_init(gen, lead + (K, Di), dt, device, scale=0.1),
        "conv_b": torch.zeros(lead + (Di,), dtype=dt, device=device),
        "x_proj": layers.dense_init(gen, lead + (Di, dtr + 2 * N), dt, device),
        "dt_w": layers.dense_init(gen, lead + (dtr, Di), dt, device),
        "dt_b": torch.full(lead + (Di,), math.log(math.expm1(0.01)), device=device).to(dt),
        "A_log": torch.log(a),
        "Dp": torch.ones(lead + (Di,), dtype=torch.float32, device=device),
        "out_proj": layers.dense_init(gen, lead + (Di, d), dt, device, scale=o_scale),
    }
    if cfg.mamba_inner_norms:
        for name, width in zip(_NORMS, (dtr, N, N)):
            p[name] = torch.ones(lead + (width,), dtype=dt, device=device)
    return p


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, L, Di), w: (K, Di)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i : i + L, :].float() * w[i].float()
    return (y + b.float()).to(x.dtype)


_NORMS = ("dt_norm", "B_norm", "C_norm")  # the inner norms' weights, of dt_raw, B and C


def _ssm_inputs(p: dict, xc: torch.Tensor, cfg: ModelConfig, par=None):
    """``dt``, ``A``, ``B``, ``C`` of the scan.  Under a ``d_inner``-parallel
    ``par``, ``x_proj`` is row-split: its partial ``(dt, B, C)`` add up over
    ``model`` (and the sum's gradient, which each rank's channels give a
    part of, adds up too), so the inner norms see whole rows."""
    dtr, N = cfg.resolved_dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]  # (..., dtr + 2N)
    if par is not None:
        mesh = par.mesh
        proj = cc.copy_to_region(cc.all_reduce_sum(proj, mesh, "model"), mesh, "model")
    dt_raw, Bm, Cm = torch.split(proj, [dtr, N, N], dim=-1)
    if cfg.mamba_inner_norms:
        dt_raw, Bm, Cm = (layers.norm(t.contiguous(), p[name], cfg.norm)
                          for t, name in zip((dt_raw, Bm, Cm), _NORMS))
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt_raw.float() @ p["dt_w"].float() + p["dt_b"].float(),
                         torch.zeros((), device=xc.device))
    A = -torch.exp(p["A_log"])
    return dt, A, Bm, Cm


_WANT = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_w": 1, "dt_b": 0,
         "A_log": 0, "Dp": 0, "out_proj": 0, "dt_norm": None, "B_norm": None, "C_norm": None}


def _weights(p: dict, cfg: ModelConfig, par):
    """The block's weights as this rank uses them, whether it runs
    ``d_inner``-parallel, and its ``ParamView`` (one device's by default)."""
    par = par or local_view(p)
    tp = par.on_model("in_proj", 1) and par.on_model("conv_w", 1) and cfg.d_inner % par.ctx.tp == 0
    return {k: par.w(p, k, want=_WANT[k] if tp else None, tp=tp) for k in p}, tp, par


def forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    tiles: KernelTiles,
    par=None,
) -> torch.Tensor:
    """``x`` and the result are in the residual layout of ``par`` (a
    ``ParamView``, one device's by default); ``d_inner``-parallel where
    ``mixer_tp`` split it over ``model`` (``in_proj`` per half, so each
    rank's columns of x and z are its channels; the conv, ``dt_w``,
    ``dt_b``, ``A_log`` and ``Dp`` by channel; ``x_proj`` and ``out_proj``
    by row): the scan kernel runs at ``d_inner / tp`` channels and
    ``out_proj``'s partial sums add up over ``model``.  Otherwise every rank
    runs every channel."""
    p, tp, par = _weights(p, cfg, par)
    x = par.ctx.enter(x, tp)
    with span("mamba.project"):
        xz = x @ p["in_proj"]  # (B, S, 2*Di)
        xi, z = xz.chunk(2, dim=-1)
    with span("mamba.conv"):
        xc = F.silu(_conv_causal(xi, p["conv_w"], p["conv_b"]))
    with span("mamba.ssm"):
        dt, A, Bm, Cm = _ssm_inputs(p, xc, cfg, par if tp else None)
        # the kernel takes contiguous operands: Bm and Cm are slices of one projection
        y = ops.selective_scan(
            xc, dt.to(xc.dtype), A, Bm.contiguous(), Cm.contiguous(), p["Dp"], tiles=tiles
        )
    with span("mamba.out"):
        y = y * F.silu(z)
        return par.ctx.exit(y @ p["out_proj"], tp)


def init_cache(cfg: ModelConfig, batch: int, dtype, device, n_periods: int = 0, par=None) -> dict:
    """The conv window and the f32 SSM state of ``batch`` rows; given ``par``
    (a ``ParallelContext``), only this rank's shard of each (rows over the
    batch axes, ``d_inner`` over ``model`` where ``mixer_tp`` splits it)."""
    lead = (n_periods,) if n_periods else ()
    shapes = {"conv": (lead + (batch, cfg.conv_width - 1, cfg.d_inner), dtype),
              "ssm": (lead + (batch, cfg.d_inner, cfg.ssm_state), torch.float32)}
    out = {}
    for name, (shape, dt) in shapes.items():
        if par is not None:
            shape = par.cache_local_shape(name, shape, bool(lead))
        out[name] = torch.zeros(shape, dtype=dt, device=device)
    return out


def _commit_(c: torch.Tensor, new: torch.Tensor, commit) -> None:
    """Write ``new`` into ``c`` in place, in the rows (axis 0) where ``commit``
    is true (every row when ``commit`` is None)."""
    if commit is not None:
        new = torch.where(commit.reshape((-1,) + (1,) * (c.ndim - 1)), new, c)
    c.copy_(new)


def decode_step(
    p: dict,
    cfg: ModelConfig,
    cache: dict,
    x: torch.Tensor,  # (B, 1, d)
    commit=None,  # (B,) bool: the rows whose new state is written; None = all
    *,
    par=None,
) -> Tuple[torch.Tensor, dict]:
    """One token: the conv window and the SSM state advance in place.
    ``par`` (a ``ParamView``, one device's by default) as in ``forward``:
    ``d_inner``-parallel where ``mixer_tp`` split it, the cache's conv
    window and state then this rank's channels (``in_proj`` per half,
    ``x_proj`` row-split with its ``(dt, B, C)`` summed over ``model``,
    ``out_proj`` row-split)."""
    p, tp, par = _weights(p, cfg, par)
    x = par.ctx.enter(x, tp)
    with span("mamba.project"):
        xi, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)  # (B, Di) each: this rank's channels
    with span("mamba.conv"):
        # conv over (cached K-1 inputs, new input)
        window = torch.cat([cache["conv"], xi[:, None, :]], dim=1)  # (B, K, Di)
        xc = (window.float() * p["conv_w"].float()[None]).sum(dim=1) + p["conv_b"].float()
        xc = F.silu(xc).to(x.dtype)  # (B, Di)
    with span("mamba.ssm"):
        dt, A, Bm, Cm = _ssm_inputs(p, xc, cfg, par if tp else None)
        new_state, y = ops.selective_scan_step(
            cache["ssm"], xc, dt.to(xc.dtype), A, Bm, Cm, p["Dp"]
        )
    with span("mamba.out"):
        y = y * F.silu(z)
        out = par.ctx.exit((y @ p["out_proj"])[:, None, :], tp)
    with span("mamba.state_write"):
        _commit_(cache["conv"], window[:, 1:, :], commit)
        _commit_(cache["ssm"], new_state, commit)
    return out, cache
