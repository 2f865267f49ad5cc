"""Hybrid decode traffic: long-context sessions of a model whose layers hold
two kinds of decode state, an attention layer's KV cache and a Mamba
layer's conv window and SSM state, decoded in a closed loop, one token a
slot a step.

As the ``decode`` kind (``kinds/decode.py``, whose step, window clock and
K/V comparison this kind takes): ``slots`` sessions over a cache of
``max_len`` positions, the history lengths of every seed the same
(``history_lengths``, evenly spaced), dealt in an order drawn from the
seed; each attention layer's history K and V rows N(0, ``history_std``^2)
in bfloat16, stored in the plan's ``kv_dtype``; the greedy token of each
step fed back and read to the host every step; ``warmup_steps`` steps of
set-up before the window.  A slot's history is drawn one slot at a time
(``slot_history``: a whole layer's would be a temporary of ``slots`` times
the size), from a generator of its own.

Each Mamba layer starts from a state drawn from the seed (``mamba_state``):
its conv window, the ``conv_width - 1`` inputs of the conv before the
session's next token, N(0, ``conv_std``^2) in the model's dtype, and its
SSM state N(0, ``ssm_std``^2) in float32, the program's cache dtypes.  The
traffic file gives both stds (``PERF.md`` argues them: what a layer's own
inputs give a state that has run for a while).

``correct``: the reference (``reference/hybrid.py``) runs every session
over the tokens it was served, from the drawn state: its attention layers
over the drawn history (dequantized, as the program reads it) and the rows
it writes after it, in blocks of ``QUERY_BLOCK`` queries; its Mamba layers
from the drawn conv window and SSM state.  It compares four numbers.
``token_gap_p99`` and ``kv_median_err``, as the decode kind computes them
(``decode.compare``); ``ssm_state_err``: the largest, over the Mamba
layers, of the relative error (Frobenius, every slot) of the SSM state the
program's served steps left against the reference's; and
``ssm_first_layer_err``: the widest row error (one slot's one channel, its
``ssm_state`` values) of the first Mamba layer's final state, whose inputs
are the served tokens' embeddings, exact on both sides, so that a fault of
a few channels or of one slot shows there undiluted.  Not the decode
kind's ``kv_first_layer_err``: here the first attention layer lies after
four Mamba layers and two MoE layers, so its widest row error measures a
token routed to another expert in bfloat16 than in float32, as a deep
layer's does in the decode kind, and not the program (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import gc
from pathlib import Path

import torch

from cardbench import bench, draw
from cardbench import work as W
from cardbench.reference.ops import quantize_rows

decode = bench.load_module(Path(__file__).with_name("decode.py"))

PRECISION = "float32"  # the reference's; the control runs it at float8
QUERY_BLOCK = 64  # the reference's queries of a slot attended together
FLAGS = ("mamba_inner_norms", "moe_renormalize")  # the program's fields the reference assumes

history_lengths = decode.history_lengths
attn_layers = decode.attn_layers
serve = decode.serve


class State:
    pass


def sizes(run) -> dict:
    """The configuration file's sizes with its ``hybrid`` group's ``d_inner``."""
    return {**run.cell.config["sizes"], "d_inner": run.cell.config["hybrid"]["d_inner"]}


def mamba_layers(cfg) -> list:
    """``(block name, period)`` of every Mamba layer, in order."""
    blocks = [f"b{i}" for i, s in enumerate(cfg.layer_plan()) if s.mixer == "mamba"]
    return [(b, p) for p in range(cfg.n_periods) for b in blocks]


def check_program(run) -> None:
    """The program's sizes and fields the configuration file states beyond
    ``sizes`` (which ``run.port_config`` checks)."""
    hybrid = run.cell.config["hybrid"]
    for key in ("d_inner", *FLAGS):
        have = getattr(run.cfg, key)
        if have != hybrid[key]:
            raise ValueError(f"the program's {key} is {have}, the configuration file's {hybrid[key]}")


def slot_history(run, block: str, period: int, name: str, slot: int, length: int, device):
    """``(codes, scales)`` or bfloat16 rows of one slot's K or V history:
    ``(kv heads, length, head size)``, drawn and quantized a head at a time
    (a whole slot's float32 temporaries would be ~3 GiB at 240K positions)."""
    cfg, tr = run.cfg, run.cell.traffic
    gen = draw.generator(device, run.seed, "history", f"{block}.{period}", name, slot)
    heads = []
    for _ in range(cfg.n_kv_heads):
        t = torch.empty((length, cfg.resolved_head_dim), dtype=torch.bfloat16, device=device)
        t.normal_(0.0, tr["history_std"], generator=gen)
        heads.append(quantize_rows(t) if run.plan.kv_dtype == "int8" else t)
    if run.plan.kv_dtype == "int8":
        return torch.stack([c for c, _ in heads]), torch.stack([s for _, s in heads])
    return torch.stack(heads)


def mamba_state(run, block: str, period: int, device):
    """A Mamba layer's drawn conv window ``(slots, K - 1, Di)`` in the model's
    dtype and SSM state ``(slots, Di, N)`` in float32."""
    cfg, tr = run.cfg, run.cell.traffic
    conv = torch.empty((tr["slots"], cfg.conv_width - 1, cfg.d_inner), dtype=getattr(torch, cfg.dtype),
                       device=device)
    ssm = torch.empty((tr["slots"], cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device)
    layer = f"{block}.{period}"
    conv.normal_(0.0, tr["conv_std"], generator=draw.generator(device, run.seed, "mamba", layer, "conv"))
    ssm.normal_(0.0, tr["ssm_std"], generator=draw.generator(device, run.seed, "mamba", layer, "ssm"))
    return conv, ssm


def setup(run) -> State:
    from repro_torch.models import transformer
    from repro_torch.training.train_step import make_serve_step

    tr, cfg, dev = run.cell.traffic, run.cfg, run.device
    check_program(run)
    st = State()
    st.meta = transformer.meta_params(cfg)
    with decode._span("weights"):
        st.params = draw.weights(st.meta, run.cell.config["init"], cfg.n_layers, run.seed, dev)
    st.hist = history_lengths(tr, run.seed)
    if max(st.hist) + tr["warmup_steps"] + tr["most_steps"] > tr["max_len"]:
        raise ValueError("a slot's history and the steps served overflow the cache")
    with decode._span("cache"):
        st.cache = transformer.init_cache(cfg, tr["slots"], tr["max_len"], kv_dtype=run.plan.kv_dtype,
                                          device=dev)
        for block, p in attn_layers(cfg):
            c = st.cache[block]
            for name in ("k", "v"):
                for b, h in enumerate(st.hist):
                    drawn = slot_history(run, block, p, name, b, h, dev)
                    if run.plan.kv_dtype == "int8":
                        c[name][p, b, :, :h] = drawn[0]
                        c[name + "_s"][p, b, :, :h] = drawn[1]
                    else:
                        c[name][p, b, :, :h] = drawn
                    del drawn
        for block, p in mamba_layers(cfg):
            conv, ssm = mamba_state(run, block, p, dev)
            st.cache[block]["conv"][p].copy_(conv)
            st.cache[block]["ssm"][p].copy_(ssm)
    st.step = make_serve_step(cfg, None, run.plan, device=dev)
    st.cur = torch.tensor(st.hist, dtype=torch.long, device=dev)
    st.tok = draw.token_rows(tr["slots"], 1, cfg.vocab_size, run.seed, dev, name="first")
    st.served = [st.tok[:, 0].cpu()]
    with decode._span("warmup"):
        for _ in range(tr["warmup_steps"]):
            serve(st)
    return st


def step_work(run, positions) -> W.Work:
    """``work.decode_work`` at ``positions``, with the bytes it leaves out of a
    Mamba layer: the conv window and SSM state read and written, and the
    inner norms' weights."""
    cfg, s = run.cfg, sizes(run)
    wk = W.decode_work(s, positions, run.plan.kv_dtype, cfg.dtype)
    e = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    Di, N = cfg.d_inner, cfg.ssm_state
    state = 2 * len(positions) * ((cfg.conv_width - 1) * Di * e + Di * N * 4)
    norms = (cfg.resolved_dt_rank + 2 * N) * e
    return W.Work(wk.flops, wk.bytes + len(mamba_layers(cfg)) * (state + norms), wk.ops_dtype)


def window(st: State, run) -> None:
    """``decode.window`` over the sizes with the Mamba width, then the mean
    step's work with the Mamba state (``step_work``)."""
    cell = run.cell
    run.cell = dataclasses.replace(cell, config={**cell.config, "sizes": sizes(run)})
    try:
        decode.window(st, run)
    finally:
        run.cell = cell
    n = run.attempted  # the window's steps; the set-up's came before it
    first = len(st.served) - 1 - n
    wk = step_work(run, [round(h + first + (n - 1) / 2) for h in st.hist])
    run.work = {"step_flops": wk.flops, "step_bytes": wk.bytes}


def finish(st: State, run) -> None:
    st.written = decode.written_rows(st, run)
    for block, p in mamba_layers(run.cfg):
        st.written[(block, p, "ssm")] = st.cache[block]["ssm"][p].float().clone()
    st.served = torch.stack(st.served, dim=1)  # (slots, steps + 1): fed tokens, then served
    for name in ("params", "cache", "step", "tok", "cur"):
        setattr(st, name, None)
    gc.collect()
    torch.cuda.empty_cache()


def _attend_slot(q, old, new, h: int, prec: str, dequantize):
    """Slot attention of ``q (H, n, hd)`` at positions ``h..h + n - 1`` over
    its history ``old`` (K, V as drawn) and the new rows ``new`` (K, V
    ``(Hkv, n, hd)``), ``QUERY_BLOCK`` queries at a time: ``(n, H * hd)``."""
    from cardbench.reference import model as M

    k, v = (torch.cat([dequantize(o), x], dim=1) for o, x in zip(old, new))
    n, dev = q.shape[1], q.device
    kpos = torch.arange(h + n, device=dev)
    outs = []
    for j in range(0, n, QUERY_BLOCK):
        qpos = h + torch.arange(j, min(j + QUERY_BLOCK, n), device=dev)
        outs.append(M.attend(q[:, j:j + QUERY_BLOCK], k, v, qpos, kpos, prec))
    return torch.cat(outs, dim=0)


@torch.no_grad()
def reference_outputs(run, meta, hist, served, precision: str):
    """``(logits (slots, steps, vocab), rows)`` of the reference over every
    session's served tokens from its drawn history and state; ``rows``: the
    K and V rows it writes, ``{(block, period, "k" | "v"): (slots, kv heads,
    steps, head size)}``, then each Mamba layer's final SSM state,
    ``{(block, period, "ssm"): (slots, Di, N)}``."""
    from cardbench.reference import hybrid as H
    from cardbench.reference import model as M
    from cardbench.reference import ops as R

    R.strict_float32()
    dev = run.device
    m = H.model_of(run.cell.config)
    params = draw.weights(meta, run.cell.config["init"], m.n_layers, run.seed, dev)
    inputs = served[:, :-1].to(dev)  # (B, n)
    h = params["embed"][inputs].float()
    int8 = run.plan.kv_dtype == "int8"

    def dequantize(drawn):
        return R.dequantize_rows(*drawn) if int8 else drawn.float()

    rows, states = {}, {}
    for p, i, (mixer, kind) in M.slots(m):
        block = f"b{i}"
        w = M.period_slice(params["blocks"][block], p)
        hn = R.rmsnorm(h, w["norm1"], m.norm_eps)
        if mixer == "mamba":
            conv, ssm = mamba_state(run, block, p, dev)
            out, _, states[(block, p, "ssm")] = H.mamba(w["mamba"], m, hn, precision, conv, ssm)
        else:
            q, k, v = H.qkv(w["attn"], m, hn, precision)  # (B, H, n, hd), (B, Hkv, n, hd)
            new = {}
            for name, x in (("k", k), ("v", v)):
                x = R.dequantize_rows(*R.quantize_rows(x)) if int8 else x.to(torch.bfloat16).float()
                rows[(block, p, name)] = new[name] = x
            outs = []
            for b, hb in enumerate(hist):
                old = [slot_history(run, block, p, name, b, hb, dev) for name in ("k", "v")]
                outs.append(_attend_slot(q[b], old, (new["k"][b], new["v"][b]), hb, precision, dequantize))
                del old
            out = R.mm(torch.stack(outs), w["attn"]["wo"], precision)
        h = h + out
        if kind != "none":
            hn = R.rmsnorm(h, w["norm2"], m.norm_eps)
            # a step routes its slots' tokens together: groups of B tokens, one a step
            h = h + H.mlp(w["mlp"], m, kind, hn.transpose(0, 1), precision).transpose(0, 1)
        del w
    top = {k: params[k].float() for k in ("final_norm", "embed" if m.tie_embeddings else "head")}
    del params  # the logits of every step may be as large as a quarter of the weights
    return M.logits(top, m, h, precision), {**rows, **states}


def compare(logits: torch.Tensor, rows: dict, served: torch.Tensor, written: dict) -> dict:
    """The numbers ``correct`` compares (see the module's docstring)."""
    kv = {k: v for k, v in rows.items() if k[2] != "ssm"}
    numbers = decode.compare(logits, kv, served, written)
    out = {name: numbers[name] for name in ("token_gap_p99", "kv_median_err")}
    errs = []
    for key, ref in rows.items():
        if key[2] == "ssm":
            got = written[key].to(ref.device)
            errs.append(float((got - ref).norm() / ref.norm().clamp(min=1e-30)))
            if len(errs) == 1:  # the first Mamba layer, row by row
                row = (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)
                out["ssm_first_layer_err"] = float(row.max())
    out["ssm_state_err"] = max(errs)
    return out


def check(st: State, run) -> None:
    logits, rows = reference_outputs(run, st.meta, st.hist, st.served, PRECISION)
    for name, value in compare(logits, rows, st.served, st.written).items():
        run.check(name, value)
