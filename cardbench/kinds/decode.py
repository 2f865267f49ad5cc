"""Decode traffic: long-context sessions decoded in a closed loop, one token a
slot a step.

The traffic file gives ``slots`` sessions over a cache of ``max_len``
positions.  Every seed serves the same set of history lengths
(``history_lengths``: evenly spaced from ``lo`` to ``hi``), dealt to the
slots in an order drawn from the seed.  A slot's history is the cache of
its first positions: K and V rows drawn N(0, ``history_std``^2) in
bfloat16 from the seed, stored in the plan's ``kv_dtype`` (int8: codes and
scales by the benchmark's own rowwise rule, ``reference/ops.quantize_rows``);
the positions past it hold what the program's empty cache holds.  Each slot
then feeds a token drawn from the seed at its first free position, and
every step after feeds back the greedy token of the step before, read to
the host each step, as a streaming server does.  ``warmup_steps`` steps of
set-up serve the same sessions before the window.

A step is one call of the program's serve step (``make_serve_step``, a
position per slot) from its launch until its tokens are on the host.

``correct``: the reference (``reference/model.py``) runs every session
once over its history and the tokens it was served, all steps of all
slots, and compares three numbers.  ``token_gap_p99``: the 99th percentile
of the gaps by which a served token's reference logit lies below the
reference's best at that position.  ``kv_first_layer_err``: the widest
relative error of a K or V row (a head's row, codes times scale) that the
served steps wrote into the first attention layer's cache, against the row
the reference writes there.  ``kv_median_err``: the median of those errors
over a layer's rows, at the layer where it is largest.  Not the widest gap,
nor the widest row error of a deep layer: a bf16 forward and a float32 one
route a few tokens to another expert, and from there on their hidden states
part, more with each layer, so those widest readings measure that and not
the program (``PERF.md``).
"""
from __future__ import annotations

import gc
import time

import torch

from cardbench import bench, draw
from cardbench import work as W
from cardbench.reference.ops import quantize_rows

PRECISION = "float32"  # the reference's; the control runs it at float8


def _span(name):
    return torch.profiler.record_function(name)


class State:
    pass


def history_lengths(traffic: dict, seed: int) -> list:
    lo, hi = traffic["history_lengths"]
    n = traffic["slots"]
    lengths = [lo + round(i * (hi - lo) / (n - 1)) for i in range(n)]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(draw.sub_seed(seed, "order")))
    return [lengths[i] for i in order.tolist()]


def attn_layers(cfg) -> list:
    """``(block name, period)`` of every attention layer, in order."""
    blocks = [f"b{i}" for i, s in enumerate(cfg.layer_plan()) if s.mixer == "attn"]
    return [(b, p) for p in range(cfg.n_periods) for b in blocks]


def layer_history(run, block: str, period: int, name: str, device):
    """``(codes, scales)`` or bfloat16 rows of one layer's K or V history,
    every slot and position (those past a slot's history are not used)."""
    tr, cfg = run.cell.traffic, run.cfg
    shape = (tr["slots"], cfg.n_kv_heads, tr["max_len"], cfg.resolved_head_dim)
    x = draw.history(shape, tr["history_std"], run.seed, f"{block}.{period}", name, device)
    return quantize_rows(x) if run.plan.kv_dtype == "int8" else x


def setup(run) -> State:
    from repro_torch.models import transformer
    from repro_torch.training.train_step import make_serve_step

    tr, cfg, dev = run.cell.traffic, run.cfg, run.device
    st = State()
    st.meta = transformer.meta_params(cfg)
    with _span("weights"):
        st.params = draw.weights(st.meta, run.cell.config["init"], cfg.n_layers, run.seed, dev)
    st.hist = history_lengths(tr, run.seed)
    if max(st.hist) + tr["warmup_steps"] + tr["most_steps"] > tr["max_len"]:
        raise ValueError("a slot's history and the steps served overflow the cache")
    with _span("cache"):
        st.cache = transformer.init_cache(cfg, tr["slots"], tr["max_len"], kv_dtype=run.plan.kv_dtype,
                                          device=dev)
        for block, p in attn_layers(cfg):
            c = st.cache[block]
            for name in ("k", "v"):
                drawn = layer_history(run, block, p, name, dev)
                for b, h in enumerate(st.hist):
                    if run.plan.kv_dtype == "int8":
                        c[name][p, b, :, :h] = drawn[0][b, :, :h]
                        c[name + "_s"][p, b, :, :h] = drawn[1][b, :, :h]
                    else:
                        c[name][p, b, :, :h] = drawn[b, :, :h]
                del drawn
    st.step = make_serve_step(cfg, None, run.plan, device=dev)
    st.cur = torch.tensor(st.hist, dtype=torch.long, device=dev)
    st.tok = draw.token_rows(tr["slots"], 1, cfg.vocab_size, run.seed, dev, name="first")
    st.served = [st.tok[:, 0].cpu()]
    with _span("warmup"):
        for _ in range(tr["warmup_steps"]):
            serve(st)
    return st


def serve(st: State) -> bool:
    """One step of every slot: returns whether every row's logits were finite."""
    with _span("step"):
        logits, _ = st.step(st.params, st.cache, st.tok, st.cur)
        nxt = logits.argmax(dim=-1)
        ok = logits.isfinite().all()
    with _span("tokens_to_host"):
        host = torch.cat([nxt, ok[None].long()]).cpu()
    st.served.append(host[:-1])
    st.tok = nxt[:, None]
    st.cur += 1
    return bool(host[-1])


def window(st: State, run) -> None:
    from repro_torch.kernels import ops

    tr = run.cell.traffic
    ops.reset_counters()
    bench.sync(run.device)
    run.window_start = time.perf_counter()
    first = len(st.served) - 1  # the steps served before the window
    while True:
        t0 = time.perf_counter()
        ok = serve(st)
        t1 = time.perf_counter()
        run.step_starts.append(t0)
        run.step_ends.append(t1)
        run.step_tokens.append(tr["slots"])
        run.attempted += 1
        run.failed += not ok
        served = len(st.served) - 1
        if t1 - run.window_start >= run.seconds or served >= tr["warmup_steps"] + tr["most_steps"]:
            break
    run.launches = ops.launch_counts()
    # the mean step's work: slot b at position hist[b] + j of the window's step j
    n = len(st.served) - 1 - first
    mid = [h + first + (n - 1) / 2 for h in st.hist]
    wk = W.decode_work(run.cell.config["sizes"], [round(x) for x in mid], run.plan.kv_dtype)
    run.work = {"step_flops": wk.flops, "step_bytes": wk.bytes}


def written_rows(st: State, run) -> dict:
    """The K and V rows the served steps wrote: per attention layer and
    name, ``(slots, kv heads, steps, head size)`` float32 (codes times scales)."""
    n = len(st.served) - 1
    out = {}
    for block, p in attn_layers(run.cfg):
        c = st.cache[block]
        for name in ("k", "v"):
            rows = torch.stack([c[name][p, b, :, h:h + n] for b, h in enumerate(st.hist)])
            if name + "_s" in c:
                scales = torch.stack([c[name + "_s"][p, b, :, h:h + n] for b, h in enumerate(st.hist)])
                rows = rows.float() * scales
            out[(block, p, name)] = rows.float()
    return out


def finish(st: State, run) -> None:
    st.written = written_rows(st, run)
    st.served = torch.stack(st.served, dim=1)  # (slots, steps + 1): fed tokens, then served
    for name in ("params", "cache", "step", "tok", "cur"):
        setattr(st, name, None)
    gc.collect()
    torch.cuda.empty_cache()


@torch.no_grad()
def reference_outputs(run, meta, hist, served, precision: str):
    """``(logits (slots, steps, vocab), {(block, period, name): rows})`` of the
    reference over every session's history and served tokens."""
    from cardbench.reference import model as M
    from cardbench.reference import ops as R

    R.strict_float32()
    dev = run.device
    m = M.Model.from_file(run.cell.config)
    params = draw.weights(meta, run.cell.config["init"], m.n_layers, run.seed, dev)
    inputs = served[:, :-1].to(dev)  # (B, n)
    B, n = inputs.shape
    pos = torch.tensor(hist, device=dev)[:, None] + torch.arange(n, device=dev)  # (B, n)
    h = params["embed"][inputs].float()
    rows = {}
    attn = iter(attn_layers(run.cfg))
    for p, i, (mixer, kind) in M.slots(m):
        w = M.period_slice(params["blocks"][f"b{i}"], p)
        hn = R.rmsnorm(h, w["norm1"], m.norm_eps)
        if mixer != "attn":
            raise ValueError("the decode reference runs attention layers only")
        block, period = next(attn)
        q, k, v = M.qkv(w["attn"], m, hn, pos, precision)  # (B, H, n, hd), (B, Hkv, n, hd)
        kv = {}
        for name, new in (("k", k), ("v", v)):
            if run.plan.kv_dtype == "int8":
                new = R.dequantize_rows(*R.quantize_rows(new))
            else:
                new = new.to(torch.bfloat16).float()
            rows[(block, period, name)] = new
            kv[name] = (layer_history(run, block, period, name, dev), new)
        outs = []
        for b, hb in enumerate(hist):
            def keys(name):
                drawn, new = kv[name]
                old = (R.dequantize_rows(drawn[0][b, :, :hb], drawn[1][b, :, :hb])
                       if isinstance(drawn, tuple) else drawn[b, :, :hb].float())
                return torch.cat([old, new[b]], dim=1)

            kpos = torch.arange(hb + n, device=dev)
            outs.append(M.attend(q[b], keys("k"), keys("v"), pos[b], kpos, precision))
        del kv
        h = h + R.mm(torch.stack(outs), w["attn"]["wo"], precision)
        hn = R.rmsnorm(h, w["norm2"], m.norm_eps)
        # a step routes its slots' tokens together: groups of B tokens, one a step
        h = h + M.mlp(w["mlp"], m, kind, hn.transpose(0, 1), precision).transpose(0, 1)
    top = {k: params[k].float() for k in ("final_norm", "embed" if m.tie_embeddings else "head")}
    return M.logits(top, m, h, precision), rows


def compare(logits: torch.Tensor, rows: dict, served: torch.Tensor, written: dict) -> dict:
    """The numbers ``correct`` compares (see the module's docstring) of the
    served tokens ``served[:, 1:]`` and the written rows."""
    nxt = served[:, 1:].to(logits.device)
    gap = (logits.max(dim=-1).values - logits.gather(-1, nxt[..., None])[..., 0]).flatten()
    first, errs = next(iter(rows))[:2], {}
    for key, ref in rows.items():
        got = written[key].to(ref.device)
        errs[key] = ((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)).flatten()
    layers = {k[:2] for k in errs}
    return {"token_gap_p99": float(torch.quantile(gap, 0.99)),
            "kv_first_layer_err": max(float(e.max()) for k, e in errs.items() if k[:2] == first),
            "kv_median_err": max(float(torch.cat([e for k, e in errs.items() if k[:2] == layer]).median())
                                 for layer in layers)}


def check(st: State, run) -> None:
    logits, rows = reference_outputs(run, st.meta, st.hist, st.served, PRECISION)
    for name, value in compare(logits, rows, st.served, st.written).items():
        run.check(name, value)
