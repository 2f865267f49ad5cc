#!/usr/bin/env python3
"""Proof that the PyTorch port runs on one NVIDIA H100, through its own kernels.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with one card

Phases, one JSON line each (every line carries the card's name and power
limit as ``nvidia-smi`` reports them):

1. ``device``: torch, CUDA, the card.
2. ``build``: both CUDA kernels compiled with ``nvcc`` for ``sm_90a`` from
   ``src/repro_torch/kernels/csrc/``; seconds and ``ptxas -v`` lines.
3. ``kernels.rmsnorm`` / ``kernels.flash_attention``: each kernel against its
   plain PyTorch version on the card, at the main path's shapes and at the
   shapes of ``tests/test_kernels.py`` (plus ragged ones); error and
   tolerance, kernel / plain / library ms (CUDA events), and the bound.
4. ``prefill``: full-width granite-3-2b through ``make_prefill_step`` at
   1x4096 tokens, once with the default plan tile and once with another;
   plan tile == launched tile, launches, median step time, tokens/s, memory.
5. ``serve``: full-width granite-3-2b through ``ServingEngine``.
6. ``profile``: ``torch.profiler`` over one prefill and one decode step.
7. ``parity``: a 2-layer f32 granite-shaped model, card (kernels) against
   the port's CPU path (plain versions).
8. ``kernels``: one summary entry per ported kernel.

Any failure raises and exits non-zero.  The last line is the contract's
``{"ok": true, "device": {...}}``.  Weights are random, drawn on the card
from a seed; nothing is downloaded.  Nothing of JAX is imported.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
SEQ = 4096
SEED = 0

CARD = {"card": None, "power_limit": None}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, **CARD}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# bf16 is held element by element and, since attention outputs at 4096 tokens
# are far smaller than 5e-2, also in norm relative to what it compares: over
# the whole output and over each row of the last axis
TOL_BF16 = dict(atol=5e-2, rtol=5e-2, rel=1e-2, row_rel=5e-2)


def check_close(got, exp, what: str, *, atol: float, rtol: float, rel=None, row_rel=None) -> dict:
    got, exp = got.float(), exp.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = got - exp
    err = diff.abs()
    row_err = diff.reshape(-1, diff.shape[-1]).norm(dim=-1)
    row_exp = exp.reshape(-1, exp.shape[-1]).norm(dim=-1).clamp_min(1e-30)
    stats = {
        "max_abs_err": err.max().item(), "mean_abs_exp": exp.abs().mean().item(),
        "rel_err": (diff.norm() / exp.norm().clamp_min(1e-30)).item(),
        "worst_row_rel_err": (row_err / row_exp).max().item(),
        "elementwise_ok": not bool((err > atol + rtol * exp.abs()).any()),
        "atol": atol, "rtol": rtol, "rel_tol": rel, "row_rel_tol": row_rel,
    }
    if (not stats["elementwise_ok"] or (rel is not None and stats["rel_err"] > rel)
            or (row_rel is not None and stats["worst_row_rel_err"] > row_rel)):
        raise AssertionError(f"{what}: beyond tolerance: {json.dumps(stats)}")
    return stats


def ptxas_lines(text: str) -> list:
    """One entry per compiled kernel: registers, spills, shared memory."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            base = re.search(r"(flash_fwd_bf16|flash_fwd_f32|rmsnorm_kernel)", name)
            arg = re.search(r"ILi(\d+)E|I(f|13__nv_bfloat16)E", name)
            label = base.group(1) if base else name
            if arg:
                label += f"<{arg.group(1) or ('float' if arg.group(2) == 'f' else 'bf16')}>"
            cur = {"kernel": label}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return out


# ---------------------------------------------------------------------------
def phase_kernels_rmsnorm(torch, F, rn):
    cases = [
        ((SEQ, 2048), "bfloat16", "prefill"),
        ((4, 2048), "bfloat16", "decode"),
        ((3, 7, 64), "float32", "test"), ((16, 128), "float32", "test"), ((5, 96), "float32", "test"),
        ((3, 7, 64), "bfloat16", "test"), ((16, 128), "bfloat16", "test"), ((5, 96), "bfloat16", "test"),
        ((7, 2050), "bfloat16", "ragged width"), ((9, 1000), "float32", "ragged width"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for shape, dtype, role in cases:
        dt = getattr(torch, dtype)
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        w = torch.randn(shape[-1:], generator=gen, device="cuda").to(dt)
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=2e-4, rtol=2e-4)
        got = rn.rmsnorm(x, w)
        torch.cuda.synchronize()
        stats = check_close(got, rn.rmsnorm_plain(x, w), f"rmsnorm {shape} {dtype}", **tol)
        row = {"shape": list(shape), "dtype": dtype, "role": role, **stats}
        if role in ("prefill", "decode"):
            n, d = x.numel(), shape[-1]
            b_ms, b_by = bound(2 * n * x.element_size() + d * w.element_size(), 4 * n, "float32")
            row.update(
                ms=cuda_ms(torch, lambda: rn.rmsnorm(x, w)),
                plain_ms=cuda_ms(torch, lambda: rn.rmsnorm_plain(x, w)),
                library_ms=cuda_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6)),
                bound_ms=b_ms, bound_by=b_by,
            )
        rows.append(row)
    emit("kernels.rmsnorm", cases=rows)
    return rows


def _visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    if not causal:
        return Sq * Skv
    q_off = Skv - Sq
    return sum(min(Skv, max(0, q_off + i + 1)) for i in range(Sq))


def phase_kernels_flash(torch, F, fa):
    # (B, Hq, Hkv, Sq, Skv, D, block_q, block_kv, causal, dtype, role)
    cases = [
        (1, 32, 8, SEQ, SEQ, 64, 256, 256, True, "bfloat16", "prefill, plan (256,256)"),
        (1, 32, 8, SEQ, SEQ, 64, 128, 128, True, "bfloat16", "prefill, plan (128,128)"),
        (2, 4, 2, 256, 256, 64, 128, 128, True, "float32", "test"),
        (1, 8, 8, 128, 128, 32, 64, 64, True, "float32", "test MHA"),
        (2, 4, 1, 256, 256, 64, 128, 64, True, "float32", "test MQA"),
        (1, 4, 2, 256, 256, 128, 256, 128, True, "float32", "test block_q == S"),
        (2, 4, 2, 128, 128, 64, 128, 128, False, "float32", "test non-causal"),
        (1, 2, 2, 512, 512, 64, 128, 256, True, "float32", "test bkv > bq"),
        (1, 4, 2, 128, 128, 64, 64, 64, True, "bfloat16", "test bf16"),
        (1, 4, 2, 300, 300, 64, 128, 128, True, "bfloat16", "ragged Sq=Skv=300"),
        (1, 4, 2, 300, 300, 64, 128, 128, True, "float32", "ragged Sq=Skv=300"),
        (2, 4, 2, 100, 333, 64, 64, 128, True, "bfloat16", "ragged, Sq < Skv"),
        (2, 4, 2, 100, 333, 64, 64, 128, True, "float32", "ragged, Sq < Skv"),
        (1, 4, 2, 200, 200, 128, 128, 128, True, "bfloat16", "head_dim 128"),
        (1, 4, 4, 96, 96, 16, 32, 64, False, "bfloat16", "head_dim 16, non-causal"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for B, Hq, Hkv, Sq, Skv, D, bq, bkv, causal, dtype, role in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((B, Hq, Sq, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda").to(dt)
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)
        fa.LAUNCHES.reset()
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
        torch.cuda.synchronize()
        tile = sorted(fa.LAUNCHES.tiles)
        want = (min(bq, Sq), min(bkv, Skv))
        if tile != [want]:
            raise AssertionError(f"flash tile {tile} launched for requested {(bq, bkv)}")
        exp = fa.attention_plain(q, k, v, causal=causal)
        stats = check_close(got, exp, f"flash {role} {dtype}", **tol)
        row = {
            "shape": [B, Hq, Hkv, Sq, Skv, D], "dtype": dtype, "causal": causal, "role": role,
            "tile_requested": [bq, bkv], "tile_launched": list(want),
            "ragged": Sq % want[0] != 0 or Skv % want[1] != 0, **stats,
        }
        if role.startswith("prefill"):
            esz = q.element_size()
            nbytes = 2 * q.numel() * esz + 2 * k.numel() * esz
            ops = 4 * D * _visible_pairs(Sq, Skv, causal) * B * Hq
            b_ms, b_by = bound(nbytes, ops, dtype)
            row.update(
                ms=cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)),
                plain_ms=cuda_ms(torch, lambda: fa.attention_plain(q, k, v, causal=causal), iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)),
                bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
            )
        rows.append(row)
    emit("kernels.flash_attention", cases=rows)
    return rows


# ---------------------------------------------------------------------------
def phase_prefill(torch, np, cfg, params, plans, ops, make_prefill_step, make_positions):
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, SEQ))
    batch = {
        "inputs": torch.from_numpy(tokens).to("cuda"),
        "positions": make_positions(cfg, 1, SEQ, device="cuda"),
    }
    results, logits_by_plan, launches = [], {}, None
    for plan in plans:
        step = make_prefill_step(cfg, None, plan, device="cuda")
        step(params, batch)  # warm-up: cuBLAS heuristics, allocator
        torch.cuda.synchronize()
        ops.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        logits = step(params, batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        tiles = sorted(ops.COUNTERS["flash_attention"].tiles)
        if counts != {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}:
            raise AssertionError(f"prefill launches {counts}")
        if tiles != [tuple(plan.attn_block)]:
            raise AssertionError(f"plan tile {plan.attn_block} but launched {tiles}")
        if tuple(logits.shape) != (1, SEQ, cfg.vocab_size) or not bool(logits.isfinite().all()):
            raise AssertionError("prefill logits of the wrong shape or not finite")
        peak = torch.cuda.max_memory_allocated()
        if launches is None:
            launches = counts
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        logits_by_plan[plan.attn_block] = logits
        results.append({
            "plan_tile": list(plan.attn_block), "launched_tile": [list(t) for t in tiles],
            "launches": counts, "median_step_ms": med * 1e3, "step_ms": [t * 1e3 for t in times],
            "tokens_per_s": SEQ / med, "peak_memory_gib": peak / 2**30,
        })
    # the kernel's softmax steps over 64 keys whatever the tile and a warp's
    # rows do not depend on block_q, so the two tiles give the same bits
    a, b = (logits_by_plan[p.attn_block] for p in plans)
    if not torch.equal(a, b):
        raise AssertionError(
            f"the two plan tiles' logits differ: max abs {(a.float() - b.float()).abs().max().item()}")
    emit("prefill", arch=cfg.name, tokens=SEQ, runs=results, tiles_logits_identical=True)
    return results, launches, step, batch


def phase_serve(torch, np, cfg, params, ops, ServingEngine):
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=128, device="cuda")
    rng = np.random.default_rng(SEED)
    n_req = 6
    for _ in range(n_req):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17))), max_new_tokens=16)
    ops.reset_counters()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if len(done) != n_req or any(len(r.generated) != 16 for r in done):
        raise AssertionError(f"served {len(done)}/{n_req} requests")
    if counts["rmsnorm"] == 0:
        raise AssertionError("serving launched no rmsnorm kernel")
    mask = np.ones((eng.slots,), bool)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng._decode(mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    emit("serve", arch=cfg.name, slots=eng.slots, max_len=eng.max_len,
         completed=len(done), submitted=n_req, generated=sum(len(r.generated) for r in done),
         run_s=wall, launches=counts, median_decode_step_ms=statistics.median(times) * 1e3,
         decode_step_ms=[t * 1e3 for t in times])
    return counts, eng


def _kernel_group(name: str) -> str:
    if "rmsnorm_kernel" in name or "flash_fwd" in name:
        return "kernels"
    if re.search(r"gemm|cutlass|nvjet|xmma|sm90_|cublas|matmul", name, re.I):
        return "matmul"
    return "other"


def _profile_one(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_group, other = [], {"kernels": 0.0, "matmul": 0.0, "other": 0.0}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms = (end - start) / 1e3
        group = _kernel_group(e.name)
        by_group[group] += ms
        if group == "other":
            other[e.name] = other.get(e.name, 0.0) + ms
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ms = (busy + cur_e - cur_s) / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "device_ms_by_group": by_group, "device_events": len(spans),
        "top_other": [{"name": n[:90], "ms": ms} for n, ms in top],
    }


def phase_profile(torch, np, step, params, batch, eng):
    mask = np.ones((eng.slots,), bool)
    emit("profile", note="profiler on: wall times include its overhead",
         prefill=_profile_one(torch, lambda: step(params, batch)),
         decode=_profile_one(torch, lambda: eng._decode(mask)))


def phase_parity(torch, np, base_cfg, ops, transformer, make_positions):
    cfg = dataclasses.replace(base_cfg, n_layers=2, dtype="float32")
    params_cpu = transformer.init_params(cfg, SEED, device="cpu")
    params_gpu = _tree_to(params_cpu, "cuda")
    S = 320  # ragged against the default (256, 256) tile
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, (1, S)))
    ops.reset_counters()
    got = transformer.forward(params_gpu, cfg, tokens.cuda(), make_positions(cfg, 1, S, device="cuda"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts != {"rmsnorm": 5, "flash_attention": 2}:
        raise AssertionError(f"parity run launches {counts}")
    exp = transformer.forward(params_cpu, cfg, tokens, make_positions(cfg, 1, S, device="cpu"))
    stats = check_close(got.cpu(), exp, "2-layer f32 logits, card vs CPU", atol=1e-3, rtol=1e-3)
    emit("parity", arch=cfg.name, n_layers=2, dtype="float32", tokens=S,
         tile=[256, 256], launches=counts, **stats, logits_abs_max=exp.abs().max().item())


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.space import SchedulePlan
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.train_step import make_positions, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain versions in true f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name, _, limit = smi.partition(",")
    CARD.update(card=name.strip(), power_limit=limit.strip())
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    _build.build(["rmsnorm", "flash_attention"])
    emit("build", seconds=time.perf_counter() - t0, flags=" ".join(_build.NVCC_FLAGS),
         ptxas={n: ptxas_lines(_build.ptxas_report(n)) for n in ("rmsnorm", "flash_attention")})

    rms_rows = phase_kernels_rmsnorm(torch, F, rn)
    fa_rows = phase_kernels_flash(torch, F, fa)

    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, seconds=time.perf_counter() - t0,
         params=sum(t.numel() for t in _leaves(params)))
    plans = [SchedulePlan(), SchedulePlan(attn_block=(128, 128))]
    _, prefill_launches, step, batch = phase_prefill(
        torch, np, cfg, params, plans, ops, make_prefill_step, make_positions)
    serve_launches, eng = phase_serve(torch, np, cfg, params, ops, ServingEngine)
    phase_profile(torch, np, step, params, batch, eng)
    del eng, params, step, batch
    torch.cuda.empty_cache()
    phase_parity(torch, np, cfg, ops, transformer, make_positions)

    main_rms, main_fa = rms_rows[0], fa_rows[0]
    summary = []
    for name, row, rows, src, replaces in (
        ("rmsnorm", main_rms, rms_rows, "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:45"),
        ("flash_attention", main_fa, fa_rows, "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:129"),
    ):
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": prefill_launches[name] + serve_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "main_max_abs_err": row["max_abs_err"], "main_mean_abs_exp": row["mean_abs_exp"],
            "main_rel_err": row["rel_err"], "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
