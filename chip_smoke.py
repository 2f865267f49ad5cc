#!/usr/bin/env python3
"""Proof that the PyTorch port runs on one NVIDIA H100, through its own kernels.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with one card

Phases, one JSON line each (every line carries the card's name and power
limit as ``nvidia-smi`` reports them):

1. ``device``: torch, CUDA, the card.
2. ``build``: the four CUDA kernels compiled with ``nvcc`` for ``sm_90a``
   from ``src/repro_torch/kernels/csrc/``, one ``nvcc`` each, in parallel;
   seconds and ``ptxas -v`` lines.
3. ``kernels.rmsnorm`` / ``kernels.flash_attention`` / ``kernels.moe_gemm`` /
   ``kernels.selective_scan``: each kernel against its plain PyTorch version
   on the card, at the main paths' shapes and at the shapes of
   ``tests/test_kernels.py`` (plus ragged ones); error and tolerance, kernel /
   plain / library ms (CUDA events), and the bound.
4. Per arch -- granite-3-2b, granite-moe-1b-a400m, falcon-mamba-7b, each at
   full width and depth, bf16, random weights from seed 0, freed before the
   next is made:
   ``prefill`` through ``make_prefill_step`` at 1x4096 tokens (plan tile ==
   launched tile, exact launch counts, median step time, tokens/s, memory);
   ``serve`` through ``ServingEngine`` (4 slots, 6 requests; exact launches
   per decode call); ``profile`` (``torch.profiler`` over one prefill and
   one decode step); for falcon-mamba also ``slot_reuse``, the second
   occupant of a slot against a fresh engine.
5. ``parity``: 2-layer f32 models at full width of each arch, card (kernels)
   against the port's CPU path (plain versions); for the MoE arch the
   routing must agree too.
6. ``kernels``: one summary entry per ported kernel.

Every launch counter is set to 0 just before a path is driven and read just
after it.  Any failure raises and exits non-zero.  The last line is the
contract's ``{"ok": true, "device": {...}}``.  Weights are random, drawn on
the card from a seed; nothing is downloaded.  Nothing of JAX is imported.
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
SM_COUNT = 132
SFU_EXP_PER_SM_CLOCK = 16  # exp2 results a clock per SM: NVIDIA throughput table, compute capability 9.0
SEQ = 4096
SEED = 0
KERNELS = ("rmsnorm", "flash_attention", "moe_gemm", "selective_scan")
ARCHS = ("granite-3-2b", "granite-moe-1b-a400m", "falcon-mamba-7b")

# launches of one 1x4096 prefill by arch: the one cross-check of
# _expected_counts, which gives every other expected count
EXPECTED_PREFILL = {
    "granite-3-2b": {"rmsnorm": 81, "flash_attention": 40, "moe_gemm": 0, "selective_scan": 0},
    "granite-moe-1b-a400m": {"rmsnorm": 49, "flash_attention": 24, "moe_gemm": 72, "selective_scan": 0},
    "falcon-mamba-7b": {"rmsnorm": 65, "flash_attention": 0, "moe_gemm": 0, "selective_scan": 64},
}

CARD = {"card": None, "power_limit": None}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, **CARD}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


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
            base = re.search(r"(flash_fwd_bf16|flash_fwd_f32|rmsnorm_kernel|moe_gemm_bf16|"
                             r"moe_gemm_f32|selective_scan_kernel)", name)
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
        ((SEQ, 1024), "bfloat16", "prefill granite-moe"),
        ((4, 1024), "bfloat16", "decode granite-moe"),
        ((SEQ, 4096), "bfloat16", "prefill falcon-mamba"),
        ((4, 4096), "bfloat16", "decode falcon-mamba"),
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
        if role.startswith(("prefill", "decode")):
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
        (1, 16, 8, SEQ, SEQ, 64, 256, 256, True, "bfloat16", "prefill granite-moe, plan (256,256)"),
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


def phase_kernels_moe(torch, F, mg):
    # (E, C, d, f, block_c, block_f, block_d, dtype, role): granite-moe's
    # prefill at 1x4096 (C = capacity(4096) = 1280) and decode at 4 slots
    # (C = 8), test_kernels.py's f32 tiles, and ragged tiles
    cases = [
        (32, 1280, 1024, 512, 128, 256, 256, "bfloat16", "prefill up/gate"),
        (32, 1280, 512, 1024, 128, 256, 256, "bfloat16", "prefill down"),
        (32, 8, 1024, 512, 128, 256, 256, "bfloat16", "decode up/gate, 4 slots"),
        (32, 8, 512, 1024, 128, 256, 256, "bfloat16", "decode down, 4 slots"),
        (4, 32, 64, 48, 16, 16, 32, "float32", "test"),
        (2, 16, 32, 32, 16, 32, 16, "float32", "test"),
        (8, 8, 16, 16, 8, 16, 16, "float32", "test"),
        (32, 128, 1024, 512, 128, 256, 256, "float32", "parity tile"),
        (5, 48, 320, 96, 16, 96, 64, "bfloat16", "ragged E, tile below the warp tile"),
        (3, 40, 256, 200, 40, 200, 128, "bfloat16", "ragged E, block_f = 200"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for E, C, d, f, bc, bf, bd, dtype, role in cases:
        dt = getattr(torch, dtype)
        x = torch.randn((E, C, d), generator=gen, device="cuda").to(dt)
        w = torch.randn((E, d, f), generator=gen, device="cuda").to(dt)
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=2e-4, rtol=2e-4)
        mg.LAUNCHES.reset()
        got = mg.moe_gemm(x, w, block_c=bc, block_f=bf, block_d=bd)
        torch.cuda.synchronize()
        want = (min(bc, C), min(bf, f), min(bd, d))
        if sorted(mg.LAUNCHES.tiles) != [want]:
            raise AssertionError(f"moe tile {sorted(mg.LAUNCHES.tiles)} launched for requested {(bc, bf, bd)}")
        stats = check_close(got, mg.moe_gemm_plain(x, w), f"moe_gemm {role} {dtype}", **tol)
        row = {"shape": [E, C, d, f], "dtype": dtype, "role": role,
               "tile_requested": [bc, bf, bd], "tile_launched": list(want), **stats}
        if role.startswith(("prefill", "decode")):
            nbytes = (x.numel() + w.numel() + E * C * f) * x.element_size()
            ops = 2 * E * C * d * f
            b_ms, b_by = bound(nbytes, ops, dtype)
            row.update(
                ms=cuda_ms(torch, lambda: mg.moe_gemm(x, w, block_c=bc, block_f=bf, block_d=bd)),
                plain_ms=cuda_ms(torch, lambda: mg.moe_gemm_plain(x, w)),
                library_ms=cuda_ms(torch, lambda: torch.bmm(x, w)),
                bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
            )
        rows.append(row)
    emit("kernels.moe_gemm", cases=rows)
    return rows


def _scan_inputs(torch, gen, B, L, Di, N, dtype):
    dt = getattr(torch, dtype)
    u = torch.randn((B, L, Di), generator=gen, device="cuda").to(dt)
    delta = torch.nn.functional.softplus(torch.randn((B, L, Di), generator=gen, device="cuda")).to(dt)
    A = -torch.exp(0.5 * torch.randn((Di, N), generator=gen, device="cuda"))
    Bm = torch.randn((B, L, N), generator=gen, device="cuda").to(dt)
    Cm = torch.randn((B, L, N), generator=gen, device="cuda").to(dt)
    D = torch.linspace(0.1, 1.0, Di, device="cuda")
    return u, delta, A, Bm, Cm, D


def phase_kernels_scan(torch, F, ss):
    # (B, L, Di, N, chunk, d_block, dtype, role): falcon-mamba's prefill at
    # 1x4096 at every scan_chunk option that launches, test_kernels.py's f32
    # shapes, and 32 chunks in f32 (a state not carried across chunks shows)
    from repro_torch.kernels import geometry

    launchable = geometry.launchable_scan_chunks(256, 16, "bfloat16")
    refused = {}
    for chunk in geometry.SCAN_CHUNK_OPTIONS:
        if chunk not in launchable:
            try:
                geometry.scan_launch(1, 1 << 20, 8192, 16, "bfloat16", chunk, 256)
            except ValueError as e:
                refused[chunk] = str(e)
            else:
                raise AssertionError(f"scan_chunk {chunk} launches but is not listed")
    cases = [(1, SEQ, 8192, 16, ch, 256, "bfloat16", f"prefill, plan chunk {ch}")
             for ch in sorted(launchable, reverse=True)]
    cases += [
        (2, 64, 32, 8, 16, 16, "float32", "test"),
        (1, 128, 64, 16, 64, 32, "float32", "test"),
        (2, 32, 16, 4, 32, 16, "float32", "test chunk == L"),
        (1, 96, 48, 8, 32, 48, "float32", "test d_block == Di"),
        (1, 2048, 512, 16, 64, 256, "float32", "32 chunks"),
        (2, 320, 8192, 16, 64, 256, "float32", "parity tile"),
    ]
    clock_hz = max_sm_clock_mhz() * 1e6
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    for B, L, Di, N, ch, db, dtype, role in cases:
        args = _scan_inputs(torch, gen, B, L, Di, N, dtype)
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-3)
        ss.LAUNCHES.reset()
        got = ss.selective_scan(*args, chunk=ch, d_block=db)
        torch.cuda.synchronize()
        want = (min(ch, L), min(db, Di))
        if sorted(ss.LAUNCHES.tiles) != [want]:
            raise AssertionError(f"scan tile {sorted(ss.LAUNCHES.tiles)} launched for requested {(ch, db)}")
        stats = check_close(got, ss.selective_scan_plain(*args), f"selective_scan {role} {dtype}", **tol)
        row = {"shape": [B, L, Di, N], "dtype": dtype, "role": role, "chunks": L // want[0],
               "tile_requested": [ch, db], "tile_launched": list(want), **stats}
        if role.startswith("prefill"):
            esz = args[0].element_size()
            nbytes = (3 * B * L * Di + 2 * B * L * N) * esz + (Di * N + Di) * 4
            ops = B * L * Di * (7 * N + 3)  # dt*A, exp, 2 FMAs and du*B a state; dt*u, D*u, + a channel
            exps = B * L * Di * N
            b_ms, b_by = bound(nbytes, ops, "float32")
            row.update(
                ms=cuda_ms(torch, lambda: ss.selective_scan(*args, chunk=ch, d_block=db), iters=10),
                plain_ms=cuda_ms(torch, lambda: ss.selective_scan_plain(*args), iters=2, warmup=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
                exps=exps, exp_bound_ms=exps / (SM_COUNT * SFU_EXP_PER_SM_CLOCK * clock_hz) * 1e3,
            )
        rows.append(row)
    emit("kernels.selective_scan", cases=rows, launchable_chunks=launchable, refused_chunks=refused)
    return rows


# ---------------------------------------------------------------------------
def _plan_tiles(cfg, tiles, tokens: int) -> dict:
    """The tiles a run of ``tokens`` tokens must launch, by kernel: the plan's,
    after the JAX kernels' own clamp (``min(block, dim)``)."""
    from repro_torch.models.moe import capacity

    plan = cfg.layer_plan()
    out = {}
    if any(s.mixer == "attn" for s in plan):
        out["flash_attention"] = {(min(tiles.attn_block_q, tokens), min(tiles.attn_block_kv, tokens))}
    if any(s.mixer == "mamba" for s in plan):
        out["selective_scan"] = {(min(tiles.scan_chunk, tokens), min(tiles.scan_d_block, cfg.d_inner))}
    if any(s.mlp == "moe" for s in plan):
        bc = tiles.moe_block_c
        C = capacity(tokens, cfg, block=bc if tokens >= bc else 8)
        out["moe_gemm"] = {
            (min(bc, C), min(tiles.moe_block_f, f), min(tiles.moe_block_d, d))
            for d, f in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model))
        }
    return out


def _launched_tiles(ops) -> dict:
    return {name: c.tiles for name, c in ops.COUNTERS.items() if c.tiles}


def _expected_counts(cfg) -> dict:
    """Launches of one forward of ``cfg``: a norm per block and per MLP and
    the final one, a kernel per attention or Mamba mixer, three grouped GEMMs
    per SwiGLU MoE MLP."""
    plan, n = cfg.layer_plan(), cfg.n_periods
    per = {"rmsnorm": 0, "flash_attention": 0, "moe_gemm": 0, "selective_scan": 0}
    for s in plan:
        per["rmsnorm"] += 1 + (s.mlp != "none")
        per["flash_attention"] += s.mixer == "attn"
        per["selective_scan"] += s.mixer == "mamba"
        per["moe_gemm"] += 3 * (s.mlp == "moe")
    counts = {k: v * n for k, v in per.items()}
    counts["rmsnorm"] += 1
    return counts


def _expected_decode_counts(cfg) -> dict:
    """Launches of one serving decode call: a forward's, less flash attention
    and the scan (decode runs the plain attention and scan steps)."""
    return {**_expected_counts(cfg), "flash_attention": 0, "selective_scan": 0}


def phase_prefill(torch, np, cfg, params, plans, ops, make_prefill_step, make_positions, tiles_from_plan):
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, SEQ))
    batch = {
        "inputs": torch.from_numpy(tokens).to("cuda"),
        "positions": make_positions(cfg, 1, SEQ, device="cuda"),
    }
    expected = EXPECTED_PREFILL[cfg.name]
    if expected != _expected_counts(cfg):
        raise AssertionError(f"{cfg.name}: {expected} != the layer plan's {_expected_counts(cfg)}")
    results, logits_by_plan, launches = [], [], None
    for plan in plans:
        step = make_prefill_step(cfg, None, plan, device="cuda")
        step(params, batch)  # warm-up: cuBLAS heuristics, allocator
        torch.cuda.synchronize()
        ops.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        logits = step(params, batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launched = _launched_tiles(ops)
        if counts != expected:
            raise AssertionError(f"{cfg.name} prefill launches {counts}, expected {expected}")
        want = _plan_tiles(cfg, tiles_from_plan(plan), SEQ)
        if launched != want:
            raise AssertionError(f"{cfg.name}: plan tiles {want} but launched {launched}")
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
        logits_by_plan.append(logits)
        results.append({
            "plan": {"attn_block": list(plan.attn_block), "scan_chunk": plan.scan_chunk},
            "launched_tiles": {k: sorted(map(list, v)) for k, v in launched.items()},
            "launches": counts, "median_step_ms": med * 1e3, "step_ms": [t * 1e3 for t in times],
            "tokens_per_s": SEQ / med, "peak_memory_gib": peak / 2**30,
        })
    # flash's softmax steps over 64 keys whatever the tile and a warp's rows
    # do not depend on block_q; the scan's chunk only sets how many steps are
    # staged at a time: so the plans' tiles give the same bits
    for other in logits_by_plan[1:]:
        if not torch.equal(logits_by_plan[0], other):
            raise AssertionError(f"{cfg.name}: the plan tiles' logits differ: max abs "
                                 f"{(logits_by_plan[0].float() - other.float()).abs().max().item()}")
    emit("prefill", arch=cfg.name, tokens=SEQ, runs=results,
         tiles_logits_identical=len(plans) > 1 or None)
    return launches, step, batch


class _CountedDecode:
    """The engine's ``_decode``, counting its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, mask):
        self.calls += 1
        return self.fn(mask)


def phase_serve(torch, np, cfg, params, ops, ServingEngine, tiles_from_plan):
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=128, device="cuda")
    counted = eng._decode = _CountedDecode(eng._decode)
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
    launched = _launched_tiles(ops)
    if len(done) != n_req or any(len(r.generated) != 16 for r in done):
        raise AssertionError(f"served {len(done)}/{n_req} requests")
    calls = counted.calls  # the timed steps below are not part of the run
    want = {k: v * calls for k, v in _expected_decode_counts(cfg).items()}
    if counts != want:
        raise AssertionError(f"{cfg.name} serving launches {counts} in {calls} decode "
                             f"calls, expected {want}")
    plan_tiles = _plan_tiles(cfg, tiles_from_plan(eng.plan), eng.slots)
    want_tiles = {k: v for k, v in plan_tiles.items() if counts[k]}
    if launched != want_tiles:
        raise AssertionError(f"{cfg.name}: serving plan tiles {want_tiles} but launched {launched}")
    mask = np.ones((eng.slots,), bool)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng._decode(mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    emit("serve", arch=cfg.name, slots=eng.slots, max_len=eng.max_len,
         completed=len(done), submitted=n_req, generated=sum(len(r.generated) for r in done),
         run_s=wall, decode_calls=calls, launches=counts,
         launches_per_decode_call={k: v // calls for k, v in counts.items()},
         launched_tiles={k: sorted(map(list, v)) for k, v in launched.items()},
         median_decode_step_ms=statistics.median(times) * 1e3,
         decode_step_ms=[t * 1e3 for t in times])
    return counts, eng


def phase_slot_reuse(np, cfg, params, ServingEngine):
    """The second occupant of a slot yields what a fresh engine yields: the
    conv/SSM state is zeroed when the slot is reassigned."""
    first, second = np.array([9, 8, 7], np.int32), np.array([1, 2], np.int32)
    eng = ServingEngine(cfg, params, batch_slots=1, max_len=32, device="cuda")
    eng.submit(first, max_new_tokens=4)
    (a,) = eng.run()
    eng.submit(second, max_new_tokens=4)
    (b,) = eng.run()
    fresh = ServingEngine(cfg, params, batch_slots=1, max_len=32, device="cuda")
    fresh.submit(second, max_new_tokens=4)
    (c,) = fresh.run()
    if b.generated != c.generated:
        raise AssertionError(f"{cfg.name}: a reused slot gave {b.generated}, a fresh engine {c.generated}")
    emit("slot_reuse", arch=cfg.name, first=a.generated, second=b.generated, fresh=c.generated)


def _kernel_group(name: str) -> str:
    if re.search(r"rmsnorm_kernel|flash_fwd|moe_gemm_(bf16|f32)|selective_scan_kernel", name):
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


def phase_profile(torch, np, cfg, step, params, batch, eng):
    mask = np.ones((eng.slots,), bool)
    emit("profile", arch=cfg.name, note="profiler on: wall times include its overhead",
         prefill=_profile_one(torch, lambda: step(params, batch)),
         decode=_profile_one(torch, lambda: eng._decode(mask)))


def phase_parity(torch, np, base_cfg, plan, ops, transformer, moe, make_positions, tiles_from_plan):
    """A 2-layer f32 model at full width, card (kernels) against the port's
    CPU path (plain versions); for MoE also the routing of every layer."""
    cfg = dataclasses.replace(base_cfg, n_layers=2, dtype="float32")
    tiles = tiles_from_plan(plan)
    params_cpu = transformer.init_params(cfg, SEED, device="cpu")
    params_gpu = _tree_to(params_cpu, "cuda")
    S = 320  # ragged against the default (256, 256) attention tile
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, (1, S)))
    routes = {"cuda": [], "cpu": []}
    real_route = moe.route

    def recording(device):
        def route(p, c, xt):
            out = real_route(p, c, xt)
            routes[device].append(out)
            return out
        return route

    try:
        moe.route = recording("cuda")
        ops.reset_counters()
        got = transformer.forward(params_gpu, cfg, tokens.cuda(),
                                  make_positions(cfg, 1, S, device="cuda"), tiles=tiles)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launched = _launched_tiles(ops)
        moe.route = recording("cpu")
        exp = transformer.forward(params_cpu, cfg, tokens, make_positions(cfg, 1, S, device="cpu"),
                                  tiles=tiles)
    finally:
        moe.route = real_route
    if counts != _expected_counts(cfg):
        raise AssertionError(f"{cfg.name} parity run launches {counts}, expected {_expected_counts(cfg)}")
    if launched != _plan_tiles(cfg, tiles, S):
        raise AssertionError(f"{cfg.name} parity: plan tiles {_plan_tiles(cfg, tiles, S)}, launched {launched}")
    stats = check_close(got.cpu(), exp, f"{cfg.name} 2-layer f32 logits, card vs CPU", atol=1e-3, rtol=1e-3)
    routing = None
    if cfg.is_moe:
        k, gaps = cfg.experts_per_token, []
        for (_, _, topi_gpu), (probs, _, topi_cpu) in zip(routes["cuda"], routes["cpu"], strict=True):
            if not torch.equal(topi_gpu.cpu(), topi_cpu):
                raise AssertionError(f"{cfg.name} parity: routing differs between card and CPU")
            top = probs.sort(dim=-1, descending=True).values
            gaps.append((top[:, k - 1] - top[:, k]).min().item())
        routing = {"layers": len(gaps), "tokens": S, "topi_equal": True,
                   "min_gap_kth_to_next_prob": min(gaps)}
    emit("parity", arch=cfg.name, n_layers=2, dtype="float32", tokens=S,
         tiles={k: sorted(map(list, v)) for k, v in launched.items()}, launches=counts, **stats,
         logits_abs_max=exp.abs().max().item(), routing=routing)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def run_path(torch, np, arch, plans, mods) -> tuple:
    """One arch's main path at full width: prefill, serving, profile (and for
    Mamba the slot-reuse check); its weights are freed when this returns."""
    cfg = mods.get_config(arch)
    t0 = time.perf_counter()
    params = mods.transformer.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, seconds=time.perf_counter() - t0,
         params=sum(t.numel() for t in _leaves(params)))
    prefill, step, batch = phase_prefill(torch, np, cfg, params, plans, mods.ops,
                                         mods.make_prefill_step, mods.make_positions,
                                         mods.tiles_from_plan)
    serve, eng = phase_serve(torch, np, cfg, params, mods.ops, mods.ServingEngine, mods.tiles_from_plan)
    phase_profile(torch, np, cfg, step, params, batch, eng)
    if cfg.is_ssm:
        phase_slot_reuse(np, cfg, params, mods.ServingEngine)
    return prefill, serve


# ---------------------------------------------------------------------------
SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:45"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:129"),
    "moe_gemm": ("src/repro_torch/kernels/csrc/moe_gemm.cu", "src/repro/kernels/moe_gemm.py:69"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:90"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import types

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.space import SchedulePlan
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import moe, transformer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.train_step import make_positions, make_prefill_step, tiles_from_plan

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain versions in true f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name, _, limit = smi.partition(",")
    CARD.update(card=name.strip(), power_limit=limit.strip())
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), name=torch.cuda.get_device_name(0),
         max_sm_clock_mhz=max_sm_clock_mhz())

    t0 = time.perf_counter()
    _build.build(KERNELS)
    emit("build", seconds=time.perf_counter() - t0, flags=" ".join(_build.NVCC_FLAGS),
         ptxas={n: ptxas_lines(_build.ptxas_report(n)) for n in KERNELS})

    rows = {
        "rmsnorm": phase_kernels_rmsnorm(torch, F, rn),
        "flash_attention": phase_kernels_flash(torch, F, fa),
        "moe_gemm": phase_kernels_moe(torch, F, mg),
        "selective_scan": phase_kernels_scan(torch, F, ss),
    }

    mods = types.SimpleNamespace(
        get_config=get_config, ops=ops, transformer=transformer, ServingEngine=ServingEngine,
        make_prefill_step=make_prefill_step, make_positions=make_positions,
        tiles_from_plan=tiles_from_plan,
    )
    plans = {
        "granite-3-2b": [SchedulePlan(), SchedulePlan(attn_block=(128, 128))],
        "granite-moe-1b-a400m": [SchedulePlan()],
        "falcon-mamba-7b": [SchedulePlan(), SchedulePlan(scan_chunk=64)],
    }
    launches = {n: 0 for n in KERNELS}
    for arch in ARCHS:
        for counts in run_path(torch, np, arch, plans[arch], mods):
            for n in KERNELS:
                launches[n] += counts[n]
        torch.cuda.empty_cache()
    for n in KERNELS:
        if launches[n] == 0:
            raise AssertionError(f"the main paths launched no {n} kernel")

    # f32 at d_block 256 the scan launches chunk 64 only (kernels/geometry.py)
    parity_plans = {"granite-3-2b": SchedulePlan(), "granite-moe-1b-a400m": SchedulePlan(),
                    "falcon-mamba-7b": SchedulePlan(scan_chunk=64)}
    for arch in ARCHS:
        phase_parity(torch, np, get_config(arch), parity_plans[arch], ops, transformer, moe,
                     make_positions, tiles_from_plan)

    summary = []
    for n in KERNELS:
        row = rows[n][0]  # the main path's first shape
        src, replaces = SOURCES[n]
        summary.append({
            "name": n, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[n],
            "max_abs_err": max(r["max_abs_err"] for r in rows[n]),
            "main_max_abs_err": row["max_abs_err"], "main_mean_abs_exp": row["mean_abs_exp"],
            "main_rel_err": row["rel_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"], "role": row["role"],
            "main_path_shapes": [
                {k: r[k] for k in ("shape", "dtype", "role", "max_abs_err", "rel_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for r in rows[n] if "ms" in r],
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
