#!/usr/bin/env python3
"""Proof that the PyTorch port runs on one NVIDIA H100, through its own kernels.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with one card

Phases, one JSON line each (every line carries the card's name and power
limit as ``nvidia-smi`` reports them):

1. ``device``: torch, CUDA, the card.
2. ``build``: the seven CUDA sources (and the shared ``csrc/sm90.cuh``)
   compiled with ``nvcc`` for ``sm_90a`` from ``src/repro_torch/kernels/csrc/``,
   one ``nvcc`` each, in parallel; seconds, ``ptxas -v`` lines, and the
   registers and spill bytes of the bf16 TMA -> wgmma kernels, which must
   not spill, and (``build_backward_160``) of the four flash backward
   instantiations at head_dim 160, bf16 and f32, none spilling.
3. ``kernels.rmsnorm`` / ``kernels.flash_attention`` / ``kernels.moe_gemm`` /
   ``kernels.selective_scan`` / ``kernels.quantize``: each kernel against its
   plain PyTorch version on the card, at the main paths' shapes and at the
   shapes of ``tests/test_kernels.py`` (plus ragged ones; for the int8 pair
   also zero rows and exact .5 ties, held bit for bit; for moe_gemm every
   operand layout; for flash also head_dim 160 and the widths of model
   coverage below); error and tolerance, kernel / plain / library ms (CUDA
   events; kernel, library, kernel in turns), ``vs_library``,
   ``achieved_tflops`` and the bound.  rmsnorm's rows and their
   ``F.rms_norm`` yardstick also carry ``device_ms``: the same calls
   captured 20 to a CUDA graph and timed by replaying it, so the host's
   time a launch drops out.
3b. ``kernels.decode_attention``: the decode step's attention over the KV
   cache against its plain version at the benchmark cells' shapes (16 rows,
   16/8 heads of 64, a 32k cache, each row's cur one of the cell's history
   lengths; jamba2-mini's 32/8 x 128 over a 256k cache, histories 128k-240k),
   deepseek-67b's 64/8 x 128 and stablelm-12b's 32/8 x 160, each
   with an int8 and a bf16 cache: events and device ms (graph replay), the
   bound, the plain version's ms; then head_dim x cache dtype x query
   heads a KV head edge cases, a strided view of some KV heads and a rank
   holding later positions; every instance's ptxas registers and spills.
4. ``grad``: the autograd Function of rmsnorm, flash attention, moe_gemm and
   the scan at the training shapes against autograd through the plain
   version, on the card (rmsnorm's backward is a kernel of its own,
   ``rmsnorm_backward``, also held alone at more widths and timed; flash's
   is ``flash_attention_backward`` from the forward's lse, at head_dims
   128, 32 and 16, Sq < Skv and ragged lengths, and at 160 (stablelm-12b's
   training shape, f32 ragged, Sq < Skv in both dtypes, MQA), timed alone and fwd+bwd,
   each in turns with SDPA's backward alone and fwd+bwd; the scan's is
   ``selective_scan_backward`` from the forward's carry-ins, at every
   scan_chunk option at falcon-mamba's width, in f32, with slow decay, one
   chunk and large dt, held to autograd through
   ``ref.selective_scan_chunked``; each backward kernel called twice on the
   same inputs must give bit-equal gradients).
5. Per serving arch -- granite-3-2b, granite-moe-1b-a400m, falcon-mamba-7b,
   each at full width and depth, bf16, random weights from seed 0, freed
   before the next is made:
   ``prefill`` through ``make_prefill_step`` at 1x4096 tokens (plan tile ==
   launched tile, exact launch counts, median step time, tokens/s, memory);
   ``serve`` through ``ServingEngine`` (4 slots, 6 requests; exact launches
   per decode call); ``profile`` (``torch.profiler`` over one prefill and
   one decode step); for falcon-mamba also ``slot_reuse``, the second
   occupant of a slot against a fresh engine.  Neither prefill nor serving
   may run the plain attention on the card.
5b. Model coverage: ``positions`` holds M-RoPE (qwen2-vl-72b's head_dim 128,
   ids whose three rows differ), stablelm-12b's partial rotary (head_dim
   160) and musicgen-large's sinusoid (d 2048) against float64 formulas
   written here; then nemotron-4-15b and stablelm-12b at full width and
   depth and deepseek-67b at full width and ``CUT_LAYERS`` depth through
   the same prefill (at every attention tile that launches at their
   head_dim: (128, 128) and (128, 256)), serving and profile;
   musicgen-large (full depth) and qwen2-vl-72b (``CUT_LAYERS``) take a
   stub frontend's embeddings, which the token engine does not: the same
   ``prefill`` of N(0, 1) embeddings at each plan, then ``decode``, 16
   ``decode_step``s of one embeddings row each (exact launches, no plain
   attention on the card), and ``profile``.  A cut arch must leave
   ``FREE_AFTER_PREFILL_GIB`` of the card's memory beside its prefill's
   peak.
6. ``train``: granite-moe-1b-a400m at full width through ``Trainer`` /
   ``make_train_step``, B=2 x S=4096 in two microbatches, under plan (a)
   remat full, int8 moments and int8 grad_comm (all five of its kernels)
   and plan (b) remat dots, f32 moments; then falcon-mamba-7b at full width
   and depth (64 layers), 1 x 4096, remat full, int8 moments (rmsnorm, the
   scan and both backward kernels, quantize); then stablelm-12b at full
   width and depth (40 layers), 1 x 4096, remat full, int8 moments, tile
   (128, 256) (flash and its backward at head_dim 160, quantize;
   layernorm, so no rmsnorm) (``TRAIN_PLANS``): per-step loss, grad norm,
   lr, ms, tokens/s, peak memory beside the dry run's peak of the same job
   (``launch/dryrun_impl.py``, counted on the host first), exact launches
   per step (the int8 moments' quantize and dequantize per optimizer
   chunk, ``optimizer.chunks``), every leaf moved by step 1, the plain
   attention never on the card, and a profile.
7. ``search``: step 1 of the quickstart (``launch/quickstart.py``) on the
   host: granite-moe-1b-a400m x train_4k tuned with ``mcts_1s`` for the
   H100 spec and the one card (``hw="h100"``, mesh ``card``); wall seconds,
   ``n_evals``, cache hits, the cost model's estimated terms (not a
   measurement), the spec beside the card's reported memory; the plan's
   attention tile must launch, and is held against the plain version at the
   arch's prefill widths.
8. ``quickstart``: steps 2 and 3 with the tuned plan (``microbatches``
   capped at the cut batch of 2): 3 train steps at full width, B=2 x
   S=4096 (exact launches a step for the plan, the plan's tile launched;
   step ms, tokens/s, peak memory), then 4 requests served with the trained
   weights (exact launches a decode call, every request complete, decode
   ms a step).
9. ``decode_int8``: granite-moe-1b-a400m at full width decoding 16 rows
   over a 32,768-long cache at ``cur`` = 32,767 (the measurement's decode
   cut) through ``make_serve_step``, with a bf16 and an int8 KV cache
   holding the same random K and V: exact launches a decode call (48
   quantizes with int8: K and V apart, 24 layers), the first layer's new
   rows within half an int8 step of the bf16 rows, the int8 logits against
   the bf16 ones in relative norm, decode ms of each in turns and each
   one's peak; then a 2-layer f32 int8 decode, card against the CPU path
   (logits, codes and scales).
9b. ``serve.graph``: the serve step's CUDA graph (``runtime/graphs.py``) at
   the benchmark cells' shapes, 16 slots over an int8 cache: granite-moe at
   full width over 32k positions, jamba2-mini's 16-layer stage over 256k.
   Replayed logits against the step run as it is (bit for bit, no row
   committed), host ms a step of each, device ms a step (events over
   replays), the launches a replay counts (equal to the step run as it is:
   a replay counts as the launches its capture recorded) and the device
   operations of one replay under ``torch.profiler``.
10. ``measure``: ``mcts_cost+real_1s`` tunes granite-moe-1b-a400m x
   train_4k for the H100 spec and mesh ``card``, its candidates timed on
   the card by a one-worker measurement fleet (``core/measure_fleet.py``)
   bound to the card target (``launch/measure.CardTarget``, full width,
   6 of 24 layers): tune seconds, measurements, programs run and cache
   hits, failures (none allowed), the plan, the Spearman rank correlation
   of the cost model's and the card's step times over the programs and
   their ratio; an int8 and a bf16 decode request through the same worker;
   one request through the subprocess CLI (``python -m
   repro_torch.launch.measure``); then the measured plan and the
   quickstart's ``mcts_1s`` plan trained at full depth in turns.
10b. ``jit_pricing``: ``AnalyticCostModel(pricing="jit", device="cuda")``,
   the float64 torch pricing program, at granite-moe-1b-a400m and
   falcon-mamba-7b x train_4k, granite-3-2b x decode_32k and stablelm-12b x
   prefill_32k (``hw="h100"``, mesh ``card``) and a ``tpu-v5e`` multi-pod
   cell, on random plan batches of 1 to 4096: elementwise within
   ``JIT_RTOL`` of the columnar kernel (atol 0), its tensors on the card,
   and the host ms a batch of each path.
10c. ``learned``: ``autotune(..., algo="mcts_1s", cost="learned")`` and
   ``cost="hybrid"`` of granite-moe-1b-a400m x train_4k, the MLP fitting and
   pricing on the card (learned-served misses above 0 under "learned"); the
   same on a 2-worker pinned pool, each worker pricing on the card in its
   own CUDA context (its context seconds and bytes; the merged version
   tags and counters must add up); one set of fitted params priced on the
   card and on the CPU (rtol 1e-5); and a reading: the MLP fitted on the
   ``measure`` phase's card records, every third held out, beside the
   analytic model's holdout Spearman.
10d. ``service``: the tuner daemon (``python -m
   repro_torch.launch.tune_serve serve``, ``--measure real`` on the card,
   the fleet reading the ``measure`` phase's records) on a socket under
   ``build/``: a cold ``mcts_1s`` request equal to the ``search`` phase's
   result, its repeat a store hit with no search, the same cell for
   ``tpu-v5e`` searched (never the h100 plan), ``mcts_cost+real_1s`` equal
   to the ``measure`` phase's plan, cost and measured time; then a restart
   on the same store, where that request is a store hit measuring nothing.
10e. ``mesh``: the H100 node's mesh (1 x 8) as 8 processes sharing the
   card over gloo (``launch/mesh.run_on_mesh(..., share_card=True)``),
   under the plans ``mcts_1s`` picks for it (``hw="h100"``, mesh
   ``single``), the batch their 8 microbatches of one row: granite-moe at
   2 layers in f32 (the plan's moe_mode ``dense``, then ``ep``; the CPU
   tests' bounds) and at 6 layers in bf16 (both modes), falcon-mamba at 2
   layers (``mixer_tp``, ``vocab_shard``, ``seq_shard``: the scan at 1,024
   channels); two train steps and a prefill each, every rank's launch
   counts (each kernel of the path non-zero), host-staged collectives,
   step ms and peak, the loss, the weights after step 1 and the prefill
   logits against one process on the card; then the int8 ring over the 8
   ranks against its plain version (bit for bit) and the exact sum.  No
   collective runs over NVLink and no time here is a node's.
10f. ``mesh_decode``: decode over the same mesh, 8 ranks on the card, 16
   rows over a cache of 8,192 positions built whole from the seed and
   sharded by ``ShardingRules.cache_pspecs``; granite-3-2b,
   granite-moe-1b-a400m, falcon-mamba-7b and stablelm-12b (head_dim 160)
   under the plans ``mcts_1s`` picks for ``decode_32k`` (KV heads over
   ``model``, ``tp2d``, EP, vocab-parallel logits, ``d_inner``-split
   state, int8 KV), and granite-3-2b with its cache split by position
   (bf16 and int8; per-row positions, one row left out of ``commit``), each
   at a depth cut; 8 teacher-forced steps from two positions before a
   position shard's boundary, every rank's logits at every step against
   one process on the card, launches (equal across ranks; rmsnorm,
   moe_gemm and quantize non-zero where the job runs them), host-staged
   collectives a step, step ms and peak GiB a rank (below one whole cache).
10g. ``work_check``: each bound column's bytes, operations and peak from
   ``kernels/work.py`` beside the formula this script wrote out before it
   (they must be equal).  ``dryrun``: the production-mesh dry run
   (``launch/dryrun_impl.py``): granite-moe-1b-a400m's measurement cut (6 of
   24 layers: train under both remat policies, prefill at 32,768 tokens,
   decode over an int8 cache) run on the card and dry on the meta device,
   launches by kernel and ``FlopCounterMode`` FLOPs exactly equal and the
   peak within 10 % of ``torch.cuda.max_memory_allocated`` (the measured
   step beside the dry run's roofline, recorded); then full-depth dry-run
   records on the H100's meshes (``single``, the 1 x 8 node, and
   ``multi``) of granite-moe and stablelm-12b training, deepseek-67b's
   training and prefill, and on the node qwen2-vl-72b's prefill and
   falcon-mamba-7b's training, one subprocess each with no card visible.
11. ``parity``: 2-layer f32 models at full width of each serving arch, and
   of stablelm-12b (head_dim 160) and qwen2-vl-72b (embeddings, M-RoPE ids
   whose rows differ), card (kernels) against the port's CPU path (plain
   versions); for the MoE arch the routing must agree too.
   ``train_parity``: the same for the loss,
   every gradient and one int8-moment optimizer step of granite-moe (512
   tokens) and falcon-mamba (320 tokens, scan_chunk 64), and the loss and
   every gradient of stablelm-12b (512 tokens, tile (128, 128): the flash
   backward at head_dim 160 in f32).
12. ``phase_seconds``: each phase's wall seconds; then ``kernels``: one
   summary entry per kernel (the six ported ones and the rmsnorm, flash and
   scan backward kernels).

Every launch counter is set to 0 just before a path is driven and read just
after it.  Any failure raises and exits non-zero.  The last line is the
contract's ``{"ok": true, "device": {...}}``.  Weights are random, drawn on
the card from a seed; nothing is downloaded.  Nothing of JAX is imported.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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
KERNELS = ("rmsnorm", "rmsnorm_backward", "flash_attention", "flash_attention_backward", "moe_gemm",
           "selective_scan", "selective_scan_backward", "quantize_int8", "dequantize_int8",
           "decode_attention")
LIBRARIES = ("rmsnorm", "flash_attention", "flash_attention_backward", "moe_gemm", "selective_scan",
             "quantize", "decode_attention")  # csrc/*.cu
ARCHS = ("granite-3-2b", "granite-moe-1b-a400m", "falcon-mamba-7b")
# model coverage: token archs through the engine, embeddings archs (a stub
# frontend's vectors in) through prefill and decode_step; the cut depths are
# full width at the most layers one card holds with >= 15 GiB left beside
# the prefill's peak (PERF.md section 4: at 40 and 32 layers the peaks were
# 58.27 and 59.98 GiB of 79.18, 1.29 and 1.63 GiB a layer)
COVERAGE_TOKEN_ARCHS = ("nemotron-4-15b", "stablelm-12b", "deepseek-67b")
COVERAGE_EMBED_ARCHS = ("musicgen-large", "qwen2-vl-72b")
CUT_LAYERS = {"deepseek-67b": 44, "qwen2-vl-72b": 34}
FREE_AFTER_PREFILL_GIB = 15
EMBED_DECODE_STEPS = 16
# bf16 decode of the embeddings archs against a forward of the same rows, in
# relative norm, per sqrt(layer): the two round apart by bf16 alone, each as
# far from an f32 forward of the same weights as the other, the gap growing
# as sqrt(n_layers) (qwen2-vl-72b 7.7e-3 sqrt(L) from 2 to 34 layers,
# musicgen-large 2.2e-3; scripts/torch_decode_noise.py); held at twice the
# larger.  The f32 2-layer check (phase_embed_decode_parity) holds 1e-3.
DECODE_VS_FORWARD_REL_PER_SQRT_LAYER = 1.5e-2
MROPE_GRID = 16  # qwen2-vl prefill: a 16 x 16 patch grid, then text

# launches of one 1x4096 prefill by arch: the one cross-check of
# _expected_counts, which gives every other expected count
NOT_IN_INFERENCE = {"quantize_int8": 0, "dequantize_int8": 0,  # inference quantizes nothing
                    "rmsnorm_backward": 0, "flash_attention_backward": 0,  # and takes no gradient
                    "selective_scan_backward": 0,
                    "decode_attention": 0}  # a forward attends with flash, never over a cache
EXPECTED_PREFILL = {
    "granite-3-2b": {"rmsnorm": 81, "flash_attention": 40, "moe_gemm": 0, "selective_scan": 0,
                     **NOT_IN_INFERENCE},
    "granite-moe-1b-a400m": {"rmsnorm": 49, "flash_attention": 24, "moe_gemm": 72,
                             "selective_scan": 0, **NOT_IN_INFERENCE},
    "falcon-mamba-7b": {"rmsnorm": 65, "flash_attention": 0, "moe_gemm": 0, "selective_scan": 64,
                        **NOT_IN_INFERENCE},
    # layernorm archs: the plain norm, as in the JAX package, so no rmsnorm
    "nemotron-4-15b": {"rmsnorm": 0, "flash_attention": 32, "moe_gemm": 0, "selective_scan": 0,
                       **NOT_IN_INFERENCE},
    "stablelm-12b": {"rmsnorm": 0, "flash_attention": 40, "moe_gemm": 0, "selective_scan": 0,
                     **NOT_IN_INFERENCE},
    "musicgen-large": {"rmsnorm": 0, "flash_attention": 48, "moe_gemm": 0, "selective_scan": 0,
                       **NOT_IN_INFERENCE},
    # at CUT_LAYERS
    "deepseek-67b": {"rmsnorm": 89, "flash_attention": 44, "moe_gemm": 0, "selective_scan": 0,
                     **NOT_IN_INFERENCE},
    "qwen2-vl-72b": {"rmsnorm": 69, "flash_attention": 34, "moe_gemm": 0, "selective_scan": 0,
                     **NOT_IN_INFERENCE},
}
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS = 3  # a plan's steps on the card: the first is timed apart (warm-up)
# falcon-mamba-7b training (the scan's backward) and stablelm-12b training
# (the flash backward at head_dim 160) at full width and depth: one 1x4096
# sequence, remat full, int8 moments; stablelm-12b at the 160 forward's
# faster tile (128, 256).  Both fit one card because the forward unbinds
# each stacked leaf once and the optimizer updates a leaf in chunks
# (PERF.md section 4); scripts/torch_train_fit.py runs the same plans
MAMBA_ARCH = "falcon-mamba-7b"
STABLELM_ARCH = "stablelm-12b"
TRAIN_PLANS = {
    MAMBA_ARCH: dict(remat="full", microbatches=1, opt_dtype="int8", scan_chunk=128),
    STABLELM_ARCH: dict(remat="full", microbatches=1, opt_dtype="int8", attn_block=(128, 256)),
}
# the decode cut of the card's measurement (core/measure.py CUT_ROWS): 16 rows
# over a decode_32k cache, every step at cur = S - 1, so it attends the whole cache
DECODE_ROWS, DECODE_LEN = 16, 32768
# int8 against bf16 decode logits of the same step, in relative norm over the
# (16, vocab) tensor: a bound for gross faults only.  Rounding a K or V row to
# int8 moves the attention output by a fraction of a percent, and over 24
# layers of random weights that flips top-8 expert choices, which moves whole
# rows; the exact checks of the int8 decode are the first layer's new rows,
# the launches and the 2-layer f32 parity
INT8_DECODE_REL = 0.5

CARD = {"card": None, "power_limit": None}
T_START = time.perf_counter()


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


def graph_ms(torch, fn, iters: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between CUDA events.  Replay
    issues the captured launches without running the host code around them,
    so the host's time a launch drops out (L2 warm, as in ``cuda_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: first-call set-up
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def timed(torch, kernel, library, ops: float, iters: int = 20, warmup: int = 3) -> dict:
    """The kernel, the library call, the kernel again, in turns (CUDA
    events): the kernel's mean of its two runs, its ratio to the library
    call (``vs_library``) and the operations it does a second
    (``achieved_tflops``).  ``library`` may be None."""
    k1 = cuda_ms(torch, kernel, iters, warmup)
    lib = cuda_ms(torch, library, iters, warmup) if library is not None else None
    k2 = cuda_ms(torch, kernel, iters, warmup)
    ms = (k1 + k2) / 2
    out = {"ms": ms, "ms_runs": [k1, k2], "library_ms": lib, "achieved_tflops": ops / ms / 1e9}
    if lib is not None:
        out["vs_library"] = ms / lib
    return out


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# each bound column's work from ``kernels/work.py`` beside the formula this
# script wrote out before it (emitted once, on the ``work_check`` line)
WORK_CHECKS = []


def work_bound(wk, nbytes: float, ops: float, dtype: str, what: str):
    """``(ms, "bytes" or "operations")`` of ``wk`` (a ``work.Work``) by
    ``work.bound_ms``; it must equal the written-out bytes, operations and
    peak of the same call."""
    from repro_torch.kernels import work

    got, literal = [wk.bytes, wk.flops, wk.ops_dtype], [nbytes, ops, dtype]
    WORK_CHECKS.append({"what": what, "work": got, "literal": literal})
    if got != literal:
        raise AssertionError(f"work.py's {what}: {got}, the written-out formula {literal}")
    return work.bound_ms(wk, HBM_BYTES_PER_S, PEAK_OPS)


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
    row_exp = exp.reshape(-1, exp.shape[-1]).norm(dim=-1)
    # a row whose expected value is exactly 0 (the gradient of a query row
    # that sees one key cancels exactly) has no relative error: it is held
    # element by element alone, and counted
    nonzero = row_exp > 0
    stats = {
        "max_abs_err": err.max().item(), "mean_abs_exp": exp.abs().mean().item(),
        "rel_err": (diff.norm() / exp.norm().clamp_min(1e-30)).item(),
        "worst_row_rel_err": (row_err[nonzero] / row_exp[nonzero]).max().item() if bool(nonzero.any())
        else 0.0,
        "zero_rows": int((~nonzero).sum().item()),
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
            base = re.search(r"(flash_fwd_bf16|flash_fwd_f32|flash_bwd_dkdv_bf16|flash_bwd_dq_bf16|"
                             r"flash_bwd_dkdv_f32|flash_bwd_dq_f32|rmsnorm_kernel|"
                             r"rmsnorm_backward_kernel|rmsnorm_dw_kernel|moe_gemm_bf16|moe_gemm_f32|"
                             r"selective_scan_kernel|selective_scan_carry_kernel|"
                             r"selective_scan_bwd_chunk_kernel|selective_scan_bwd_carry_kernel|"
                             r"selective_scan_bwd_kernel|selective_scan_bwd_reduce_kernel|"
                             r"dequantize_kernel|quantize_warp_kernel|quantize_cta_kernel|"
                             r"quantize_cluster_kernel|quantize_two_pass_kernel|"
                             r"decode_attention_split|decode_attention_combine)", name)
            label = base.group(1) if base else name
            # the template arguments: types, then integer and bool literals
            arg = r"f|a|13__nv_bfloat16|L[ib]\d+E"
            targs = re.match(rf"I((?:{arg})+)E", name[base.end():]) if base else None
            if targs:
                names = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16"}
                label += "<" + ",".join(names.get(t) or t[2:-1]
                                        for t in re.findall(arg, targs.group(1))) + ">"
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
    """The forward kernel against its plain version at every main-path width
    (granite-3-2b 2048, granite-moe 1024, falcon-mamba 4096, deepseek-67b and
    qwen2-vl-72b 8192; prefill and decode rows; jamba2-mini's decode rows of
    4096 and its Mamba inner norms of dt (256) and B, C (16)), ``test_kernels.py``'s
    shapes, ragged widths and the widest rows a group of warps holds.  Timed
    rows carry the kernel's and ``F.rms_norm``'s ``ms`` (CUDA events over
    back-to-back calls: the host's time a launch included where it is the
    slower side) and ``device_ms`` (CUDA-graph replay: the device alone)."""
    cases = [
        ((SEQ, 2048), "bfloat16", "prefill"),
        ((4, 2048), "bfloat16", "decode"),
        ((SEQ, 1024), "bfloat16", "prefill granite-moe"),
        ((4, 1024), "bfloat16", "decode granite-moe"),
        ((SEQ, 4096), "bfloat16", "prefill falcon-mamba"),
        ((4, 4096), "bfloat16", "decode falcon-mamba"),
        ((SEQ, 8192), "bfloat16", "prefill deepseek-67b / qwen2-vl-72b"),
        ((4, 8192), "bfloat16", "decode deepseek-67b"),
        ((16, 4096), "bfloat16", "decode jamba2-mini, 16 slots"),
        ((16, 256), "bfloat16", "decode jamba2-mini inner norm of dt"),
        ((16, 16), "bfloat16", "decode jamba2-mini inner norms of B and C"),
        ((3, 7, 64), "float32", "test"), ((16, 128), "float32", "test"), ((5, 96), "float32", "test"),
        ((3, 7, 64), "bfloat16", "test"), ((16, 128), "bfloat16", "test"), ((5, 96), "bfloat16", "test"),
        ((7, 2050), "bfloat16", "ragged width"), ((9, 1000), "float32", "ragged width"),
        ((64, 8192), "float32", "widest f32 row"), ((16, 16384), "bfloat16", "widest bf16 row"),
    ]
    from repro_torch.kernels import work

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
            b_ms, b_by = work_bound(work.rmsnorm(n, d, dtype),
                                    2 * n * x.element_size() + d * w.element_size(), 4 * n, "float32",
                                    f"rmsnorm {shape} {dtype}")
            row.update(
                **timed(torch, lambda: rn.rmsnorm(x, w), lambda: F.rms_norm(x, (d,), w, 1e-6), 4 * n),
                plain_ms=cuda_ms(torch, lambda: rn.rmsnorm_plain(x, w)),
                bound_ms=b_ms, bound_by=b_by,
                device_ms=graph_ms(torch, lambda: rn.rmsnorm(x, w)),
                library_device_ms=graph_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6)),
            )
            row["vs_library_device"] = row["device_ms"] / row["library_device_ms"]
            row["bound_share_device"] = b_ms / row["device_ms"]
        rows.append(row)
    emit("kernels.rmsnorm", cases=rows)
    return rows


def _visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    if not causal:
        return Sq * Skv
    q_off = Skv - Sq
    return sum(min(Skv, max(0, q_off + i + 1)) for i in range(Sq))


def _flash_case(torch, F, fa, gen, case) -> dict:
    """One flash case against the plain version (timed where it is a prefill shape)."""
    B, Hq, Hkv, Sq, Skv, D, bq, bkv, causal, dtype, role = case
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
        from repro_torch.kernels import work

        esz = q.element_size()
        nbytes = 2 * q.numel() * esz + 2 * k.numel() * esz
        ops = 4 * D * _visible_pairs(Sq, Skv, causal) * B * Hq
        b_ms, b_by = work_bound(work.flash_attention(B, Hq, Hkv, Sq, Skv, D, dtype, causal), nbytes, ops,
                                dtype, f"flash_attention {row['shape']} {dtype}")
        row.update(
            **timed(torch, lambda: fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv),
                    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True),
                    ops),
            plain_ms=cuda_ms(torch, lambda: fa.attention_plain(q, k, v, causal=causal), iters=5),
            bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
        )
    return row


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
        (2, 4, 2, 700, 1000, 64, 256, 256, True, "bfloat16", "Skv off the 64-key step, Sq < Skv"),
        (1, 4, 2, 200, 200, 32, 128, 128, True, "bfloat16", "head_dim 32"),
        # model coverage: stablelm-12b at head_dim 160 (every tile that
        # launches), nemotron-4-15b's 48/8 heads and deepseek-67b's /
        # qwen2-vl-72b's 64/8 at 128, musicgen-large's MHA at 64
        (1, 32, 8, SEQ, SEQ, 160, 128, 128, True, "bfloat16", "prefill stablelm-12b, plan (128,128)"),
        (1, 32, 8, SEQ, SEQ, 160, 128, 256, True, "bfloat16", "prefill stablelm-12b, plan (128,256)"),
        (1, 48, 8, SEQ, SEQ, 128, 128, 128, True, "bfloat16", "prefill nemotron-4-15b, plan (128,128)"),
        (1, 48, 8, SEQ, SEQ, 128, 128, 256, True, "bfloat16", "prefill nemotron-4-15b, plan (128,256)"),
        (1, 64, 8, SEQ, SEQ, 128, 128, 256, True, "bfloat16",
         "prefill deepseek-67b / qwen2-vl-72b, plan (128,256)"),
        (1, 32, 32, SEQ, SEQ, 64, 256, 256, True, "bfloat16", "prefill musicgen-large, plan (256,256)"),
        (1, 4, 2, 300, 300, 160, 128, 256, True, "bfloat16", "head_dim 160, ragged Sq=Skv=300"),
        (2, 4, 2, 100, 333, 160, 128, 128, True, "bfloat16", "head_dim 160, ragged, Sq < Skv"),
        (1, 4, 4, 96, 96, 160, 128, 128, False, "bfloat16", "head_dim 160, non-causal"),
        (1, 4, 2, 300, 300, 160, 128, 128, True, "float32", "head_dim 160, ragged Sq=Skv=300"),
        (2, 4, 1, 256, 256, 160, 64, 64, True, "float32", "test head_dim 160, MQA"),
        (2, 4, 2, 100, 333, 160, 128, 128, True, "float32", "head_dim 160, ragged, Sq < Skv"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = [_flash_case(torch, F, fa, gen, case) for case in cases]
    emit("kernels.flash_attention", cases=rows)
    return rows


def phase_kernels_moe(torch, F, mg):
    # (E, C, d, f, block_c, block_f, block_d, dtype, role[, x_t, w_t]):
    # granite-moe's prefill at 1x4096 (C = capacity(4096) = 1280) and decode
    # at 4 slots (C = 8), jamba2-mini's decode at 16 slots (16 experts, C = 8,
    # 4096 <-> 14336), test_kernels.py's f32 tiles, ragged tiles, and the
    # bf16 kernel's edges: one consumer warpgroup, a block_d off the 64-deep
    # ring stage, two column chunks, and every operand layout (x stored
    # (E,d,C), w stored (E,f,d)) at a ragged shape
    cases = [
        (32, 1280, 1024, 512, 128, 256, 256, "bfloat16", "prefill up/gate"),
        (32, 1280, 512, 1024, 128, 256, 256, "bfloat16", "prefill down"),
        (32, 8, 1024, 512, 128, 256, 256, "bfloat16", "decode up/gate, 4 slots"),
        (32, 8, 512, 1024, 128, 256, 256, "bfloat16", "decode down, 4 slots"),
        (16, 8, 4096, 14336, 128, 256, 256, "bfloat16", "decode jamba2-mini up/gate, 16 slots"),
        (16, 8, 14336, 4096, 128, 256, 256, "bfloat16", "decode jamba2-mini down, 16 slots"),
        (4, 32, 64, 48, 16, 16, 32, "float32", "test"),
        (2, 16, 32, 32, 16, 32, 16, "float32", "test"),
        (8, 8, 16, 16, 8, 16, 16, "float32", "test"),
        (32, 128, 1024, 512, 128, 256, 256, "float32", "parity tile"),
        (5, 48, 320, 96, 16, 96, 64, "bfloat16", "ragged E, tile below the warp tile"),
        (3, 40, 256, 200, 40, 200, 128, "bfloat16", "ragged E, block_f = 200"),
        (4, 128, 256, 256, 64, 256, 128, "bfloat16", "block_c = 64: one consumer warpgroup"),
        (3, 64, 320, 128, 64, 128, 40, "bfloat16", "block_d = 40, off the 64-deep stage"),
        (2, 64, 128, 512, 64, 512, 128, "bfloat16", "block_f = 512: two column chunks"),
        (3, 40, 64, 48, 40, 48, 64, "bfloat16", "ragged, dx layout: w stored (E,f,d)", False, True),
        (3, 40, 64, 48, 40, 48, 64, "bfloat16", "ragged, dw layout: x stored (E,d,C)", True, False),
        (3, 40, 64, 48, 40, 48, 64, "bfloat16", "ragged, both stored transposed", True, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for E, C, d, f, bc, bf, bd, dtype, role, *layout in cases:
        x_t, w_t = layout or (False, False)
        dt = getattr(torch, dtype)
        x = torch.randn((E, d, C) if x_t else (E, C, d), generator=gen, device="cuda").to(dt)
        w = torch.randn((E, f, d) if w_t else (E, d, f), generator=gen, device="cuda").to(dt)
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=2e-4, rtol=2e-4)
        mg.LAUNCHES.reset()
        got = mg.moe_gemm(x, w, block_c=bc, block_f=bf, block_d=bd, x_t=x_t, w_t=w_t)
        torch.cuda.synchronize()
        want = (min(bc, C), min(bf, f), min(bd, d))
        if sorted(mg.LAUNCHES.tiles) != [want]:
            raise AssertionError(f"moe tile {sorted(mg.LAUNCHES.tiles)} launched for requested {(bc, bf, bd)}")
        # the plain version on the transposed views: the product the layout means
        exp = mg.moe_gemm_plain(x.transpose(1, 2) if x_t else x, w.transpose(1, 2) if w_t else w)
        stats = check_close(got, exp, f"moe_gemm {role} {dtype}", **tol)
        row = {"shape": [E, C, d, f], "dtype": dtype, "role": role, "x_t": x_t, "w_t": w_t,
               "tile_requested": [bc, bf, bd], "tile_launched": list(want), **stats}
        if role.startswith(("prefill", "decode")):
            from repro_torch.kernels import work

            nbytes = (x.numel() + w.numel() + E * C * f) * x.element_size()
            ops = 2 * E * C * d * f
            b_ms, b_by = work_bound(work.moe_gemm(E, C, d, f, dtype), nbytes, ops, dtype,
                                    f"moe_gemm {[E, C, d, f]} {dtype}")
            row.update(
                **timed(torch, lambda: mg.moe_gemm(x, w, block_c=bc, block_f=bf, block_d=bd),
                        lambda: torch.bmm(x, w), ops),
                plain_ms=cuda_ms(torch, lambda: mg.moe_gemm_plain(x, w)),
                bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
            )
        rows.append(row)
    emit("kernels.moe_gemm", cases=rows)
    return rows


def _scan_inputs(torch, gen, B, L, Di, N, dtype, dt_shift=0.0):
    """``dt = softplus(N(0,1) + dt_shift)``: at 0 (dt ~ 0.7) a state forgets
    within a few steps; at -4 (dt ~ 0.02, as Mamba's initialisation gives)
    it carries across whole chunks, so the carry pass is exercised."""
    dt = getattr(torch, dtype)
    u = torch.randn((B, L, Di), generator=gen, device="cuda").to(dt)
    delta = torch.nn.functional.softplus(
        torch.randn((B, L, Di), generator=gen, device="cuda") + dt_shift).to(dt)
    A = -torch.exp(0.5 * torch.randn((Di, N), generator=gen, device="cuda"))
    Bm = torch.randn((B, L, N), generator=gen, device="cuda").to(dt)
    Cm = torch.randn((B, L, N), generator=gen, device="cuda").to(dt)
    D = torch.linspace(0.1, 1.0, Di, device="cuda")
    return u, delta, A, Bm, Cm, D


def phase_kernels_scan(torch, F, ss):
    # (B, L, Di, N, chunk, d_block, dtype, role): falcon-mamba's prefill at
    # 1x4096 at every scan_chunk option that launches, test_kernels.py's f32
    # shapes, one chunk (the output pass alone), two chunks at B = 2, 5 and
    # 32 chunks in f32, and slow decay (dt ~ 0.02), where a state lives
    # across chunks and a carry folded wrongly shows
    from repro_torch.kernels import geometry, work
    from repro_torch.kernels.ops import KernelTiles

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
    main = KernelTiles().scan_chunk  # the main path's chunk first: the summary line's row
    cases = [(1, SEQ, 8192, 16, ch, 256, "bfloat16", f"prefill, plan chunk {ch}")
             for ch in sorted(launchable, key=lambda c: (c != main, -c))]
    cases += [
        (2, 64, 32, 8, 16, 16, "float32", "test"),
        (1, 128, 64, 16, 64, 32, "float32", "test"),
        (2, 32, 16, 4, 32, 16, "float32", "test chunk == L"),
        (1, 96, 48, 8, 32, 48, "float32", "test d_block == Di"),
        (1, 2048, 512, 16, 64, 256, "float32", "32 chunks"),
        (2, 320, 8192, 16, 64, 256, "float32", "parity tile"),
        (1, 512, 8192, 16, 512, 256, "bfloat16", "chunk == L: the output pass alone"),
        (2, 256, 1024, 16, 128, 256, "bfloat16", "two chunks, B = 2"),
        (1, 1280, 512, 16, 256, 256, "float32", "chunk 256, 5 chunks"),
        (2, 192, 96, 8, 64, 32, "bfloat16", "N = 8, 3 chunks"),
        (1, SEQ, 8192, 16, 128, 256, "bfloat16", "prefill shape, slow decay"),
        (1, 2048, 512, 16, 64, 256, "float32", "32 chunks, slow decay"),
    ]
    clock_hz = max_sm_clock_mhz() * 1e6
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    for B, L, Di, N, ch, db, dtype, role in cases:
        args = _scan_inputs(torch, gen, B, L, Di, N, dtype, -4.0 if "slow decay" in role else 0.0)
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-3)
        ss.LAUNCHES.reset()
        got = ss.selective_scan(*args, chunk=ch, d_block=db)
        torch.cuda.synchronize()
        want = (min(ch, L), min(db, Di))
        if sorted(ss.LAUNCHES.tiles) != [want]:
            raise AssertionError(f"scan tile {sorted(ss.LAUNCHES.tiles)} launched for requested {(ch, db)}")
        stats = check_close(got, ss.selective_scan_plain(*args), f"selective_scan {role} {dtype}", **tol)
        launch = geometry.scan_launch(B, L, Di, N, dtype, ch, db)
        row = {"shape": [B, L, Di, N], "dtype": dtype, "role": role, "chunks": L // want[0],
               "kernel_launches_per_call": launch.kernels,
               "scratch_mib": launch.scratch_floats * 4 / 2**20,
               "tile_requested": [ch, db], "tile_launched": list(want), **stats}
        if role.startswith("prefill"):
            esz = args[0].element_size()
            nbytes = (3 * B * L * Di + 2 * B * L * N) * esz + (Di * N + Di) * 4
            ops = B * L * Di * (7 * N + 3)  # dt*A, exp, 2 FMAs and du*B a state; dt*u, D*u, + a channel
            exps = B * L * Di * N
            b_ms, b_by = work_bound(work.selective_scan(B, L, Di, N, dtype), nbytes, ops, "float32",
                                    f"selective_scan {[B, L, Di, N]} {dtype}")
            row.update(
                **timed(torch, lambda: ss.selective_scan(*args, chunk=ch, d_block=db), None, ops, iters=10),
                plain_ms=cuda_ms(torch, lambda: ss.selective_scan_plain(*args), iters=2, warmup=1),
                bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
                exps=exps, exp_bound_ms=exps / (SM_COUNT * SFU_EXP_PER_SM_CLOCK * clock_hz) * 1e3,
            )
        rows.append(row)
    emit("kernels.selective_scan", cases=rows, launchable_chunks=launchable, refused_chunks=refused)
    return rows


def _tie_rows(torch, gen, R: int, C: int):
    """Rows whose elements but the first are exact .5 ties: ``x = (k + 0.5) *
    scale`` with ``scale`` a power of two and the first element ``±127 *
    scale``, so that ``x / scale`` is exactly ``k + 0.5``."""
    scale = torch.exp2(torch.randint(-12, 4, (R, 1), generator=gen, device="cuda").float())
    k = torch.randint(-127, 127, (R, C), generator=gen, device="cuda").float()
    x = (k + 0.5) * scale
    sign = torch.where(torch.rand((R,), generator=gen, device="cuda") < 0.5, 1.0, -1.0)
    x[:, 0] = 127.0 * scale[:, 0] * sign
    return x


def moment_rows(mods, arch: str) -> dict:
    """The ``(rows, width)`` views the int8 moments of ``arch``'s train job
    (full depth) are quantized and read in, one optimizer chunk at a time
    (``optimizer.chunks``), from its parameter shapes -> the leaves that
    share each."""
    optim = mods.optim
    out = {}
    for path, shape in optim.leaves(mods.transformer.param_shapes(mods.get_config(arch))):
        if optim._quantizable(shape):
            for index in optim.chunks(shape):
                rows = (index.stop - index.start) * math.prod(shape[1:-1])
                out.setdefault((rows, shape[-1]), []).append(path.rsplit(".", 1)[-1])
    return {rc: sorted(set(names)) for rc, names in out.items()}


def quantize_moment_rows(mods) -> dict:
    """``phase_kernels_quantize``'s main-path moment rows: granite-moe's
    ``w_up``, tied embedding and router, largest first (the ``kernels``
    line's quantize row is the first), and every view of stablelm-12b's."""
    granite = {rc: names for rc, names in sorted(moment_rows(mods, TRAIN_ARCH).items(),
                                                  key=lambda kv: -math.prod(kv[0]))
               if {"w_up", "embed", "router"} & set(names)}
    return {TRAIN_ARCH: granite, STABLELM_ARCH: moment_rows(mods, STABLELM_ARCH)}


def _quantize_edge_cases() -> list:
    """Rows on both sides of each of ``geometry.quantize_launch``'s thresholds
    (narrow / warp at 16 units, a lane's 1 / 2 / 4 units, warp / cta at 4
    KiB, cta / cluster at ``QUANT_SLICE_BYTES``, cluster / two_pass at 8
    slices) in both dtypes, a cluster width its cluster size does not
    divide, a ragged cluster width and rows at an offset pointer (16-byte
    loads refused: the scalar path of cta and narrow)."""
    from repro_torch.kernels import geometry as geo

    out = []
    for dtype, esz in (("float32", 4), ("bfloat16", 2)):
        warp_top = 32 * geo.QUANT_LANE_BYTES // esz
        cta_top = geo.QUANT_SLICE_BYTES // (16 * esz) * 16
        cluster_top = geo.QUANT_MAX_CLUSTER * cta_top
        out += [(1024, 256, dtype, "normal", "edge narrow"), (1024, 272, dtype, "normal", "edge warp"),
                (1024, warp_top // 2, dtype, "normal", "edge warp"),
                (1024, warp_top // 2 + 16, dtype, "normal", "edge warp"),
                (512, warp_top, dtype, "normal", "edge warp"),
                (512, warp_top + 16, dtype, "normal", "edge cta"),
                (96, cta_top, dtype, "normal", "edge cta"),
                (96, cta_top + 16, dtype, "normal", "edge cluster"),
                (4, cluster_top, dtype, "normal", "edge cluster"),
                (4, cluster_top + 16, dtype, "normal", "edge two_pass")]
    out += [(1024, 512, "bfloat16", "normal", "edge warp"), (1024, 528, "bfloat16", "normal", "edge warp"),
            (64, 60016, "float32", "normal", "cluster of 3, not dividing 3,751 units"),
            (64, 60001, "float32", "normal", "cluster, ragged"),
            (64, 13824, "float32", "offset", "cta, offset pointer"),
            (33, 64, "bfloat16", "offset", "narrow, offset pointer")]
    return out


def phase_kernels_quantize(torch, qt, moment_views):
    """Both int8 kernels against their plain versions: q and the scale
    bit-equal, the f32 dequantize bit-equal and the bf16 one within one bf16
    step; at the optimizer's moment chunks of granite-moe (w_up, the tied
    embedding, the router) and of stablelm-12b's train job (every chunk's
    row view, ``quantize_moment_rows``), the int8 KV cache's decode write
    (``(B*Hkv, 64)`` bf16), test_kernels.py's shapes, a bf16 input, a ragged
    width, zero rows, exact .5 ties and each quantize regime's edges
    (``_quantize_edge_cases``).  Each row names the regime
    ``geometry.quantize_launch`` gave it; a timed row carries ``ms`` (CUDA
    events over back-to-back calls, the host's launch included) and
    ``device_ms`` (CUDA-graph replay: the device alone) for both kernels."""
    d = 1024
    stablelm_rows = moment_views[STABLELM_ARCH]
    # (R, C, dtype, kind, role)
    cases = [  # the cheap tie rows first: they catch a rounding fault by design
        (4096, d, "float32", "ties", "exact .5 ties"),
        (777, 1000, "float32", "ties", "exact .5 ties, ragged"),
        *[(R, C, "float32", "normal", f"train moment {', '.join(names)}")
          for (R, C), names in moment_views[TRAIN_ARCH].items()],
        (49155, d, "bfloat16", "normal", "bf16 gradient embed"),
        *[(R, C, "float32", "normal", f"train moment stablelm {', '.join(names)}")
          for (R, C), names in stablelm_rows.items()],
        # the widest rows stablelm's leaves have (the untied head), in bf16
        (*max(stablelm_rows, key=lambda rc: rc[1]), "bfloat16", "normal", "bf16 stablelm head rows"),
        # the int8 KV cache's write: one row per (slot, kv head), DECODE_ROWS x 8 heads of 64
        (DECODE_ROWS * 8, 64, "bfloat16", "normal", "decode KV rows"),
        (8, 128, "float32", "normal", "test"), (16, 64, "float32", "normal", "test"),
        (4, 256, "float32", "normal", "test"),
        (4099, 1000, "float32", "zero rows", "ragged width, zero rows"),
        (4099, 1000, "bfloat16", "normal", "ragged width"),
        *_quantize_edge_cases(),
    ]
    from repro_torch.kernels import work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = []
    for R, C, dtype, kind, role in cases:
        dt = getattr(torch, dtype)
        if kind == "ties":
            x = _tie_rows(torch, gen, R, C).to(dt)
        elif kind == "offset":  # one element past a 16-byte boundary
            x = (torch.randn((R * C + 1,), generator=gen, device="cuda") * 3.0).to(dt)[1:].view(R, C)
        else:
            x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0).to(dt)
        if kind == "zero rows":
            x[::3] = 0
        qt.QUANT_LAUNCHES.reset()
        qt.DEQUANT_LAUNCHES.reset()
        q, s = qt.quantize_int8(x)
        torch.cuda.synchronize()
        qp, sp = qt.quantize_int8_plain(x)
        q_diff = int((q != qp).sum().item())
        if q_diff or not torch.equal(s, sp):
            raise AssertionError(
                f"quantize_int8 {role} {dtype} {(R, C)}: {q_diff} codes differ from the plain "
                f"version (max |dq| {(q.int() - qp.int()).abs().max().item()}), scale equal: "
                f"{torch.equal(s, sp)}")
        g = qt.quantize_launch(R, C, dtype)
        row = {"shape": [R, C], "dtype": dtype, "role": role, "kind": kind, "regime": g.regime,
               "cluster": g.cluster, "threads": g.threads, "q_bit_equal": True, "scale_equal": True,
               "max_abs_err": 0.0}
        if role.startswith("edge") and not role.endswith(g.regime):
            raise AssertionError(f"quantize {(R, C)} {dtype}: regime {g.regime}, not the {role}")
        if kind == "ties":
            k = torch.floor(x[:, 1:].float() / s)
            even = bool((q[:, 1:].int() % 2 == 0).all())
            if not even or not bool(((q[:, 1:] == k) | (q[:, 1:] == k + 1)).all()):
                raise AssertionError(f"quantize_int8 {role}: a tie was not rounded half to even")
        for out_dt in (torch.float32, torch.bfloat16):
            got = qt.dequantize_int8(q, s, dtype=out_dt)
            torch.cuda.synchronize()
            exp = qt.dequantize_int8_plain(q, s, dtype=out_dt)
            err = (got.float() - exp.float()).abs()
            if out_dt == torch.float32 and not torch.equal(got, exp):
                raise AssertionError(f"dequantize_int8 {role} f32 differs: max {err.max().item()}")
            step = exp.float().abs() * 2.0 ** -7  # one bf16 step
            if out_dt == torch.bfloat16 and bool((err > step).any()):
                raise AssertionError(f"dequantize_int8 {role} bf16 beyond one step: max {err.max().item()}")
            row[f"dequant_{str(out_dt)[6:]}_max_abs_err"] = err.max().item()
            row[f"dequant_{str(out_dt)[6:]}_bit_equal"] = bool(torch.equal(got, exp))
        if (qt.QUANT_LAUNCHES.count, qt.DEQUANT_LAUNCHES.count) != (1, 2):
            raise AssertionError(f"quantize {role}: launches {qt.QUANT_LAUNCHES.count}, "
                                 f"{qt.DEQUANT_LAUNCHES.count}")
        if role.startswith(("train", "bf16", "decode")):
            esz = x.element_size()
            q_bytes = R * C * esz + R * C + 4 * R  # x read, q and the scales written
            dq_bytes = R * C + 4 * R + R * C * 4  # q and the scales read, f32 written
            qb, qby = work_bound(work.quantize_int8(R, C, dtype), q_bytes, 4 * R * C, "float32",
                                 f"quantize_int8 {[R, C]} {dtype}")
            db, dby = work_bound(work.dequantize_int8(R, C, "float32"), dq_bytes, R * C, "float32",
                                 f"dequantize_int8 {[R, C]} float32")
            dq = timed(torch, lambda: qt.dequantize_int8(q, s), lambda: torch.mul(q, s), R * C)
            row.update(
                **timed(torch, lambda: qt.quantize_int8(x), None, 4 * R * C),
                device_ms=graph_ms(torch, lambda: qt.quantize_int8(x)),
                plain_ms=cuda_ms(torch, lambda: qt.quantize_int8_plain(x)),
                bound_ms=qb, bound_by=qby, bytes=q_bytes,
                **{f"dequant_{k}": v for k, v in dq.items()},
                dequant_device_ms=graph_ms(torch, lambda: qt.dequantize_int8(q, s)),
                dequant_plain_ms=cuda_ms(torch, lambda: qt.dequantize_int8_plain(q, s)),
                dequant_bound_ms=db, dequant_bound_by=dby, dequant_bytes=dq_bytes,
            )
            row.update(bound_share_device=qb / row["device_ms"],
                       dequant_bound_share_device=db / row["dequant_device_ms"])
        rows.append(row)
        del x, q, s, qp, sp, got, exp, err, step
    emit("kernels.quantize", cases=rows,
         library="quantize: none (no one PyTorch call computes it); dequantize: torch.mul(q, scale)")
    return rows


# decode attention at the main paths' shapes: (rows, q heads, KV heads, cache
# positions, head_dim, cache dtype, role).  Every row's cur is one of the
# benchmark cell's 16 history lengths (16,384 to 28,672, evenly spaced)
DECODE_ATTENTION_CASES = [
    (16, 16, 8, 32768, 64, "int8", "granite-moe-1b-a400m decode-32k cell"),
    (16, 16, 8, 32768, 64, "bfloat16", "granite-moe-1b-a400m, bf16 cache"),
    (16, 64, 8, 32768, 128, "int8", "deepseek-67b 64/8 x 128"),
    (16, 64, 8, 32768, 128, "bfloat16", "deepseek-67b, bf16 cache"),
    (16, 32, 8, 32768, 160, "int8", "stablelm-12b 32/8 x 160"),
    (16, 32, 8, 32768, 160, "bfloat16", "stablelm-12b, bf16 cache"),
    (16, 32, 8, 262144, 128, "int8", "jamba2-mini decode-256k cell"),
    (16, 32, 8, 262144, 128, "bfloat16", "jamba2-mini, bf16 cache"),
]
# each case's rows sit at the history lengths of its benchmark cell: evenly
# spaced over this range (the granite cell's where the case names none)
DECODE_ATTENTION_HISTORIES = {262144: (131072, 245760)}
# kernel against plain: both sum in f32, in other orders (the kernel over
# chunks, lane groups and shuffles; the plain version in cuBLAS's gemv), so
# they agree to f32 rounding of sums over up to ~29k positions
DECODE_ATTENTION_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_ATTENTION_LSE_ATOL = 1e-4


def _decode_attention_inputs(torch, gen, B, Hq, Hk, L, hd, kv: str, cur, q_dtype="bfloat16"):
    """q N(0, 1), K and V N(0, 3^2) (the benchmark cell's history) in bf16,
    as int8 codes and row scales (the quantize kernel) for ``kv`` int8."""
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").to(getattr(torch, q_dtype))
    k, v = (torch.randn((B, Hk, L, hd), generator=gen, device="cuda", dtype=torch.bfloat16) * 3.0
            for _ in range(2))
    k_s = v_s = None
    if kv == "int8":
        from repro_torch.kernels import ops

        (k, k_s), (v, v_s) = (ops.quantize_int8(t.reshape(-1, hd)) for t in (k, v))
        k, v = k.view(B, Hk, L, hd), v.view(B, Hk, L, hd)
        k_s, v_s = k_s.view(B, Hk, L, 1), v_s.view(B, Hk, L, 1)
    elif kv == "float32":
        k, v = k.float(), v.float()
    return q, k, v, k_s, v_s, torch.as_tensor(cur, dtype=torch.long, device="cuda")


def _decode_attention_compare(torch, da, args, o, what: str) -> dict:
    """The kernel against the plain version on the same tensors."""
    q, hd = args[0], args[0].shape[-1]
    da.LAUNCHES.reset()
    att, lse = da.decode_attention(*args, o, hd ** -0.5)
    torch.cuda.synchronize()
    if da.LAUNCHES.count != 1:
        raise AssertionError(f"decode_attention {what}: {da.LAUNCHES.count} launches")
    att_p, lse_p = da.decode_attention_plain(*args, o, hd ** -0.5)
    # rows with a visible position; the others weigh 0 in a combine: the
    # kernel gives att 0 and lse -inf, the plain version its masked softmax
    seen = lse_p > -1e29
    stats = check_close(att[seen], att_p[seen], f"decode_attention {what} att", **DECODE_ATTENTION_TOL)
    if not bool((lse[~seen] == -float("inf")).all()) or not bool((att[~seen] == 0).all()):
        raise AssertionError(f"decode_attention {what}: a row with no visible position is not "
                             "att 0, lse -inf")
    lse_err = (lse[seen] - lse_p[seen]).abs().max().item() if bool(seen.any()) else 0.0
    if not lse_err <= DECODE_ATTENTION_LSE_ATOL:
        raise AssertionError(f"decode_attention {what}: lse {lse_err} from the plain version "
                             f"(limit {DECODE_ATTENTION_LSE_ATOL})")
    return {**stats, "lse_max_abs_err": lse_err, "rows_unseen": int((~seen).sum().item())}


def _decode_attention_edge_rows(torch, da, gen) -> list:
    """head_dim 64/128/160 x int8/bf16 x 1, 2, 6, 8 query heads a KV head,
    scalar and per-row cur (0 and L - 1 among them) over L = 1001 (no
    multiple of a chunk or a tile), an f32 cache, a strided view of two of
    four KV heads, and a rank holding positions [600, 1601) with rows that
    see none of them."""
    rows = []
    L = 1001
    for hd in (64, 128, 160):
        for kv in ("int8", "bfloat16"):
            for g in (1, 2, 6, 8):
                for cur in (L - 1, [0, L - 1, 517]):
                    args = _decode_attention_inputs(torch, gen, 3, 2 * g, 2, L, hd, kv, cur)
                    what = f"hd {hd} {kv} g {g} cur {cur}"
                    rows.append({"role": "edge", "shape": [3, 2 * g, 2, L, hd], "dtype": kv, "cur": cur,
                                 **_decode_attention_compare(torch, da, args, 0, what)})
    args = _decode_attention_inputs(torch, gen, 3, 4, 2, L, 128, "float32", [5, 999, 1000], "float32")
    rows.append({"role": "edge f32 cache", "shape": [3, 4, 2, L, 128], "dtype": "float32",
                 **_decode_attention_compare(torch, da, args, 0, "f32 cache")})
    for kv in ("int8", "bfloat16"):
        q, k, v, k_s, v_s, cur = _decode_attention_inputs(torch, gen, 3, 4, 4, L, 64, kv, [7, 400, 1000])
        view = (q, k[:, 1:3], v[:, 1:3], None if k_s is None else k_s[:, 1:3],
                None if v_s is None else v_s[:, 1:3], cur)
        rows.append({"role": "edge KV-group view", "shape": [3, 4, 2, L, 64], "dtype": kv,
                     **_decode_attention_compare(torch, da, view, 0, f"{kv} KV-group view")})
        args = _decode_attention_inputs(torch, gen, 3, 4, 2, L, 64, kv, [100, 600, 1700])
        rows.append({"role": "edge rank at 600", "shape": [3, 4, 2, L, 64], "dtype": kv,
                     **_decode_attention_compare(torch, da, args, 600, f"{kv} positions from 600")})
    return rows


def phase_kernels_decode_attention(torch, da):
    """The decode attention kernel against its plain version at the main
    paths' shapes (``DECODE_ATTENTION_CASES``, each row's cur one of the
    cell's history lengths) and the edge cases
    (``_decode_attention_edge_rows``); each main row's time (CUDA events,
    the host's launch included; and the device alone, CUDA-graph replay),
    its bound (``work.decode_attention``: the visible rows read once), the
    plain version's time, and the instance's geometry; the build's ptxas
    registers and spills of every instance."""
    from repro_torch.kernels import _build, work

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    n = 16
    rows = []
    for B, Hq, Hk, L, hd, kv, role in DECODE_ATTENTION_CASES:
        lo, hi = DECODE_ATTENTION_HISTORIES.get(L, (16384, 28672))
        lengths = [lo + round(i * (hi - lo) / (n - 1)) for i in range(n)]
        cur = [lengths[i % n] for i in range(B)]
        args = _decode_attention_inputs(torch, gen, B, Hq, Hk, L, hd, kv, cur)
        row = {"shape": [B, Hq, Hk, L, hd], "dtype": kv, "role": role, "cur": [min(cur), max(cur)],
               **_decode_attention_compare(torch, da, args, 0, role)}
        seen = sum(c + 1 for c in cur)
        row_bytes = 2 * hd * (1 if kv == "int8" else 2) + (8 if kv == "int8" else 0)
        nbytes = seen * Hk * row_bytes + B * Hq * hd * 2 + B * Hq * (hd + 1) * 4
        b_ms, b_by = work_bound(work.decode_attention(B, Hq, Hk, hd, seen, kv, "bfloat16"), nbytes,
                                4 * hd * Hq * seen, "float32", f"decode_attention {role}")
        call = lambda: da.decode_attention(*args, 0, hd ** -0.5)  # noqa: E731
        row.update(**timed(torch, call, None, 4 * hd * Hq * seen),
                   device_ms=graph_ms(torch, call),
                   plain_ms=cuda_ms(torch, lambda: da.decode_attention_plain(*args, 0, hd ** -0.5),
                                    iters=3, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, visible_positions=seen,
                   splits=list(da.splits(L, B * Hk)))
        row["bound_share_device"] = b_ms / row["device_ms"]
        row["bound_share_events"] = b_ms / row["ms"]
        rows.append(row)
        del args
    edge = _decode_attention_edge_rows(torch, da, gen)
    kernels = ptxas_lines(_build.ptxas_report("decode_attention"))
    spilled = [k["kernel"] for k in kernels if k.get("spill_stores", 0) + k.get("spill_loads", 0)]
    emit("kernels.decode_attention", cases=rows, edge_cases=edge,
         int8_vs_bf16_device_ms={r["role"]: r["device_ms"] for r in rows},
         ptxas={k["kernel"]: [k.get("registers"), k.get("spill_stores", 0) + k.get("spill_loads", 0)]
                for k in kernels},
         spilled=spilled, library="none (no one PyTorch call reads an int8 cache with row scales)")
    return rows + [{**r, "main_path": False} for r in edge]


def _grad_case(torch, what, fn_kernel, fn_plain, inputs, gen, tol, launches):
    """Forward and gradients of ``fn_kernel`` (the wrapper, through its
    autograd Function) against autograd through ``fn_plain``, on the card;
    ``launches``: each counter's launches in the forward and backward."""
    xs = [t.detach().clone().requires_grad_() for t in inputs]
    for counter in launches:
        counter.reset()
    y = fn_kernel(*xs)
    if not y.requires_grad or y.grad_fn is None:
        raise AssertionError(f"grad {what}: the kernel's output is detached from the graph")
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    got = torch.autograd.grad(y, xs, gy)
    torch.cuda.synchronize()
    for counter, n in launches.items():
        if counter.count != n:
            raise AssertionError(f"grad {what}: {counter.count} {counter.name} launches, expected {n}")
    ps = [t.detach().clone().requires_grad_() for t in inputs]
    yp = fn_plain(*ps)
    exp = torch.autograd.grad(yp, ps, gy)
    out = {"forward": check_close(y, yp, f"grad {what} forward", **tol)}
    for i, (g, e) in enumerate(zip(got, exp)):
        out[f"d{i}"] = check_close(g, e, f"grad {what} d{i}", **tol)
    return out, xs, gy


def _check_bit_equal(torch, what: str, call) -> None:
    """Two calls of a backward kernel on the same inputs must give bit-equal
    gradients (no atomics: every sum is taken in a fixed order)."""
    first = [g.clone() for g in call()]
    second = call()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: gradient {i} differs between two calls, max "
                                 f"{(a.float() - b.float()).abs().max().item()}")


# the flash backward's cases: the Function (the forward writing lse, the
# backward kernel) at granite-moe's training shape first (the summary line's
# row), then f32, head_dim 128, 32 and 16, Sq < Skv and ragged lengths, then
# head_dim 160 (stablelm-12b's training shape first); each against autograd
# through the plain version
FLASH_GRAD_CASES = [  # ((B, Hq, Hkv, Sq, Skv, D), dtype, role)
    ((1, 16, 8, SEQ, SEQ, 64), "bfloat16", "train granite-moe"),
    ((1, 4, 2, 512, 512, 64), "float32", "f32"),
    ((1, 8, 2, 1024, 1024, 128), "bfloat16", "head_dim 128"),
    ((1, 4, 2, 200, 200, 128), "float32", "head_dim 128"),
    ((2, 4, 2, 100, 333, 64), "bfloat16", "Sq < Skv, ragged"),
    ((2, 4, 2, 100, 333, 64), "float32", "Sq < Skv, ragged"),
    ((1, 4, 2, 300, 300, 32), "bfloat16", "ragged Sq = Skv = 300, head_dim 32"),
    ((1, 4, 4, 200, 200, 16), "bfloat16", "head_dim 16, one q-head a kv-head"),
    ((1, 32, 8, SEQ, SEQ, 160), "bfloat16", "train stablelm-12b, head_dim 160"),
    ((1, 4, 2, 300, 300, 160), "float32", "head_dim 160, ragged Sq = Skv = 300"),
    ((2, 4, 2, 100, 333, 160), "bfloat16", "head_dim 160, Sq < Skv, ragged"),
    ((2, 4, 2, 100, 333, 160), "float32", "head_dim 160, Sq < Skv, ragged"),
    ((2, 4, 1, 256, 256, 160), "bfloat16", "head_dim 160, MQA"),
]


def grad_flash(torch, F, fa, gen, cases=FLASH_GRAD_CASES) -> list:
    """Each flash backward case on the card: forward and gradients of the
    Function against autograd through the plain version, two calls of the
    backward bit-equal, the backward timed alone beside its bound, the
    plain version and SDPA's backward alone (``Sq == Skv``)."""
    f32 = dict(atol=1e-4, rtol=1e-4)
    rows = []

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(getattr(torch, dtype))

    for shape, dtype, role in cases:
        B, Hq, Hkv, Sq, Skv, D = shape
        tol = TOL_BF16 if dtype == "bfloat16" else f32
        # the forward's tile: the training plans' (256, 256); at head_dim 128
        # in bf16 and at 160 only block_q <= 128 launches (the backward's
        # tile is its own)
        bq = 128 if (D > 64 and dtype == "bfloat16") or D > 128 else 256
        q, k, v = randn((B, Hq, Sq, D), dtype), randn((B, Hkv, Skv, D), dtype), randn((B, Hkv, Skv, D), dtype)
        stats, xs, gy = _grad_case(
            torch, f"flash {role} {dtype}",
            lambda a, b, c: fa.flash_attention(a, b, c, causal=True, block_q=bq, block_kv=bq),
            lambda a, b, c: fa.attention_plain(a, b, c, causal=True), [q, k, v], gen, tol,
            {fa.LAUNCHES: 1, fa.BWD_LAUNCHES: 1})
        grads = [stats[f"d{i}"] for i in range(3)]
        bwd = fa.flash_backward_launch(B, Hq, Hkv, Sq, Skv, D, dtype)
        row = {"kernel": "flash_attention_backward", "shape": list(shape), "dtype": dtype, "role": role,
               "forward_tile": [bq, bq], "tiles": sorted(fa.BWD_LAUNCHES.tiles),
               "threads": [bwd.dkdv_threads, bwd.dq_threads], **stats,
               "max_abs_err": max(g["max_abs_err"] for g in grads),
               "rel_err": max(g["rel_err"] for g in grads), "mean_abs_exp": grads[0]["mean_abs_exp"],
               "launches": {"flash_attention": 1, "flash_attention_backward": 1},
               "main_path": role.startswith("train")}
        # the five products: 10 D operations a visible (query, key) pair a
        # q-head; q, k, v, lse and do read once, dq, dk, dv written once
        from repro_torch.kernels import work

        pairs = _visible_pairs(Sq, Skv, True) * B * Hq
        ops = 10 * D * pairs
        esz = q.element_size()
        nbytes = (3 * q.numel() + 4 * k.numel()) * esz + 4 * B * Hq * Sq
        b_ms, b_by = work_bound(work.flash_attention_backward(B, Hq, Hkv, Sq, Skv, D, dtype), nbytes, ops,
                                dtype, f"flash_attention_backward {list(shape)} {dtype}")
        _, lse = fa._launch(q, k, v, True, fa.flash_launch(B, Hq, Sq, Skv, D, dtype, bq, bq),
                            with_lse=True)
        _check_bit_equal(torch, f"flash_attention_backward {role} {dtype}",
                         lambda: fa._launch_backward(q, k, v, lse, gy, True, bwd))
        fwd_bwd = lambda: torch.autograd.grad(fa.flash_attention(  # noqa: E731
            *xs, causal=True, block_q=bq, block_kv=bq), xs, gy)
        # SDPA's is_causal aligns the diagonal top-left: the same function only when Sq == Skv
        sdpa, sdpa_bwd = None, None
        if Sq == Skv:
            sdpa = lambda: torch.autograd.grad(F.scaled_dot_product_attention(  # noqa: E731
                *xs, is_causal=True, enable_gqa=True), xs, gy)
            ys = F.scaled_dot_product_attention(*xs, is_causal=True, enable_gqa=True)
            sdpa_bwd = lambda: torch.autograd.grad(ys, xs, gy, retain_graph=True)  # noqa: E731
        both = timed(torch, fwd_bwd, sdpa, ops + 4 * D * pairs, iters=10)
        alone = timed(torch, lambda: fa._launch_backward(q, k, v, lse, gy, True, bwd), sdpa_bwd, ops,
                      iters=10)
        row.update(
            **{k_: v_ for k_, v_ in alone.items() if k_ not in ("library_ms", "vs_library")},
            bit_equal=True, library_ms=both["library_ms"],
            library_bwd_ms=alone["library_ms"], bwd_vs_library=alone.get("vs_library"),
            fwd_bwd_ms=both["ms"], fwd_bwd_ms_runs=both["ms_runs"],
            fwd_bwd_vs_library=both.get("vs_library"),
            plain_ms=cuda_ms(torch, lambda: fa.attention_backward_plain(q, k, v, lse, gy),
                             iters=3, warmup=1),
            plain_fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                fa.attention_plain(*xs, causal=True), xs, gy), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
            library="torch.autograd.grad through F.scaled_dot_product_attention: library_ms "
                    "fwd+bwd, in turns with the kernels' fwd+bwd; library_bwd_ms its backward alone "
                    "(retain_graph on one output), in turns with the backward kernel; never called "
                    "by the port")
        rows.append(row)
        del lse
        del q, k, v, xs, gy
    return rows


def phase_grad(torch, rn, fa, mg, ss):
    """Each kernel's autograd Function on the card at the training shapes
    against autograd through its plain version (the rmsnorm, flash and scan
    backward kernels also timed alone, beside their bounds)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import work

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    f32 = dict(atol=1e-4, rtol=1e-4)
    rows = []

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(getattr(torch, dtype))

    # rmsnorm: the Function (forward and backward kernels) at granite-moe's
    # training shape, then the backward kernel alone at every width it
    # takes a path for: one warp a row, groups of 2, 4 and 8 warps, ragged
    # widths, fewer rows than a block's row groups
    bwd_rows = []
    for dtype, tol in (("bfloat16", TOL_BF16), ("float32", f32)):
        x, w = randn((SEQ, 1024), dtype), (1 + randn((1024,), "float32", 0.1)).to(getattr(torch, dtype))
        stats, xs, gy = _grad_case(torch, f"rmsnorm {dtype}", lambda a, b: rn.rmsnorm(a, b),
                                   lambda a, b: rn.rmsnorm_plain(a, b), [x, w], gen, tol,
                                   {rn.LAUNCHES: 1, rn.BWD_LAUNCHES: 1})
        row = {"kernel": "rmsnorm", "shape": [SEQ, 1024], "dtype": dtype, **stats,
               "launches": {"rmsnorm": 1, "rmsnorm_backward": 1}}
        if dtype == "bfloat16":
            fwd_bwd = lambda: torch.autograd.grad(rn.rmsnorm(*xs), xs, gy)  # noqa: E731
            plain = lambda: torch.autograd.grad(rn.rmsnorm_plain(*xs), xs, gy)  # noqa: E731
            row.update(
                fwd_bwd_ms=cuda_ms(torch, fwd_bwd), plain_fwd_bwd_ms=cuda_ms(torch, plain),
                fwd_bwd_device_ms=graph_ms(torch, fwd_bwd),
                plain_fwd_bwd_device_ms=graph_ms(torch, plain),
                note="backward: the rmsnorm_backward kernel (dx and partial dw rows, then "
                     "their column sum); *_ms by CUDA events, *_device_ms by CUDA-graph replay")
        rows.append(row)
    bwd_cases = [
        ((SEQ, 1024), "bfloat16", "train granite-moe"), ((SEQ, 1024), "float32", "train, f32"),
        ((SEQ, 2048), "bfloat16", "granite-3-2b width"), ((SEQ, 4096), "bfloat16", "falcon-mamba width"),
        ((4, 1024), "bfloat16", "4 rows"), ((1024, 8192), "float32", "widest f32 row"),
        ((3, 7, 64), "float32", "test"), ((5, 96), "bfloat16", "test"),
        ((7, 2050), "bfloat16", "ragged width"), ((9, 1000), "float32", "ragged width"),
    ]
    for shape, dtype, role in bwd_cases:
        tol = TOL_BF16 if dtype == "bfloat16" else f32
        d = shape[-1]
        x, gy = randn(shape, dtype), randn(shape, dtype)
        w = (1 + randn((d,), "float32", 0.1)).to(getattr(torch, dtype))
        rn.BWD_LAUNCHES.reset()
        dx, dw = rn.rmsnorm_backward(x, w, gy)
        torch.cuda.synchronize()
        if rn.BWD_LAUNCHES.count != 1:
            raise AssertionError(f"rmsnorm_backward {shape}: {rn.BWD_LAUNCHES.count} launches")
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        edx, edw = torch.autograd.grad(rn.rmsnorm_plain(xp, wp), (xp, wp), gy)
        sx = check_close(dx, edx, f"rmsnorm_backward {shape} {dtype} dx", **tol)
        sw = check_close(dw, edw, f"rmsnorm_backward {shape} {dtype} dw", **tol)
        row = {"shape": list(shape), "dtype": dtype, "role": role, "dx": sx, "dw": sw,
               "max_abs_err": max(sx["max_abs_err"], sw["max_abs_err"]),
               "rel_err": max(sx["rel_err"], sw["rel_err"]), "mean_abs_exp": sx["mean_abs_exp"]}
        if role.startswith("train granite-moe"):
            n = x.numel()
            esz = x.element_size()
            # x and gy read, dx written, w read and dw written once; about 10
            # operations an element (two sums, dx, dw)
            b_ms, b_by = work_bound(work.rmsnorm_backward(n, d, dtype), 3 * n * esz + 2 * d * esz,
                                    10 * n, "float32", f"rmsnorm_backward {list(shape)} {dtype}")
            # the library's backward alone: autograd of F.rms_norm through a kept graph
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            yl = F.rms_norm(xl, (d,), wl, eps=1e-6)
            row.update(
                **timed(torch, lambda: rn.rmsnorm_backward(x, w, gy), None, 10 * n),
                device_ms=graph_ms(torch, lambda: rn.rmsnorm_backward(x, w, gy)),
                plain_ms=cuda_ms(torch, lambda: rn.rmsnorm_backward_plain(x, w, gy)),
                bound_ms=b_ms, bound_by=b_by,
                library="torch.autograd.grad of F.rms_norm's output (its backward alone, "
                        "the forward's graph kept)")
            # timed apart from the kernel's turns: between them the library's
            # autograd call moved this host-bound kernel's events time
            row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(yl, (xl, wl), gy,
                                                                            retain_graph=True))
            row["vs_library"] = row["ms"] / row["library_ms"]
            row["bound_share_device"] = b_ms / row["device_ms"]
        bwd_rows.append(row)
        del x, gy, w, dx, dw, xp, wp, edx, edw

    flash_rows = grad_flash(torch, F, fa, gen)

    # granite-moe's training shapes: 1x4096 tokens a microbatch, C = 1280
    for dtype, (E, C, d, f), tol in (("bfloat16", (32, 1280, 1024, 512), TOL_BF16),
                                     ("bfloat16", (32, 1280, 512, 1024), TOL_BF16),
                                     ("float32", (32, 256, 1024, 512), f32)):
        x, w = randn((E, C, d), dtype), randn((E, d, f), dtype)
        stats, xs, gy = _grad_case(
            torch, f"moe_gemm {dtype} {(E, C, d, f)}",
            lambda a, b: mg.moe_gemm(a, b, block_c=128, block_f=256, block_d=256),
            mg.moe_gemm_plain, [x, w], gen, tol, {mg.LAUNCHES: 3})
        tiles = sorted(mg.LAUNCHES.tiles)
        row = {"kernel": "moe_gemm", "shape": [E, C, d, f], "dtype": dtype, "tiles": tiles, **stats}
        if dtype == "bfloat16":
            # as the backward launches them: dx = dy . w^T with w as stored
            # (w_t), dw = x^T . dy with x as stored (x_t); the library call
            # on the same transposed views
            gyc = gy.contiguous()
            for name, a, b, a_t, b_t in (("dx", gyc, w, False, True), ("dw", x, gyc, True, False)):
                av, bv = (a.transpose(1, 2) if a_t else a), (b.transpose(1, 2) if b_t else b)
                e_, c_, k_ = av.shape
                f_ = bv.shape[2]
                nbytes = (a.numel() + b.numel() + e_ * c_ * f_) * a.element_size()
                ops = 2 * e_ * c_ * k_ * f_
                b_ms, b_by = work_bound(work.moe_gemm(e_, c_, k_, f_, dtype), nbytes, ops, dtype,
                                        f"moe_gemm backward {name} {[e_, c_, k_, f_]} {dtype}")
                row[name] = {
                    "shape": [e_, c_, k_, f_], "x_t": a_t, "w_t": b_t, "bound_ms": b_ms, "bound_by": b_by,
                    **timed(torch, lambda: mg.moe_gemm(a, b, block_c=128, block_f=256, block_d=256,
                                                       x_t=a_t, w_t=b_t),
                            lambda: torch.bmm(av, bv), ops),
                    "plain_ms": cuda_ms(torch, lambda: mg.moe_gemm_plain(a, b, x_t=a_t, w_t=b_t)),
                }
        rows.append(row)
        del x, w, xs, gy

    # the scan: the Function (the forward keeping its carry-ins, the backward
    # kernel) at falcon-mamba's training shape under each scan_chunk option
    # (chunk 128, the main path's, first: the summary line's row), then f32
    # with 5 chunks, slow decay (dt ~ 0.02: adjoints carried across chunks),
    # one chunk, and large dt (dt ~ 3: a_t underflows); each against
    # autograd through ref.selective_scan_chunked (the plain loop over L is
    # too slow at 4096 steps)
    scan_rows = []
    scan_cases = [  # ((B, L, Di, N), chunk, d_block, dtype, dt_shift, role)
        ((1, SEQ, 8192, 16), 128, 256, "bfloat16", 0.0, "train falcon-mamba, plan chunk 128"),
        ((1, SEQ, 8192, 16), 64, 256, "bfloat16", 0.0, "train falcon-mamba, plan chunk 64"),
        ((1, SEQ, 8192, 16), 256, 256, "bfloat16", 0.0, "train falcon-mamba, plan chunk 256"),
        ((2, 320, 512, 16), 64, 256, "float32", 0.0, "f32, 5 chunks"),
        ((1, 1024, 256, 16), 64, 128, "float32", -4.0, "f32, 16 chunks, slow decay"),
        ((1, 1024, 1024, 16), 128, 256, "bfloat16", -4.0, "8 chunks, slow decay"),
        ((2, 256, 1024, 16), 256, 256, "bfloat16", 0.0, "chunk == L"),
        ((1, 96, 48, 8), 32, 48, "float32", 3.0, "N = 8, d_block == Di, large dt"),
    ]
    plain_ms = {}  # the closed-form plain backward's time by shape (its work does not depend on the chunk)
    clock_hz = max_sm_clock_mhz() * 1e6
    for (B, L, Di, N), ch, db, dtype, shift, role in scan_cases:
        tol = TOL_BF16 if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-3)  # the forward's
        args = _scan_inputs(torch, gen, B, L, Di, N, dtype, shift)
        stats, xs, gy = _grad_case(
            torch, f"selective_scan {role} {dtype}",
            lambda *a: ss.selective_scan(*a, chunk=ch, d_block=db),
            lambda *a: kref.selective_scan_chunked(*a, min(ch, L)), list(args), gen, tol,
            {ss.LAUNCHES: 1, ss.BWD_LAUNCHES: 1})
        bwd = ss.scan_backward_launch(B, L, Di, N, dtype, ch, db)
        grads = [stats[f"d{i}"] for i in range(6)]
        row = {"kernel": "selective_scan_backward", "shape": [B, L, Di, N], "dtype": dtype,
               "role": role, "tile": [bwd.chunk, bwd.d_block], "chunks": L // bwd.chunk,
               "kernel_launches_per_call": bwd.kernels, "scratch_mib": bwd.scratch_floats * 4 / 2**20,
               **stats, "max_abs_err": max(g["max_abs_err"] for g in grads),
               "rel_err": max(g["rel_err"] for g in grads), "mean_abs_exp": grads[0]["mean_abs_exp"],
               "launches": {"selective_scan": 1, "selective_scan_backward": 1},
               "main_path": role.startswith("train")}
        esz = args[0].element_size()
        # u, dt, gy, Bm, Cm, A, D read once, du, ddt, dBm, dCm, dA, dD
        # written once; ~25 f32 operations a state update (the state
        # recomputed, the adjoint, five gradient terms)
        nbytes = (5 * B * L * Di + 4 * B * L * N) * esz + 2 * (Di * N + Di) * 4
        ops = 25 * B * L * Di * N
        b_ms, b_by = work_bound(work.selective_scan_backward(B, L, Di, N, dtype), nbytes, ops, "float32",
                                f"selective_scan_backward {[B, L, Di, N]} {dtype}")
        u, dt_, A, Bm, Cm, D = (x.detach() for x in xs)
        y, states = ss._launch(u, dt_, A, Bm, Cm, D, ss.scan_launch(B, L, Di, N, dtype, ch, db))
        _check_bit_equal(torch, f"selective_scan_backward {role} {dtype}",
                         lambda: ss._launch_backward(u, dt_, A, Bm, Cm, D, states, gy, bwd))
        row["bit_equal"] = True
        key = (B, L, Di, N, dtype)
        if key not in plain_ms:  # one timed call: seconds at falcon-mamba's width
            plain_ms[key] = cuda_ms(torch, lambda: ss.selective_scan_backward_plain(
                u, dt_, A, Bm, Cm, D, gy), iters=1, warmup=0)
        row.update(
            **timed(torch, lambda: ss._launch_backward(u, dt_, A, Bm, Cm, D, states, gy, bwd), None,
                    ops, iters=10),
            fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                ss.selective_scan(*xs, chunk=ch, d_block=db), xs, gy), iters=5),
            plain_ms=plain_ms[key], bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
            exp_bound_ms=3 * B * L * Di * N / (SM_COUNT * SFU_EXP_PER_SM_CLOCK * clock_hz) * 1e3,
            library="none: no PyTorch call computes the scan's gradient")
        scan_rows.append(row)
        del y, states
        del args, xs, gy
    emit("grad", cases=rows, rmsnorm_backward=bwd_rows, flash_attention_backward=flash_rows,
         selective_scan_backward=scan_rows,
         note="rmsnorm backward: its own kernel; flash backward: the flash_attention_backward "
              "kernel (dQ and Delta, then dK/dV, both TMA -> wgmma) from the forward's lse; scan "
              "backward: the selective_scan_backward kernel (chunk adjoints, reverse fold, output, "
              "reduce) from the forward's carry-ins; both backward kernels called twice, bit-equal; "
              "moe_gemm backward: 2 kernel launches on the saved operands as stored (dx reads w "
              "transposed, dw reads x transposed)")
    return {"rmsnorm_backward": bwd_rows, "flash_attention_backward": flash_rows,
            "selective_scan_backward": scan_rows}


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
    the final one (an rmsnorm arch's; layernorm is plain), a kernel per
    attention or Mamba mixer, three grouped GEMMs per SwiGLU MoE MLP."""
    plan, n = cfg.layer_plan(), cfg.n_periods
    rms = cfg.norm == "rmsnorm"
    per = {n: 0 for n in KERNELS}
    for s in plan:
        per["rmsnorm"] += rms * (1 + (s.mlp != "none"))
        per["flash_attention"] += s.mixer == "attn"
        per["selective_scan"] += s.mixer == "mamba"
        per["moe_gemm"] += 3 * (s.mlp == "moe")
    counts = {k: v * n for k, v in per.items()}
    counts["rmsnorm"] += rms
    return counts


def _expected_decode_counts(cfg) -> dict:
    """Launches of one serving decode call: a forward's, with a decode
    attention kernel where the forward runs flash (the scan step is plain)."""
    fwd = _expected_counts(cfg)
    return {**fwd, "flash_attention": 0, "selective_scan": 0, "decode_attention": fwd["flash_attention"]}


def phase_prefill(torch, np, cfg, params, plans, ops, make_prefill_step, make_positions, tiles_from_plan,
                  batch=None):
    """A 1x4096 prefill at each plan: 4096 token ids from the seed, or the
    caller's ``batch`` (an embeddings arch's)."""
    if batch is None:
        tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, SEQ))
        batch = {
            "inputs": torch.from_numpy(tokens).to("cuda"),
            "positions": make_positions(cfg, 1, SEQ, device="cuda"),
        }
    expected = EXPECTED_PREFILL[cfg.name]
    if expected != _expected_counts(cfg):
        raise AssertionError(f"{cfg.name}: {expected} != the layer plan's {_expected_counts(cfg)}")
    results, logits_by_plan, launches, first_scan = [], [], None, []
    real_scan = ops.selective_scan

    def recording_scan(*args, **kw):  # the first Mamba layer's scan: inputs and output
        y = real_scan(*args, **kw)
        if len(first_scan) < len(logits_by_plan) + 1:
            first_scan.append((args, y))
        return y

    for plan in plans:
        step = make_prefill_step(cfg, None, plan, device="cuda")
        ops.selective_scan = recording_scan
        try:
            step(params, batch)  # warm-up: cuBLAS heuristics, allocator
        finally:
            ops.selective_scan = real_scan
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
    # flash's softmax steps over 64 keys whatever the tile and a warpgroup's
    # 64 rows do not depend on block_q, so its plans' tiles give the same
    # bits.  The scan's chunk is its split of L (the carries are folded at
    # the chunk ends), so two chunks round apart in f32; a bf16 output that
    # rounds the other way then moves every later layer's input, and over 64
    # layers of random weights the logits drift apart (reported, not held).
    # What is held: the first Mamba layer sees the same inputs under both
    # plans and its scan outputs agree at the bf16 kernel tolerance.
    tiles_agree = None
    for i, other in enumerate(logits_by_plan[1:], 1):
        if cfg.is_ssm:
            (args0, y0), (args1, y1) = first_scan[0], first_scan[i]
            if not all(torch.equal(a, b) for a, b in zip(args0, args1)):
                raise AssertionError(f"{cfg.name}: the first scan's inputs differ between plans")
            diff = (other.float() - logits_by_plan[0].float())
            tiles_agree = {
                "first_scan_output": check_close(y1, y0, f"{cfg.name}: the plan tiles' first scan",
                                                 **TOL_BF16),
                "logits_max_abs_diff": diff.abs().max().item(),
                "logits_rel_diff": (diff.norm() / logits_by_plan[0].float().norm()).item(),
            }
        elif not torch.equal(logits_by_plan[0], other):
            raise AssertionError(f"{cfg.name}: the plan tiles' logits differ: max abs "
                                 f"{(logits_by_plan[0].float() - other.float()).abs().max().item()}")
        else:
            tiles_agree = "identical"
    del first_scan
    emit("prefill", arch=cfg.name, n_layers=cfg.n_layers, tokens=SEQ, runs=results,
         tiles_logits=tiles_agree, memory=_headroom(torch, cfg, params, results))
    return launches, step, batch


def _headroom(torch, cfg, params, runs) -> dict:
    """The card's memory left beside the prefill's peak; a depth-cut arch
    (``CUT_LAYERS``) must leave ``FREE_AFTER_PREFILL_GIB``, and the record
    says how many more of its layers that would have held."""
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    peak = max(r["peak_memory_gib"] for r in runs)
    layer = sum(t.numel() * t.element_size() for t in _leaves(params["blocks"])) / cfg.n_layers / 2**30
    free = total - peak
    out = {"card_memory_gib": total, "peak_gib": peak, "free_gib": free, "layer_gib": layer,
           "n_layers": cfg.n_layers, "layers_more_within_limit": int((free - FREE_AFTER_PREFILL_GIB) // layer)}
    if cfg.name in CUT_LAYERS and free < FREE_AFTER_PREFILL_GIB:
        raise AssertionError(f"{cfg.name} at {cfg.n_layers} layers leaves {free:.2f} GiB after "
                             f"prefill, under {FREE_AFTER_PREFILL_GIB}")
    return out


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
    if re.search(r"rmsnorm_\w*kernel|flash_fwd|flash_bwd|moe_gemm_(bf16|f32)|selective_scan_\w*kernel|"
                 r"quantize_kernel", name):
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
    # the profiler's raw events: ``prof.events()`` builds a Python object a
    # CPU op first, ~10 s for a train step's ~10^5 ops, for the same spans
    for e in prof.profiler.kineto_results.events():
        # a span's copy on the device's timeline (the program's spans) is no operation
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3  # us
        spans.append((start, end))
        ms = (end - start) / 1e3
        group = _kernel_group(e.name())
        by_group[group] += ms
        if group == "other":
            other[e.name()] = other.get(e.name(), 0.0) + ms
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
    params_cpu, params_gpu = _parity_params(transformer, cfg)
    S = 320  # ragged against the default (256, 256) attention tile
    rng = np.random.default_rng(SEED + 2)
    if cfg.input_kind == "tokens":
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)))
    else:  # a stub frontend's vectors
        tokens = torch.from_numpy(rng.standard_normal((1, S, cfg.d_model), dtype=np.float32))
    if cfg.pos_kind == "mrope":  # ids whose three rows differ
        pos_gpu, pos_cpu = mrope_ids(torch, 1, S), mrope_ids(torch, 1, S, device="cpu")
    else:
        pos_gpu, pos_cpu = make_positions(cfg, 1, S, device="cuda"), make_positions(cfg, 1, S, device="cpu")
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
        got = transformer.forward(params_gpu, cfg, tokens.cuda(), pos_gpu, tiles=tiles)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launched = _launched_tiles(ops)
        moe.route = recording("cpu")
        exp = transformer.forward(params_cpu, cfg, tokens, pos_cpu, tiles=tiles)
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


def _expected_train_counts(cfg, plan, params, moment_dtype: str, optim) -> dict:
    """Launches of one train step of ``cfg`` under ``plan``, per microbatch:
    the forward's; with remat (``dots`` or ``full``) the period's kernels
    again in the backward (the final norm lies outside the remat period);
    one rmsnorm, flash and scan backward for each norm, attention and Mamba
    mixer of the forward, and two more grouped GEMMs for each one's
    backward.  Then two quantizes and two dequantizes per optimizer chunk of
    a quantizable leaf for int8 moments (``_moment_chunks``), and one each
    per quantizable leaf for int8 ``grad_comm``."""
    fwd = _expected_counts(cfg)
    rerun = int(plan.remat != "none")
    counts = {
        # a layernorm arch (stablelm-12b) launches no rmsnorm at all
        "rmsnorm": fwd["rmsnorm"] + rerun * max(fwd["rmsnorm"] - 1, 0),
        "rmsnorm_backward": fwd["rmsnorm"],
        "flash_attention": fwd["flash_attention"] * (1 + rerun),
        "flash_attention_backward": fwd["flash_attention"],
        "moe_gemm": fwd["moe_gemm"] * (1 + rerun) + 2 * fwd["moe_gemm"],
        "selective_scan": fwd["selective_scan"] * (1 + rerun),
        "selective_scan_backward": fwd["selective_scan"],
    }
    counts = {k: v * plan.microbatches for k, v in counts.items()}
    counts["decode_attention"] = 0
    n_quant = sum(optim._quantizable(p) for _, p in optim.leaves(params))
    counts["quantize_int8"] = counts["dequantize_int8"] = (
        2 * (moment_dtype == "int8") * _moment_chunks(optim, params) + (plan.grad_comm == "int8") * n_quant)
    return counts


def _moment_chunks(optim, params) -> int:
    """The optimizer chunks of ``params``' quantizable leaves: an int8
    moment is dequantized and requantized once each per chunk."""
    return sum(len(optim.chunks(p.shape)) for _, p in optim.leaves(params) if optim._quantizable(p))


@contextlib.contextmanager
def plain_attention_watch():
    """Records the device of every call of the plain attention
    (``ref.attention``, under both names the port holds it by): a train step
    on the card must make none on a CUDA tensor."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    real, seen = ref.attention, []

    def recording(q, *args, **kw):
        seen.append(q.device.type)
        return real(q, *args, **kw)

    ref.attention = fa.attention_plain = recording
    try:
        yield seen
    finally:
        ref.attention = fa.attention_plain = real


def _check_no_plain_attention(seen: list, what: str) -> int:
    on_card = seen.count("cuda")
    if on_card:
        raise AssertionError(f"{what}: the plain attention ran {on_card} times on the card")
    return on_card


def _bf16_frozen(torch, p, lr: float, weight_decay: float) -> bool:
    """True when one AdamW step cannot move any element of the bf16 leaf
    ``p``: the step moves an element by at most ``lr * (1 + wd * |p|)`` (the
    first step's ``m^/(sqrt(v^) + eps)`` is at most 1 in size), which is
    below 2^(e-9) for an element in [2^e, 2^(e+1)) -- half the bf16 spacing
    below a power of two, the nearest a value can come to rounding away.
    The ones-initialised norm weights are such leaves at lr 1e-3."""
    if p.dtype != torch.bfloat16:
        return False
    a = p.float().abs()
    half_step = torch.exp2(torch.floor(torch.log2(a)) - 9)  # 0 where p == 0
    return bool((lr * (1 + weight_decay * a) < half_step).all())


def dry_train_peaks(jobs: dict) -> dict:
    """Each train job's (``name -> (arch, batch, plan fields, n_layers or
    None)``) peak bytes as the dry run counts them on the host
    (``launch/dryrun_impl.py``: one device's step on the meta device)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.space import ONE_CARD, SchedulePlan
    from repro_torch.launch import dryrun_impl

    out = {}
    for name, (arch, batch, plan, n_layers) in jobs.items():
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        rec = dryrun_impl.dry_run(cfg, InputShape("train_chip", SEQ, batch, "train"),
                                  SchedulePlan.from_dict(plan), ONE_CARD, hw="h100", local=True)
        out[name] = rec["memory"]["peak_bytes"]
    return out


class TrainDryRuns:
    """``dry_train_peaks`` of the train jobs in one host process that sees no
    card, started early so that its CPU seconds overlap the card's phases;
    ``peak(name)`` waits for it."""

    def __init__(self, jobs: dict):
        env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                "print(json.dumps(chip_smoke.dry_train_peaks(json.loads(sys.argv[2]))))")
        self.proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), json.dumps(jobs)],
                                     cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.peaks = None

    def peak(self, name: str) -> int:
        if self.peaks is None:
            out, err = self.proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            if self.proc.returncode != 0:
                raise AssertionError(f"train dry runs: exit {self.proc.returncode}\n{err[-3000:]}")
            self.peaks = json.loads(out.splitlines()[-1])
        return self.peaks[name]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _first_chunks(torch, optim, params) -> dict:
    """Each leaf's first optimizer chunk, copied to the host."""
    return {k: v[optim.chunks(v.shape)[0]].detach().to("cpu", copy=True) for k, v in optim.leaves(params)}


def _unchanged_leaves(torch, mods, tr, params, heads: dict, lr: float, weight_decay: float):
    """``(unchanged, frozen)``: the leaves of the trained ``params`` equal to
    their initial values, and those of them no step could move
    (``_bf16_frozen``).  The initial weights are drawn again on the card
    as the trainer ``tr`` drew them (its config and seed: the same
    generator stream, leaf after leaf), and each leaf's first chunk is held
    to ``heads``, the first draw's, taken before step 1.  Each leaf is then
    compared whole, one optimizer chunk at a time, on the card: no host
    copy of the weights (~11 s for stablelm-12b's 22.6 GiB)."""
    optim = mods.optim
    initial = dict(optim.leaves(mods.transformer.init_params(tr.cfg, tr.tc.seed, device="cuda")))
    unchanged, frozen = [], []
    for k, v in optim.leaves(params):
        index = optim.chunks(v.shape)
        if not torch.equal(initial[k][index[0]], heads[k].to(v.device)):
            raise AssertionError(f"the initial weights drawn again differ from the first draw in {k}")
        if all(torch.equal(v[i], initial[k][i]) for i in index):
            unchanged.append(k)
            if _bf16_frozen(torch, initial[k], lr, weight_decay):
                frozen.append(k)
        del initial[k]
    return unchanged, frozen


def phase_train(torch, name, plan, mods, arch=TRAIN_ARCH, batch=2, n_layers=None,
                dry_peak=None) -> dict:
    """``arch`` at full width (``n_layers``: a depth cut) through ``Trainer``
    / ``make_train_step``: ``batch`` x 4096 tokens; exact launches per step,
    the plain attention never on the card, finite loss and gradient norm,
    every leaf moved by step 1, peak memory beside ``dry_peak`` (the dry
    run's peak bytes of the same job), a profile."""
    optim = mods.optim
    cfg = mods.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, moment_dtype=plan.opt_dtype)
    shape = mods.InputShape("train_chip", SEQ, batch, "train")
    tc = mods.TrainerConfig(total_steps=1, ckpt_every=10**9, log_every=1, ckpt_async=False,
                            ckpt_dir=str(ROOT / "build" / "chip_smoke_ckpt"), seed=SEED)
    marks = [time.perf_counter()]  # the seconds of each part, on the train line
    tr = mods.Trainer(cfg, shape, plan, tc, opt_cfg=oc, device="cuda")
    params, opt_state, _ = tr.init_state()
    n_params = sum(p.numel() for _, p in optim.leaves(params))
    expected = _expected_train_counts(cfg, plan, params, oc.moment_dtype, optim)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    heads = _first_chunks(torch, optim, params)
    marks.append(time.perf_counter())
    mods.ops.reset_counters()
    with plain_attention_watch() as seen:
        params, opt_state, step = tr.run(params, opt_state, 0)
    first = mods.ops.launch_counts()
    if first != expected:
        raise AssertionError(f"train {name}: step 1 launches {first}, expected {expected}")
    lr1 = tr.metrics_log[0]["lr"]
    marks.append(time.perf_counter())
    unchanged, frozen = _unchanged_leaves(torch, mods, tr, params, heads, lr1, oc.weight_decay)
    if set(unchanged) - set(frozen):
        raise AssertionError(f"train {name}: leaves unchanged after step 1: "
                             f"{sorted(set(unchanged) - set(frozen))}")
    del heads
    gc.collect()  # what earlier phases left in reference cycles is not this run's memory
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    torch.cuda.reset_peak_memory_stats()  # peak of steps 2..: weights, state, one step's work
    tr.tc.total_steps = TRAIN_STEPS
    mods.ops.reset_counters()
    with plain_attention_watch() as seen_rest:
        params, opt_state, step = tr.run(params, opt_state, step)
    rest = mods.ops.launch_counts()
    marks.append(time.perf_counter())
    want = {k: v * (TRAIN_STEPS - 1) for k, v in expected.items()}
    if rest != want:
        raise AssertionError(f"train {name}: steps 2-{TRAIN_STEPS} launches {rest}, expected {want}")
    plain_on_card = _check_no_plain_attention(seen + seen_rest, f"train {name}")
    peak = torch.cuda.max_memory_allocated()
    log = tr.metrics_log
    if len(log) != TRAIN_STEPS or not all(
            torch.isfinite(torch.tensor([r["loss"], r["grad_norm"]])).all() for r in log):
        raise AssertionError(f"train {name}: non-finite loss or grad_norm: {log}")
    steady = [r["step_time_s"] for r in log[1:]]
    med = statistics.median(steady)
    tokens = batch * SEQ
    step_batch = tr.batch_at(step)
    prof = _profile_one(torch, lambda: tr.step_fn(params, opt_state, step_batch))
    marks.append(time.perf_counter())
    seconds = dict(zip(("init", "first_chunks", "step1", "moved_check", "steps_rest", "profile"),
                       (b - a for a, b in zip(marks, marks[1:]))))
    emit("train", arch=cfg.name, plan=name, n_layers=cfg.n_layers, params=n_params, plan_fields={
             k: getattr(plan, k) for k in ("remat", "microbatches", "opt_dtype", "grad_comm",
                                           "scan_chunk", "attn_block")},
         batch=batch, seq=SEQ, microbatch_tokens=tokens // plan.microbatches,
         steps=[{"step": r["step"], "loss": r["loss"], "grad_norm": r["grad_norm"], "lr": r["lr"],
                 "step_ms": r["step_time_s"] * 1e3,
                 "tokens_per_s": tokens / r["step_time_s"]} for r in log],
         median_step_ms=med * 1e3, tokens_per_s=tokens / med, peak_memory_gib=peak / 2**30,
         dry_peak_gib=None if dry_peak is None else dry_peak / 2**30,
         peak_over_dry=None if dry_peak is None else peak / dry_peak,
         card_memory_gib=torch.cuda.get_device_properties(0).total_memory / 2**30,
         launches_per_step=expected, launches_step1=first, launches_rest=rest,
         plain_attention_calls_on_card=plain_on_card, plain_attention_calls=len(seen + seen_rest),
         leaves_frozen_by_bf16_rounding=frozen, profile=prof, seconds=seconds)
    del tr, params, opt_state, step_batch
    gc.collect()
    torch.cuda.empty_cache()
    return {k: first[k] + rest[k] for k in first}


def phase_search(torch, F, fa, mods):
    """Step 1 of the quickstart on the host: tune granite-moe-1b-a400m x
    train_4k with mcts_1s for the H100 spec and the one card; the plan's
    attention tile must launch, and is held against the plain version at the
    arch's prefill widths."""
    qs = mods.quickstart
    t0 = time.perf_counter()
    res, terms = qs.tune()
    wall = time.perf_counter() - t0
    cfg = mods.get_config(qs.ARCH)
    tiles = mods.tiles_from_plan(res.plan)
    launch = mods.geometry.flash_launch(1, cfg.n_heads, SEQ, SEQ, cfg.resolved_head_dim, cfg.dtype,
                                        tiles.attn_block_q, tiles.attn_block_kv)  # raises if not
    options = mods.attn_block_options(cfg, mods.H100)
    if res.plan.attn_block not in options:
        raise AssertionError(f"tuned attn_block {res.plan.attn_block} is not among {options}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    bq, bkv = res.plan.attn_block
    row = _flash_case(torch, F, fa, gen, (1, cfg.n_heads, cfg.n_kv_heads, SEQ, SEQ,
                                          cfg.resolved_head_dim, bq, bkv, True, cfg.dtype,
                                          f"prefill granite-moe, tuned plan ({bq},{bkv})"))
    hw = mods.H100
    emit("search", arch=qs.ARCH, shape=qs.SHAPE, algo=qs.ALGO, hw=hw.name, mesh="card",
         wall_s_on_host=wall, tuner_wall_time_s=res.wall_time_s, n_evals=res.n_evals,
         cache_hits=res.cache_hits, cache_misses=res.cache_misses, cost_s=res.cost,
         plan=res.plan.to_dict(),
         estimated_terms_not_measured={k: getattr(terms, k) for k in (
             "step_s", "compute_s", "memory_s", "collective_s", "hbm_per_chip", "feasible")},
         hw_spec=dataclasses.asdict(hw),
         card_total_memory_bytes=torch.cuda.get_device_properties(0).total_memory,
         flash_launch={"block_q": launch.block_q, "block_kv": launch.block_kv,
                       "threads": launch.threads, "smem_bytes": launch.smem_bytes},
         tuned_tile_kernel=row)
    return res, row


def phase_quickstart(torch, np, mods, res) -> dict:
    """Steps 2 and 3 of ``launch/quickstart.py`` on the card: train 3 steps at
    full width under the tuned plan (projected to the cut batch), then serve
    4 requests with the trained weights.  Counters are set to 0 just before
    each: the launches a train step must be ``_expected_train_counts`` of the
    plan and the launched attention tile the plan's; the launches a decode
    call ``_expected_decode_counts``; every request must complete."""
    qs, optim, ops = mods.quickstart, mods.optim, mods.ops
    plan = qs.project(res.plan)
    tr = qs.make_trainer(plan, device="cuda")
    cfg = tr.cfg
    params, opt_state, _ = tr.init_state()
    expected = _expected_train_counts(cfg, plan, params, tr.opt_cfg.moment_dtype, optim)
    tr.tc.total_steps = 1
    ops.reset_counters()
    with plain_attention_watch() as seen:
        params, opt_state, step = tr.run(params, opt_state, 0)
    first = ops.launch_counts()
    launched = _launched_tiles(ops)
    if first != expected:
        raise AssertionError(f"quickstart train step 1 launches {first}, expected {expected}")
    want_tile = {(min(plan.attn_block[0], SEQ), min(plan.attn_block[1], SEQ))}
    if launched.get("flash_attention") != want_tile:
        raise AssertionError(f"quickstart: plan tile {want_tile} but launched {launched}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # peak of steps 2..: weights, state, one step's work
    tr.tc.total_steps = qs.STEPS
    ops.reset_counters()
    with plain_attention_watch() as seen_rest:
        params, opt_state, step = tr.run(params, opt_state, step)
    rest = ops.launch_counts()
    want = {k: v * (qs.STEPS - 1) for k, v in expected.items()}
    if rest != want:
        raise AssertionError(f"quickstart train steps 2-{qs.STEPS} launches {rest}, expected {want}")
    plain_on_card = _check_no_plain_attention(seen + seen_rest, "quickstart train")
    peak = torch.cuda.max_memory_allocated()
    log = tr.metrics_log
    if len(log) != qs.STEPS or not all(
            torch.isfinite(torch.tensor([r["loss"], r["grad_norm"]])).all() for r in log):
        raise AssertionError(f"quickstart: non-finite loss or grad_norm: {log}")
    med = statistics.median(r["step_time_s"] for r in log[1:])
    tokens = qs.BATCH * qs.SEQ

    eng = qs.make_engine(cfg, params, plan, device="cuda")
    counted = eng._decode = _CountedDecode(eng._decode)
    ops.reset_counters()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if len(done) != qs.REQUESTS or any(len(r.generated) != qs.MAX_NEW for r in done):
        raise AssertionError(f"quickstart served {len(done)}/{qs.REQUESTS} requests")
    calls = counted.calls
    want_dec = {k: v * calls for k, v in _expected_decode_counts(cfg).items()}
    if counts != want_dec:
        raise AssertionError(f"quickstart serving launches {counts} in {calls} decode calls, "
                             f"expected {want_dec}")
    mask = np.ones((eng.slots,), bool)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng._decode(mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # after serving: the profiled step updates the weights once more
    batch = tr.batch_at(step)
    prof = _profile_one(torch, lambda: tr.step_fn(params, opt_state, batch))
    emit("quickstart", arch=cfg.name, plan=res.plan.to_dict(),
         projected={"microbatches": [res.plan.microbatches, plan.microbatches]},
         train={"batch": qs.BATCH, "seq": qs.SEQ, "steps": [
                    {"step": r["step"], "loss": r["loss"], "grad_norm": r["grad_norm"],
                     "lr": r["lr"], "step_ms": r["step_time_s"] * 1e3} for r in log],
                "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
                "peak_memory_gib": peak / 2**30, "launches_per_step": expected, "profile": prof,
                "plain_attention_calls_on_card": plain_on_card,
                "launched_tiles": {k: sorted(map(list, v)) for k, v in launched.items()}},
         serve={"slots": eng.slots, "completed": len(done), "submitted": qs.REQUESTS,
                "run_s": wall, "decode_calls": calls,
                "launches_per_decode_call": {k: v // calls for k, v in counts.items()},
                "median_decode_step_ms": statistics.median(times) * 1e3,
                "decode_step_ms": [t * 1e3 for t in times]})
    del tr, params, opt_state, batch, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {k: first[k] + rest[k] + counts[k] for k in first}


def _fill_caches(torch, ops, caches, gen) -> None:
    """The same random K and V in both caches: N(0, 1) in bf16 in the bf16
    cache, and its rowwise int8 codes and scales (the quantize kernel, before
    any counted run) in the int8 one."""
    for name, leaves in caches["bf16"].items():
        i8 = caches["int8"][name]
        for k in ("k", "v"):
            for p in range(leaves[k].shape[0]):
                x = leaves[k][p]
                x.copy_(torch.randn(x.shape, generator=gen, device="cuda", dtype=torch.bfloat16))
                q, sc = ops.quantize_int8(x.reshape(-1, x.shape[-1]))
                i8[k][p].copy_(q.view(x.shape))
                i8[k + "_s"][p].copy_(sc.view(i8[k + "_s"][p].shape))


def _decode_int8_parity(torch, np, mods) -> dict:
    """A 2-layer f32 granite-moe at full width decoding with an int8 cache on
    the card (kernels) and through the port's CPU path (plain versions): 6
    steps at a scalar ``cur``, then one at per-row ``cur`` with a ``commit``
    mask; the logits of every step (committed rows) within 1e-3, as
    ``phase_parity`` holds them, and at the end the codes and scales.  The K
    and V rows a layer quantizes come from hidden states that differ between
    card and CPU as the logits do (up to ~1e-4 relative on a row), so a scale
    is held to 1e-3 relative and a code may take the next value, on at most
    1e-2 of the codes (a value within 1e-4 x 127 of a rounding boundary)."""
    transformer, ops = mods.transformer, mods.ops
    cfg = dataclasses.replace(mods.get_config(TRAIN_ARCH), n_layers=2, dtype="float32")
    params = {"cpu": transformer.init_params(cfg, SEED, device="cpu")}
    params["cuda"] = _tree_to(params["cpu"], "cuda")
    B, L = 4, 64
    toks = np.random.default_rng(SEED + 9).integers(0, cfg.vocab_size, (B, 8))
    caches = {d: transformer.init_cache(cfg, B, L, kv_dtype="int8", device=d) for d in params}
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_plan()) * cfg.n_periods
    steps = [(t, None) for t in range(6)] + [(np.array([6, 2, 5, 0]), np.array([1, 0, 1, 1], bool))]
    worst = 0.0
    for i, (cur, commit) in enumerate(steps):
        out = {}
        for d in ("cuda", "cpu"):
            c = torch.as_tensor(cur, device=d)
            m = None if commit is None else torch.from_numpy(commit).to(d)
            ops.reset_counters()
            logits, _ = transformer.decode_step(params[d], cfg, caches[d],
                                                torch.from_numpy(toks[:, i:i + 1]).to(d), c, m)
            if d == "cuda":
                torch.cuda.synchronize()
                if ops.launch_counts()["quantize_int8"] != 2 * n_attn:
                    raise AssertionError(f"int8 decode parity: {ops.launch_counts()} launches, "
                                         f"expected {2 * n_attn} quantize_int8")
            out[d] = logits.cpu() if commit is None else logits.cpu()[torch.from_numpy(commit)]
        st = check_close(out["cuda"], out["cpu"], f"int8 decode parity step {i} logits",
                         atol=1e-3, rtol=1e-3)
        worst = max(worst, st["max_abs_err"])
    n_codes = n_diff = 0
    scale_rel = 0.0
    written = slice(0, 7)  # the positions the steps wrote
    for name, leaves in caches["cpu"].items():
        got = caches["cuda"][name]
        for k in ("k", "v"):
            d = got[k].cpu().int() - leaves[k].int()
            if d.abs().max().item() > 1:
                raise AssertionError(f"int8 decode parity: {name}.{k} codes differ by more than 1")
            n_codes += d[..., written, :].numel()
            n_diff += int((d != 0).sum().item())
            check_close(got[k + "_s"].cpu(), leaves[k + "_s"], f"int8 decode parity {name}.{k}_s",
                        atol=0.0, rtol=1e-3)
            scale_rel = max(scale_rel, ((got[k + "_s"].cpu() - leaves[k + "_s"]).abs()
                                        / leaves[k + "_s"]).max().item())
    if n_diff > 1e-2 * n_codes:
        raise AssertionError(f"int8 decode parity: {n_diff} of {n_codes} codes differ (limit 1e-2)")
    return {"n_layers": 2, "dtype": "float32", "rows": B, "max_len": L, "steps": len(steps),
            "logits_max_abs_err": worst, "logits_tol": 1e-3, "codes": n_codes,
            "codes_differing": n_diff, "codes_differing_limit": 1e-2, "scale_rtol": 1e-3,
            "scale_worst_rel_err": scale_rel}


def phase_decode_int8(torch, np, mods) -> dict:
    """granite-moe-1b-a400m at full width through ``make_serve_step``:
    ``DECODE_ROWS`` rows at ``cur`` = ``DECODE_LEN`` - 1 over a bf16 and an
    int8 cache that hold the same random K and V.  Exact launches of one
    decode call of each (the int8 one quantizes K and V apart: two launches
    per attention layer, 48 in all); the first layer's new K and V rows, whose
    inputs the two runs share, within half an int8 step of the bf16 rows; the
    logits in relative norm (``INT8_DECODE_REL``); decode ms of each in turns
    (median of 10) and each one's peak (the weights, its cache and the step's
    own peak over what was allocated before it); then the 2-layer f32 int8
    decode, card against the CPU path."""
    ops, transformer = mods.ops, mods.transformer
    t_phase = time.perf_counter()
    cfg = mods.get_config(TRAIN_ARCH)
    params = transformer.init_params(cfg, SEED, device="cuda")
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    caches = {kv: transformer.init_cache(cfg, DECODE_ROWS, DECODE_LEN, kv_dtype=kv, device="cuda")
              for kv in ("bf16", "int8")}
    cache_bytes = {kv: sum(t.numel() * t.element_size() for t in _leaves(c))
                   for kv, c in caches.items()}
    _fill_caches(torch, ops, caches, torch.Generator(device="cuda").manual_seed(SEED + 8))
    tokens = torch.from_numpy(
        np.random.default_rng(SEED + 8).integers(0, cfg.vocab_size, (DECODE_ROWS, 1))).to("cuda")
    cur = DECODE_LEN - 1
    steps = {kv: mods.make_serve_step(cfg, None, mods.SchedulePlan(kv_dtype=kv), device="cuda")
             for kv in caches}
    attn_blocks = [f"b{i}" for i, s in enumerate(cfg.layer_plan()) if s.mixer == "attn"]
    n_attn = len(attn_blocks) * cfg.n_periods
    base = _expected_decode_counts(cfg)
    expected = {"bf16": base, "int8": {**base, "quantize_int8": 2 * n_attn}}
    logits, counts, peak_gib = {}, {}, {}
    for kv in ("bf16", "int8"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counters()
        out, _ = steps[kv](params, caches[kv], tokens, cur)
        torch.cuda.synchronize()
        counts[kv] = ops.launch_counts()
        if counts[kv] != expected[kv]:
            raise AssertionError(f"decode_int8 {kv}: launches {counts[kv]}, expected {expected[kv]}")
        transient = torch.cuda.max_memory_allocated() - before
        peak_gib[kv] = (weights + cache_bytes[kv] + transient) / 2**30
        if tuple(out.shape) != (DECODE_ROWS, cfg.vocab_size) or not bool(out.isfinite().all()):
            raise AssertionError(f"decode_int8 {kv}: logits of the wrong shape or not finite")
        logits[kv] = out.float()
    # the first attention layer's new rows: the same K and V in both runs
    first = {}
    for k in ("k", "v"):
        codes = caches["int8"][attn_blocks[0]][k][0][:, :, cur].float()
        sc = caches["int8"][attn_blocks[0]][k + "_s"][0][:, :, cur]
        ref = caches["bf16"][attn_blocks[0]][k][0][:, :, cur].float()
        first[k] = ((codes * sc - ref).abs() / sc).max().item()
        if first[k] > 0.5 + 1e-5:
            raise AssertionError(f"decode_int8: the first layer's new {k} row is {first[k]} int8 "
                                 "steps from the bf16 row (limit 0.5)")
    rel = ((logits["int8"] - logits["bf16"]).norm() / logits["bf16"].norm()).item()
    row_rel = ((logits["int8"] - logits["bf16"]).norm(dim=-1) / logits["bf16"].norm(dim=-1))
    if rel > INT8_DECODE_REL:
        raise AssertionError(f"decode_int8: int8 logits {rel} from bf16 in norm (limit {INT8_DECODE_REL})")
    times = {"bf16": [], "int8": []}
    for _ in range(10):
        for kv in ("bf16", "int8"):
            t0 = time.perf_counter()
            steps[kv](params, caches[kv], tokens, cur)
            torch.cuda.synchronize()
            times[kv].append((time.perf_counter() - t0) * 1e3)
    del caches, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    parity = _decode_int8_parity(torch, np, mods)
    emit("decode_int8", arch=cfg.name, rows=DECODE_ROWS, max_len=DECODE_LEN, cur=cur,
         cache_content="N(0,1) K and V, the same in both caches",
         launches_per_decode_call=counts,
         quantize_launches_per_decode_call={"int8": counts["int8"]["quantize_int8"],
                                            "design": "K and V quantized apart: 2 a layer",
                                            "attention_layers": n_attn},
         median_decode_step_ms={kv: statistics.median(t) for kv, t in times.items()},
         decode_step_ms=times, peak_gib=peak_gib,
         cache_gib={kv: b / 2**30 for kv, b in cache_bytes.items()}, weights_gib=weights / 2**30,
         first_layer_new_row_err_in_int8_steps=first,
         logits_rel_int8_vs_bf16=rel, logits_rel_tol=INT8_DECODE_REL,
         logits_worst_row_rel=row_rel.max().item(), parity=parity,
         seconds=time.perf_counter() - t_phase)
    return {n: counts["bf16"][n] + counts["int8"][n] for n in KERNELS}


# the benchmark cells' decode shapes (cardbench/traffic, cardbench/configs):
# 16 slots over an int8 cache, each slot at one of its history lengths
# (evenly spaced, lowest to highest); jamba2-mini at the cell's 16 of 32 layers
SERVE_GRAPH_CELLS = (
    ("granite-moe-1b-a400m", None, 32768, (16384, 28672)),
    ("jamba2-mini", 16, 262144, (131072, 245760)),
)
SERVE_GRAPH_STEPS = 8  # timed steps of each kind


def phase_serve_graph(torch, np, mods) -> dict:
    """``serve.graph``, a line a benchmark cell's shape (``SERVE_GRAPH_CELLS``):
    the step run as it is (``transformer.decode_step``) against the serve
    step's CUDA graph (``runtime.graphs``).  First, with no row committed (so
    the cache stays as it is), the logits of two replays against those of the
    step run as it is, bit for bit; then ``SERVE_GRAPH_STEPS`` steps of each
    that advance every slot: host ms a step (launch to the logits' argmax on
    the host, as the benchmark times it), device ms a step (CUDA events over
    back-to-back replays), the launches a replay counts against a step run as
    it is (equal, kernel by kernel), and the device operations of one replay
    as ``torch.profiler`` records them (``_profile_one``).  Weights from the
    seed, the cache's visible rows random int8 codes and scales, the Mamba
    window and state N(0, 1) and N(0, 0.01)."""
    ops, transformer = mods.ops, mods.transformer
    launches = {n: 0 for n in KERNELS}
    for arch, n_layers, max_len, (lo, hi) in SERVE_GRAPH_CELLS:
        t_phase = time.perf_counter()
        cfg = mods.get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        plan = mods.SchedulePlan(kv_dtype="int8")
        tiles = mods.tiles_from_plan(plan)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(cfg, SEED, device="cuda")
        cache = transformer.init_cache(cfg, DECODE_ROWS, max_len, kv_dtype="int8", device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
        for leaves in cache.values():
            for name, t in leaves.items():
                if t.dtype == torch.int8:
                    t.random_(-127, 128, generator=gen)
                elif name.endswith("_s"):
                    t.uniform_(0.01, 0.06, generator=gen)
                else:
                    t.normal_(0.0, 1.0 if name == "conv" else 0.01, generator=gen)
        cur = torch.tensor([lo + round(i * (hi - lo) / (DECODE_ROWS - 1)) for i in range(DECODE_ROWS)],
                           device="cuda")
        tok = torch.from_numpy(
            np.random.default_rng(SEED + 35).integers(0, cfg.vocab_size, (DECODE_ROWS, 1))).to("cuda")
        step = mods.make_serve_step(cfg, None, plan, device="cuda")
        # no row committed: every call reads the same state
        none = torch.zeros(DECODE_ROWS, dtype=torch.bool, device="cuda")
        want = transformer.decode_step(params, cfg, cache, tok, cur, none, tiles=tiles)[0]
        got = [step(params, cache, tok, cur, none)[0] for _ in range(3)]  # as it is, capture, replay
        torch.cuda.synchronize()
        diffs = [(g.float() - want.float()).abs().max().item() for g in got]
        if any(diffs):
            raise AssertionError(f"serve.graph {arch}: replayed logits differ from the step run as it "
                                 f"is by {diffs}")

        def timed(call, cur):
            tok_, ms, counts = tok, [], []
            for _ in range(SERVE_GRAPH_STEPS):
                ops.reset_counters()
                t0 = time.perf_counter()
                logits = call(tok_, cur)
                nxt = logits.argmax(-1).cpu()
                ms.append((time.perf_counter() - t0) * 1e3)
                counts.append(ops.launch_counts())
                tok_, cur = nxt[:, None].to("cuda"), cur + 1
            return ms, counts, cur

        eager_ms, eager_counts, cur = timed(
            lambda t, c: transformer.decode_step(params, cfg, cache, t, c, tiles=tiles)[0], cur)
        for _ in range(2):  # this key's first call runs as it is, its second captures
            step(params, cache, tok, cur)
            cur = cur + 1
        graph_ms_, graph_counts, cur = timed(lambda t, c: step(params, cache, t, c)[0], cur)
        if any(c != eager_counts[0] for c in eager_counts + graph_counts):
            raise AssertionError(f"serve.graph {arch}: launches a step {graph_counts} against the "
                                 f"step run as it is {eager_counts[0]}")
        graph = next(reversed(step.graphs.graphs.values()))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SERVE_GRAPH_STEPS):
            graph.graph.replay()
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / SERVE_GRAPH_STEPS
        traced = _profile_one(torch, graph.graph.replay)
        for n in KERNELS:
            launches[n] += sum(c[n] for c in eager_counts + graph_counts)
        emit("serve.graph", arch=arch, n_layers=cfg.n_layers, slots=DECODE_ROWS, max_len=max_len,
             kv_dtype="int8", cur_first=[lo, hi], graphs=len(step.graphs.graphs),
             logits_replay_vs_eager="bit-equal", logits_max_abs_diff=diffs,
             median_eager_step_ms=statistics.median(eager_ms), eager_step_ms=eager_ms,
             median_replay_step_ms=statistics.median(graph_ms_), replay_step_ms=graph_ms_,
             device_ms_per_step=device_ms,
             host_speedup=statistics.median(eager_ms) / statistics.median(graph_ms_),
             captured_launches_per_step={k: c for k, (c, _) in graph.launches.items()},
             launches_per_step=eager_counts[0], replay_device_events=traced["device_events"],
             replay_traced_device_busy_ms=traced["device_busy_ms"],
             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             seconds=time.perf_counter() - t_phase)
        del params, cache, step, graph, got, want
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _ranks(np, xs):
    """Ranks from 0, ties given their mean rank."""
    xs = np.asarray(xs, dtype=float)
    ranks = np.empty(len(xs))
    ranks[xs.argsort(kind="stable")] = np.arange(len(xs))
    for v in np.unique(xs):
        ranks[xs == v] = ranks[xs == v].mean()
    return ranks


def spearman(np, a, b) -> float:
    return float(np.corrcoef(_ranks(np, a), _ranks(np, b))[0, 1])


def _train_turns(torch, mods, plans: dict) -> tuple:
    """Each plan (projected to the cut batch) trained ``TRAIN_STEPS`` steps
    at full width through the quickstart's ``Trainer``, fresh weights each
    time, the plans in turns twice; exact launches a step; step ms of steps
    2..``TRAIN_STEPS`` of both turns."""
    qs, ops, optim = mods.quickstart, mods.ops, mods.optim
    out = {name: {"step_ms": [], "peak_gib": 0.0} for name in plans}
    counts = {n: 0 for n in KERNELS}
    for _ in range(2):
        for name, plan in plans.items():
            tr = qs.make_trainer(qs.project(plan), device="cuda", steps=TRAIN_STEPS)
            params, opt_state, _ = tr.init_state()
            expected = _expected_train_counts(tr.cfg, tr.plan, params, tr.opt_cfg.moment_dtype,
                                              optim)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counters()
            tr.run(params, opt_state, 0)
            got = ops.launch_counts()
            if got != {k: v * TRAIN_STEPS for k, v in expected.items()}:
                raise AssertionError(f"measure: {name} plan's {TRAIN_STEPS} steps launched {got}, "
                                     f"expected {expected} a step")
            for n in KERNELS:
                counts[n] += got[n]
            log = tr.metrics_log
            if not all(torch.isfinite(torch.tensor([r["loss"], r["grad_norm"]])).all() for r in log):
                raise AssertionError(f"measure: {name} plan: non-finite loss or grad_norm: {log}")
            out[name]["step_ms"] += [r["step_time_s"] * 1e3 for r in log[1:]]
            out[name]["peak_gib"] = max(out[name]["peak_gib"], torch.cuda.max_memory_allocated() / 2**30)
            out[name]["plan"] = tr.plan.to_dict()
            del tr, params, opt_state
            gc.collect()
            torch.cuda.empty_cache()
    for r in out.values():
        r["median_step_ms"] = statistics.median(r["step_ms"])
    return out, counts


def phase_measure(torch, np, mods, base_res) -> dict:
    """The paper's measured-cost hybrid on the card: ``mcts_cost+real_1s``
    tunes granite-moe-1b-a400m x train_4k for the H100 spec and mesh
    ``card``, each candidate timed on the card by a one-worker fleet bound to
    the card target (``launch/measure.CardTarget``, at the quickstart's
    depth cut: full width, 6 of 24 layers), no measurement failing; the
    Spearman rank correlation of the cost model's ``step_s`` and the card's
    projected ``step_s`` over the programs measured, and their ratio; a
    decode request with an int8 cache (and one with bf16) through the same
    worker; one request through the subprocess CLI (``measure_request`` ->
    ``python -m repro_torch.launch.measure``); then the measured plan and the
    quickstart's ``mcts_1s`` plan trained at full depth in turns."""
    qs, M = mods.quickstart, mods.measure
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the worker's to use
    cache_dir = ROOT / "build" / "chip_smoke_measure"
    shutil.rmtree(cache_dir, ignore_errors=True)
    cut = qs.measure_cut()
    with mods.MeasurementFleet(1, cache_dir=str(cache_dir), target=mods.CardTarget(),
                               timeout=600.0, grace_s=120.0) as fleet:
        backend = fleet.bind(qs.ARCH, qs.SHAPE, "card", hw="h100", device="cuda", cut=cut)
        t0 = time.perf_counter()
        res = mods.autotune(qs.ARCH, qs.SHAPE, algo=qs.MEASURE_ALGO, hw="h100", mesh="card",
                            seed=SEED, measure_backend=backend)
        tune_s = time.perf_counter() - t0
        tune_stats = fleet.stats()
        if res.n_measure_failures or fleet.n_failures:
            raise AssertionError(f"measure: {res.n_measure_failures} measurements failed: "
                                 f"{tune_stats}")
        decode = {}
        for kv in ("int8", "bf16"):
            rec = fleet.measure_cell(qs.ARCH, "decode_32k", "card", mods.SchedulePlan(kv_dtype=kv),
                                     hw="h100", device="cuda", cut=cut)
            if rec["source"] != "card" or rec["program"] != {"kv_dtype": kv}:
                raise AssertionError(f"measure: decode {kv} record {rec['source']} {rec['program']}")
            decode[kv] = {k: rec[k] for k in ("measured_s", "measured_runs_s", "step_s",
                                              "model_step_s", "peak_bytes", "cut", "projection")}
    records = [r for r in (M.load_record(str(p)) for p in sorted(cache_dir.glob("*.json")))
               if r is not None and r["shape"] == qs.SHAPE]
    if len(records) != tune_stats["n_measured"] or any(r["source"] != "card" for r in records):
        raise AssertionError(f"measure: {len(records)} card records for "
                             f"{tune_stats['n_measured']} measurements")
    model_s = [r["model_step_s"] for r in records]
    card_s = [r["step_s"] for r in records]
    ratio = [c / m for c, m in zip(card_s, model_s)]
    by_field = {}
    for f in ("attn_block", "remat", "opt_dtype", "grad_comm", "microbatches"):
        groups = {}
        for r, x in zip(records, ratio):
            groups.setdefault(str(r["program"][f]), []).append(x)
        by_field[f] = {k: {"n": len(v), "median_card_over_model": statistics.median(v)}
                       for k, v in sorted(groups.items())}
    t0 = time.perf_counter()
    cli = M.measure_request(M.make_request(qs.ARCH, qs.SHAPE, "card", res.plan, timeout=600.0,
                                           hw="h100", device="cuda", cut=cut))
    cli_s = time.perf_counter() - t0
    key = M.request_key(M.make_request(qs.ARCH, qs.SHAPE, "card", res.plan, hw="h100",
                                       device="cuda", cut=cut))
    worker_rec = M.load_record(str(cache_dir / f"{key}.json"))
    if cli["source"] != "card" or cli["program"] != worker_rec["program"]:
        raise AssertionError(f"measure: the CLI measured {cli['program']} on {cli['source']}")
    trains, counts = _train_turns(torch, mods, {"mcts_cost+real_1s": res.plan,
                                                "mcts_1s": base_res.plan})
    emit("measure", arch=qs.ARCH, shape=qs.SHAPE, algo=qs.MEASURE_ALGO, hw="h100", mesh="card",
         cut=cut, tune_s=tune_s, n_measurements=res.n_measurements,
         n_measure_failures=res.n_measure_failures,
         card_measurements=tune_stats["n_measured"], cache_hits=tune_stats["n_cache_hits"],
         joined_in_flight=tune_stats["n_deduped"], fleet=tune_stats,
         plan=res.plan.to_dict(), measured_step_s=res.measured, model_cost_s=res.cost,
         spearman_model_vs_card=spearman(np, model_s, card_s), programs=len(records),
         median_card_over_model=statistics.median(ratio),
         card_over_model_by_field=by_field,
         records=[{"program": r["program"], "measured_ms": r["measured_s"] * 1e3,
                   "spread_ms": r["spread_s"] * 1e3, "step_s": r["step_s"],
                   "model_step_s": r["model_step_s"], "peak_gib": r["peak_bytes"] / 2**30}
                  for r in records],
         decode=decode,
         cli={"seconds": cli_s, "measured_ms": cli["measured_s"] * 1e3,
              "worker_measured_ms": worker_rec["measured_s"] * 1e3, "program": cli["program"],
              "device": cli["device"]},
         full_depth_train=trains, seconds=time.perf_counter() - t_phase)
    return counts, records, res, cache_dir, cut


JIT_CELLS = (  # (arch, shape, hw, mesh): the card's tuning cells and one TPU multi-pod cell
    ("granite-moe-1b-a400m", "train_4k", "h100", "card"),
    ("falcon-mamba-7b", "train_4k", "h100", "card"),
    ("granite-3-2b", "decode_32k", "h100", "card"),
    ("stablelm-12b", "prefill_32k", "h100", "card"),
    ("granite-moe-1b-a400m", "train_4k", "tpu-v5e", "multi"),
)
JIT_BATCHES = (1, 8, 64, 512, 4096)


def _host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` (which ends in a device-to-host
    copy, so the device's work is inside it), after one warm-up call."""
    fn()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def phase_jit_pricing(torch, np, mods, device="cuda") -> None:
    """``AnalyticCostModel(pricing="jit", device=...)``, the float64 torch
    pricing program, against the exact columnar kernel at the card's tuning
    cells and a TPU multi-pod cell, on random plan batches of every size in
    ``JIT_BATCHES``: elementwise ``|jit - columnar| <= JIT_RTOL * columnar``
    (atol 0), the program's tensors on ``device``; the host ms a batch of
    each path (the jit path with its packing, copy and sync; below 64 also
    the exact scalar replay that batches under ``columnar_min_batch``
    take)."""
    from repro_torch.core.cost_model import JIT_RTOL, PlanColumns, _build_jit_kernel

    t_phase = time.perf_counter()
    cells = []
    for arch, shape, hw, mesh in JIT_CELLS:
        col = mods.make_mdp(arch, shape, mesh, hw=hw).cost_model
        jit = mods.make_mdp(arch, shape, mesh, hw=hw, pricing="jit", device=device).cost_model
        space = mods.make_mdp(arch, shape, mesh, hw=hw).space
        rng = np.random.default_rng(SEED)
        plans = [space.plan_from_actions([int(rng.integers(len(s.options))) for s in space.stages])
                 for _ in range(max(JIT_BATCHES))]
        ctx_c, ctx_j = col._ctx(), jit._ctx()
        inp = jit._jit_inputs(PlanColumns.from_plans(plans[:8]), ctx_j)
        out = _build_jit_kernel(jit, ctx_j)(**inp)
        where = sorted({t.device.type for t in inp.values()} | {out.device.type})
        if where != [torch.device(device).type]:
            raise AssertionError(f"jit_pricing {arch} {shape}: the program ran on {where}")
        rows = []
        for n in JIT_BATCHES:
            cols = PlanColumns.from_plans(plans[:n])
            a = jit._terms_jitted(cols, ctx_j)
            b = col._terms_columnar(cols, ctx_c)["step_s"]
            err = np.abs(a - b)
            if not (np.all(np.isfinite(a)) and np.all(err <= JIT_RTOL * b)):
                raise AssertionError(f"jit_pricing {arch} {shape} {hw} {mesh} batch {n}: "
                                     f"max rel err {float(np.max(err / b))} > {JIT_RTOL}")
            reps = 50 if n <= 64 else 10
            row = {"batch": n, "max_rel_err": float(np.max(err / b)),
                   "jit_ms": _host_ms(lambda: jit._terms_jitted(cols, ctx_j), reps),
                   "columnar_ms": _host_ms(lambda: col._terms_columnar(cols, ctx_c), reps),
                   "encode_ms": _host_ms(lambda: PlanColumns.from_plans(plans[:n]), reps)}
            if n <= 64:
                row["scalar_ms"] = _host_ms(
                    lambda: [col._terms_scalar(p, ctx_c).step_s for p in plans[:n]], reps)
            rows.append(row)
        cells.append({"arch": arch, "shape": shape, "hw": hw, "mesh": mesh, "device": where[0],
                      "batches": rows,
                      "jit_faster_from": next((r["batch"] for r in rows
                                               if r["jit_ms"] < r["columnar_ms"]), None)})
    emit("jit_pricing", rtol=JIT_RTOL, atol=0.0, min_batch=mods.JIT_MIN_BATCH, cells=cells,
         seconds=time.perf_counter() - t_phase)


def phase_learned(torch, np, mods, measure_records, device="cuda") -> None:
    """Learned-cost serving on the card: ``autotune(algo="mcts_1s",
    cost="learned")`` and ``cost="hybrid"`` of granite-moe-1b-a400m x
    train_4k for the H100 and mesh ``card``, the MLP fitting and pricing on
    ``device`` (learned-served misses must be above 0 under "learned");
    the same "learned" run on a 2-worker pinned pool (each worker prices on
    ``device`` in its own CUDA context: its device, context seconds and
    bytes, the pool's spawn seconds and the card memory the workers held;
    the merged version tags and counters must add up); one set of fitted
    params priced on the card and on the CPU (rtol 1e-5); and, a reading,
    an MLP fitted on the ``measure`` phase's card records, every third held
    out, beside the analytic model's holdout Spearman against the card."""
    from repro_torch.core import learned_cost as lc

    qs = mods.quickstart
    t_phase = time.perf_counter()

    def mdp():
        return mods.make_mdp(qs.ARCH, qs.SHAPE, "card", hw="h100")

    def on_device(priced_on):  # None: priced nothing yet; else a device of ``device``'s kind
        return priced_on is None or torch.device(priced_on).type == torch.device(device).type

    def run(cost, **kw):
        """``autotune`` with ``cost`` on ``device``; the mdp is passed in a
        CachedMDP so that its cache and the mounted backend can be read."""
        cmdp = mods.CachedMDP(mdp())
        t0 = time.perf_counter()
        res = mods.autotune(qs.ARCH, qs.SHAPE, algo="mcts_1s", hw="h100", mesh="card", seed=SEED,
                            mdp=cmdp, cost=cost, device=device, **kw)
        wall = time.perf_counter() - t0
        serving = res.stats["serving"]
        exact = mdp().cost_model.cost(res.plan)
        if res.cost != exact or res.cost_mode != cost or not on_device(serving["priced_on"]):
            raise AssertionError(f"learned {cost}: cost {res.cost} (exact {exact}), priced on "
                                 f"{serving['priced_on']}")
        return res, cmdp, {"wall_s": wall, "serving": serving, "plan": res.plan.to_dict(),
                           "exact_cost_s": res.cost, "n_evals": res.n_evals}

    runs = {}
    for cost in ("learned", "hybrid"):
        res, cmdp, runs[cost] = run(cost)
        if cost == "learned":
            if not (res.learned_evals > 0 and runs[cost]["serving"]["learned_batches"] > 0):
                raise AssertionError(f"learned: the model served no miss: {runs[cost]}")
            model = cmdp.cost_backend.model

    # the same "learned" run on two pinned workers
    if device == "cuda":
        torch.cuda.empty_cache()
    used0 = mods.device.nvml_used_bytes(0)
    t0 = time.perf_counter()
    pool = mods.PinnedWorkerPool([], mods.CachedMDP(mdp()), n_workers=2)
    spawn_s = time.perf_counter() - t0
    try:
        res, cmdp, parallel = run("learned", parallel=True, n_workers=2, worker_pool=pool)
        used_alive = mods.device.nvml_used_bytes(0)
    finally:
        pool.shutdown()
    time.sleep(1.0)
    used_after = mods.device.nvml_used_bytes(0)
    be = cmdp.cost_backend
    workers = [w.get("pricing") for w in res.stats["workers"]]
    tags = cmdp.cache.terminal_version
    problems = []
    if not (be.trainer.version >= 1 and tags and be.n_learned_plans > 0
            and res.learned_evals == be.n_learned_plans == parallel["serving"]["learned_plans"]):
        problems.append(f"tags {len(tags)}, counters {be.counters()}, "
                        f"learned_evals {res.learned_evals}, version {be.trainer.version}")
    if not all(1 <= v <= be.trainer.version for v in list(tags.values())
               + list(cmdp.cache.partial_version.values())):
        problems.append("a version tag no trainer minted")
    if len(workers) != 2 or any(w is None or w["device"] != device for w in workers):
        problems.append(f"worker reports {workers}")
    elif not any(w["priced_on"] for w in workers) or not all(
            on_device(w["priced_on"]) for w in workers):
        problems.append(f"workers priced on {[w['priced_on'] for w in workers]}")
    if problems:
        raise AssertionError(f"learned parallel: {problems}")
    parallel.update(pool_spawn_s=spawn_s, workers=workers, tagged_terminal=len(tags),
                    card_used_bytes={"before_pool": used0, "pool_alive": used_alive,
                                     "after_shutdown": used_after})

    # one set of fitted params priced on the card and on the CPU
    space = mdp().space
    rng = np.random.default_rng(SEED + 1)
    probe = [space.plan_from_actions([int(rng.integers(len(s.options))) for s in space.stages])
             for _ in range(512)]
    on_dev = lc.LearnedCostModel(params=model.params, space=space, mean=model.mean,
                                 std=model.std, device=device).cost_batch(probe)
    on_cpu = lc.LearnedCostModel(params=model.params, space=space, mean=model.mean,
                                 std=model.std, device="cpu").cost_batch(probe)
    rel = float(np.max(np.abs(np.asarray(on_dev) - on_cpu) / np.asarray(on_cpu)))
    if not rel <= 1e-5:
        raise AssertionError(f"learned: card and CPU predictions differ by {rel} (rtol 1e-5)")

    # a reading: the MLP on the card's own step times, every third record held out
    card = {}
    if measure_records:
        plans = [mods.SchedulePlan.from_dict({**mods.SchedulePlan().to_dict(), **r["program"]})
                 for r in measure_records]
        card_s = [r["step_s"] for r in measure_records]
        model_s = [r["model_step_s"] for r in measure_records]
        train = [i for i in range(len(plans)) if i % 3]
        hold = [i for i in range(len(plans)) if not i % 3]
        fitted = lc.fit_learned_cost(space, [plans[i] for i in train], [card_s[i] for i in train],
                                     device=device)
        pred = fitted.cost_batch([plans[i] for i in hold])
        card = {"records": len(plans), "train": len(train), "holdout": len(hold),
                "mlp_holdout_spearman": lc._spearman(np.asarray(pred),
                                                      np.asarray([card_s[i] for i in hold])),
                "analytic_holdout_spearman": lc._spearman(
                    np.asarray([model_s[i] for i in hold]), np.asarray([card_s[i] for i in hold]))}
    emit("learned", arch=qs.ARCH, shape=qs.SHAPE, hw="h100", mesh="card", device=device,
         runs=runs, parallel=parallel, card_vs_cpu_max_rel=rel, card_vs_cpu_plans=len(probe),
         fit_on_card_records=card, context_of_this_process=dict(mods.device.CONTEXT),
         seconds=time.perf_counter() - t_phase)


SERVICE_SOCKET = "build/chip_smoke_tuner.sock"  # relative to the checkout: short for AF_UNIX


def _start_daemon(store, measure, measure_cache, cut, device, log):
    cmd = [sys.executable, "-m", "repro_torch.launch.tune_serve", "serve", "--store", str(store),
           "--socket", SERVICE_SOCKET, "--measure", measure, "--device", device,
           "--measure-cache", str(measure_cache)]
    if cut and cut.get("layers"):
        cmd += ["--measure-layers", str(cut["layers"])]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    sock = ROOT / SERVICE_SOCKET
    if sock.exists():
        sock.unlink()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    while not sock.exists():
        if proc.poll() is not None or time.perf_counter() - t0 > 120:
            proc.kill()
            raise AssertionError(f"service: the daemon did not come up (rc {proc.poll()})")
        time.sleep(0.05)
    return proc, time.perf_counter() - t0


def _stop_daemon(proc, client) -> None:
    try:
        client.shutdown()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def phase_service(torch, mods, base_res, measure_res, measure_cache, cut, device="cuda",
                  measure="real") -> None:
    """The tuner daemon (``python -m repro_torch.launch.tune_serve serve``)
    on a Unix socket under ``build/``, ``--measure real`` on ``device`` with
    the fleet's records at the ``measure`` phase's cache: (1) a cold
    ``mcts_1s`` h100 request is searched, and equals the ``search`` phase's
    one-shot result; (2) the same request is a store hit with no search;
    (3) the cell with ``hw="tpu-v5e"`` is searched, never answered with
    the h100 plan; (4) ``mcts_cost+real_1s`` equals the ``measure`` phase's
    plan, cost and measured time.  Then the daemon is shut down and started
    again on the same store, and (4) is a store hit that measures nothing."""
    from repro_torch.launch.tune_serve import TuneClient

    qs = mods.quickstart
    t_phase = time.perf_counter()
    store = ROOT / "build" / "chip_smoke_service"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    client = TuneClient(str(ROOT / SERVICE_SOCKET) if len(str(ROOT / SERVICE_SOCKET)) < 100
                        else SERVICE_SOCKET, timeout=900.0)
    base = dict(algo="mcts_1s", mesh="card", hw="h100", seed=SEED)
    real = dict(base, algo=qs.MEASURE_ALGO)
    out = {}
    with open(store / "daemon.log", "w") as log:
        proc, up_s = _start_daemon(store, measure, measure_cache, cut, device, log)
        try:
            for name, req in (("cold", base), ("repeat", base),
                              ("tpu", dict(base, hw="tpu-v5e", mesh="single")),
                              ("measured", real)):
                before = client.stats()["stats"]
                r = client.tune(qs.ARCH, qs.SHAPE, **req)
                after = client.stats()["stats"]
                if not r.get("ok"):
                    raise AssertionError(f"service {name}: {r}")
                out[name] = {"served": r["served"], "time_to_plan_s": r["time_to_plan_s"],
                             "searches": after["n_searches"] - before["n_searches"],
                             "hw": r["result"]["hw"], "plan": r["result"]["plan"],
                             "cost_s": r["result"]["cost"], "measured_s": r["result"]["measured"],
                             "fleet": after.get("fleet")}
            stats = client.stats()["stats"]
        finally:
            _stop_daemon(proc, client)
        proc2, up2_s = _start_daemon(store, measure, measure_cache, cut, device, log)
        try:
            r = client.tune(qs.ARCH, qs.SHAPE, **real)
            stats2 = client.stats()["stats"]
        finally:
            _stop_daemon(proc2, client)
    restart = {"served": r["served"], "time_to_plan_s": r["time_to_plan_s"],
               "searches": stats2["n_searches"], "plan": r["result"]["plan"],
               "cost_s": r["result"]["cost"], "fleet": stats2.get("fleet")}
    want_plan = mods.SchedulePlan.from_dict
    problems = []
    if out["cold"]["served"] != "search" or want_plan(out["cold"]["plan"]) != base_res.plan \
            or out["cold"]["cost_s"] != base_res.cost:
        problems.append(f"cold: {out['cold']['served']}, not the one-shot mcts_1s result")
    if out["repeat"]["served"] != "store" or out["repeat"]["searches"] != 0 \
            or out["repeat"]["plan"] != out["cold"]["plan"]:
        problems.append(f"repeat: {out['repeat']['served']}, {out['repeat']['searches']} searches")
    if out["tpu"]["served"] != "search" or out["tpu"]["hw"] != "tpu-v5e":
        problems.append(f"tpu-v5e: {out['tpu']['served']} {out['tpu']['hw']}")
    m = out["measured"]
    if m["served"] != "search" or want_plan(m["plan"]) != measure_res.plan \
            or m["cost_s"] != measure_res.cost or m["measured_s"] != measure_res.measured:
        problems.append(f"measured: {m['served']} {m['plan']} {m['cost_s']}, not the measure "
                        f"phase's {measure_res.plan.to_dict()} {measure_res.cost}")
    if restart["served"] != "store" or restart["searches"] != 0 or restart["plan"] != m["plan"] \
            or (restart["fleet"] or {}).get("n_measured", 0) != 0:
        problems.append(f"after the restart: {restart['served']}, {restart['searches']} searches, "
                        f"fleet {restart['fleet']}")
    if problems:
        raise AssertionError(f"service: {problems}")
    emit("service", arch=qs.ARCH, shape=qs.SHAPE, device=device, cut=cut, daemon_up_s=[up_s, up2_s],
         requests=out, restart=restart, store=stats["store"], time_to_plan=stats["time_to_plan"],
         seconds=time.perf_counter() - t_phase)


def phase_train_parity(torch, np, mods, arch=TRAIN_ARCH, S=512, plan=None, optimizer=True):
    """A 2-layer f32 ``arch`` at full width, B=1, ``S`` tokens: loss and
    every gradient leaf on the card (kernels and their Functions: the flash
    and scan backward kernels among them) against the port's CPU path; then
    (``optimizer``) one ``apply_updates`` with int8 moments from the same
    gradients on both."""
    optim, transformer, moe, ops = mods.optim, mods.transformer, mods.moe, mods.ops
    cfg = dataclasses.replace(mods.get_config(arch), n_layers=2, dtype="float32")
    tiles = mods.tiles_from_plan(plan or mods.SchedulePlan())
    params = dict(zip(("cpu", "cuda"), _parity_params(transformer, cfg)))
    toks = torch.from_numpy(np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, (1, S)))
    routes = {"cuda": [], "cpu": []}
    real_route = moe.route
    out, counts, launched = {}, None, None
    try:
        for device in ("cuda", "cpu"):
            def route(p, c, xt, device=device):
                r = real_route(p, c, xt)
                routes[device].append(r)
                return r
            moe.route = route
            paths, leaves = zip(*optim.leaves(params[device]))
            for p in leaves:
                p.requires_grad_(True)
            ops.reset_counters()
            t = toks.to(device)
            logits = transformer.forward(params[device], cfg, t,
                                         mods.make_positions(cfg, 1, S, device=device), tiles=tiles)
            loss = mods.cross_entropy(logits[:, :-1], t[:, 1:])
            grads = torch.autograd.grad(loss, leaves)
            if device == "cuda":
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                launched = {k: sorted(map(list, v)) for k, v in _launched_tiles(ops).items()}
            out[device] = (loss.detach().cpu(), {k: g.detach().cpu() for k, g in zip(paths, grads)})
    finally:
        moe.route = real_route
    fwd = _expected_counts(cfg)
    want = {**fwd, "moe_gemm": 3 * fwd["moe_gemm"], "rmsnorm_backward": fwd["rmsnorm"],
            "flash_attention_backward": fwd["flash_attention"],
            "selective_scan_backward": fwd["selective_scan"]}
    if counts != want:
        raise AssertionError(f"train_parity {cfg.name}: launches {counts}, expected {want}")
    loss_stats = check_close(out["cuda"][0][None], out["cpu"][0][None], "train_parity loss",
                             atol=1e-5, rtol=1e-5)
    grad_rel = {}
    for k, g_cpu in out["cpu"][1].items():
        g = out["cuda"][1][k]
        grad_rel[k] = ((g - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30)).item()
        if not bool(g.isfinite().all()) or grad_rel[k] > 1e-4:
            raise AssertionError(f"train_parity {cfg.name}: gradient {k} rel {grad_rel[k]} > 1e-4")
    k_top, gaps = cfg.experts_per_token, []
    for (_, _, topi_gpu), (probs, _, topi_cpu) in zip(routes["cuda"], routes["cpu"], strict=True):
        if not torch.equal(topi_gpu.cpu(), topi_cpu):
            raise AssertionError("train_parity: routing differs between card and CPU")
        top = probs.detach().sort(dim=-1, descending=True).values
        gaps.append((top[:, k_top - 1] - top[:, k_top]).min().item())

    # one optimizer step with int8 moments from the same (CPU) gradients
    opt = _train_parity_optimizer(torch, mods, params, out["cpu"][1]) if optimizer else None
    emit("train_parity", arch=cfg.name, n_layers=2, dtype="float32", tokens=S, launches=counts,
         tiles=launched, loss_cuda=out["cuda"][0].item(), loss_cpu=out["cpu"][0].item(), loss=loss_stats,
         worst_grad_rel=max(grad_rel.values()), grad_rel=grad_rel,
         routing={"layers": len(gaps), "topi_equal": True,
                  "min_gap_kth_to_next_prob": min(gaps) if gaps else None},
         optimizer=opt)


def _train_parity_optimizer(torch, mods, params, grads) -> dict:
    """One ``apply_updates`` with int8 moments from the same gradients on the
    card and the CPU: launches, parameters, moments and int8 codes; first,
    the chunked update against the whole-leaf one on the card
    (``_chunked_against_whole``)."""
    optim, ops = mods.optim, mods.ops
    chunked = _chunked_against_whole(torch, mods, params["cuda"], grads)
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, moment_dtype="int8")
    states = {d: optim.init_opt_state(params[d], oc) for d in ("cuda", "cpu")}
    for d in ("cuda", "cpu"):
        g = optim.tree_from_leaves(params[d], {k: v.to(d) for k, v in grads.items()})
        ops.reset_counters()
        optim.apply_updates(params[d], g, states[d], oc)
        if d == "cuda":
            torch.cuda.synchronize()
            opt_counts = ops.launch_counts()
    n_quant = _moment_chunks(optim, params["cpu"])
    if (opt_counts["quantize_int8"], opt_counts["dequantize_int8"]) != (2 * n_quant, 2 * n_quant):
        raise AssertionError(f"train_parity: optimizer launches {opt_counts}, expected "
                             f"{2 * n_quant} of each quantize kernel")
    worst_param, n_codes, n_diff = 0.0, 0, 0
    for (k, p_gpu), (_, p_cpu) in zip(optim.leaves(params["cuda"]), optim.leaves(params["cpu"])):
        st = check_close(p_gpu.detach().cpu(), p_cpu.detach(), f"train_parity param {k}",
                         atol=1e-6, rtol=1e-5)
        worst_param = max(worst_param, st["max_abs_err"])
    for mom in ("mu", "nu"):
        for (k, m_gpu), (_, m_cpu) in zip(optim.leaves(states["cuda"][mom]),
                                         optim.leaves(states["cpu"][mom])):
            if isinstance(m_cpu, dict):
                d = m_gpu["q"].cpu().int() - m_cpu["q"].int()
                if d.abs().max().item() > 1:
                    raise AssertionError(f"train_parity: {mom} {k} codes differ by more than 1")
                n_codes += d.numel()
                n_diff += int((d != 0).sum().item())
                check_close(m_gpu["s"].cpu(), m_cpu["s"], f"train_parity {mom} {k} scale",
                            atol=0.0, rtol=1e-5)
            else:
                check_close(m_gpu.cpu(), m_cpu, f"train_parity {mom} {k}", atol=1e-7, rtol=1e-5)
    if n_diff > 1e-5 * n_codes:
        raise AssertionError(f"train_parity: {n_diff} of {n_codes} int8 codes differ (limit 1e-5)")
    return {"moment_dtype": "int8", "launches": opt_counts, "worst_param_abs_err": worst_param,
            "codes": n_codes, "codes_differing": n_diff, "chunked_vs_whole": chunked}


def _whole_leaf_apply_updates(torch, optim, params, grads, state, oc) -> None:
    """One device's ``apply_updates`` as it was before it took leaves in
    chunks: each leaf's f32 sum of squares and its update whole (the plain
    version the chunked update is held to)."""
    flat_p = list(optim.leaves(params))
    step_t = torch.tensor(state["step"] + 1, dtype=torch.int32, device=flat_p[0][1].device)
    lr = optim.lr_at(oc, step_t)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for _, g in optim.leaves(grads)))
    scale = torch.minimum(torch.ones((), device=step_t.device), oc.clip_norm / (gnorm + 1e-9))
    bc1 = 1.0 - oc.b1 ** step_t.to(torch.float32)
    bc2 = 1.0 - oc.b2 ** step_t.to(torch.float32)
    flat_g = dict(optim.leaves(grads))
    flat_mu, flat_nu = dict(optim.leaves(state["mu"])), dict(optim.leaves(state["nu"]))
    with torch.no_grad():
        for path, p in flat_p:
            g = flat_g[path].float() * scale
            m = oc.b1 * optim._mom_read(flat_mu[path]) + (1 - oc.b1) * g
            v = oc.b2 * optim._mom_read(flat_nu[path]) + (1 - oc.b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
            if p.ndim >= 2:
                delta = delta + oc.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            optim._mom_write_(flat_mu[path], m)
            optim._mom_write_(flat_nu[path], v)
    state["step"] += 1


def _chunked_against_whole(torch, mods, params, grads) -> dict:
    """Two ``apply_updates`` steps with int8 moments on the card against the
    same two steps taken a whole leaf at a time
    (``_whole_leaf_apply_updates``), from the same weights and gradients,
    at a clip scale of exactly 1 (so that the chunked norm's other order of
    sums cannot reach the update): every parameter, code and scale must be
    bit-equal.  Weights of several chunks and stacked norms (2-D, decayed
    by the whole leaf's rank) are among them where the arch has them."""
    optim = mods.optim
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, moment_dtype="int8", clip_norm=1e30)
    steps = [optim.tree_from_leaves(params, {k: v.to("cuda") * f for k, v in grads.items()})
             for f in (1.0, -0.5)]
    runs = {}
    for name in ("chunked", "whole"):
        p = optim.tree_from_leaves(params, {k: v.detach().clone() for k, v in optim.leaves(params)})
        state = optim.init_opt_state(p, oc)
        for g in steps:
            if name == "chunked":
                optim.apply_updates(p, g, state, oc)
            else:
                _whole_leaf_apply_updates(torch, optim, p, g, state, oc)
        runs[name] = (p, state)
    torch.cuda.synchronize()
    (p_c, s_c), (p_w, s_w) = runs["chunked"], runs["whole"]
    differ = [k for (k, a), (_, b) in zip(optim.leaves(p_c), optim.leaves(p_w)) if not torch.equal(a, b)]
    for mom in ("mu", "nu"):
        for (k, a), (_, b) in zip(optim.leaves(s_c[mom]), optim.leaves(s_w[mom])):
            pairs = [(a[n], b[n]) for n in ("q", "s")] if isinstance(a, dict) else [(a, b)]
            if not all(torch.equal(x, y) for x, y in pairs):
                differ.append(f"{mom}.{k}")
    if differ:
        raise AssertionError(f"train_parity: the chunked update differs from the whole-leaf one in {differ}")
    several = {k: len(optim.chunks(t.shape)) for k, t in optim.leaves(p_c) if len(optim.chunks(t.shape)) > 1}
    return {"steps": len(steps), "bit_equal": True, "leaves": len(list(optim.leaves(p_c))),
            "leaves_of_several_chunks": several, "chunks": sum(len(optim.chunks(t.shape))
                                                              for _, t in optim.leaves(p_c))}


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _parity_params(transformer, cfg) -> tuple:
    """The same weights on the CPU and the card.  A dense arch's are drawn on
    the card and copied: the host took tens of seconds to draw stablelm-12b's
    and qwen2-vl-72b's 1.6 and 4.2 B f32 weights at 2 layers.  An MoE arch's
    (small) keep their host draw: its routing is held equal between card and
    CPU, and where two experts' probabilities nearly tie (~1e-6 apart at the
    closest here) the devices' rounding decides, so a new draw is a new test."""
    device = "cpu" if cfg.n_experts else "cuda"
    params = transformer.init_params(cfg, SEED, device=device)
    other = _tree_to(params, "cuda" if device == "cpu" else "cpu")
    return (params, other) if device == "cpu" else (other, params)


def run_path(torch, np, arch, plans, mods, n_layers=None) -> tuple:
    """One arch's main path at full width (``n_layers``: a depth cut):
    prefill, serving, profile (and for Mamba the slot-reuse check); neither
    prefill nor serving may run the plain attention on the card; its weights
    are freed when this returns."""
    cfg = mods.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = mods.transformer.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, seconds=time.perf_counter() - t0,
         params=sum(t.numel() for t in _leaves(params)))
    with plain_attention_watch() as seen:
        prefill, step, batch = phase_prefill(torch, np, cfg, params, plans, mods.ops,
                                             mods.make_prefill_step, mods.make_positions,
                                             mods.tiles_from_plan)
        serve, eng = phase_serve(torch, np, cfg, params, mods.ops, mods.ServingEngine,
                                 mods.tiles_from_plan)
    _check_no_plain_attention(seen, f"{cfg.name} prefill and serving")
    phase_profile(torch, np, cfg, step, params, batch, eng)
    if cfg.is_ssm:
        phase_slot_reuse(np, cfg, params, mods.ServingEngine)
    return prefill, serve


def mrope_ids(torch, batch: int, seq: int, grid: int = MROPE_GRID, device="cuda"):
    """``(batch, 3, seq)`` M-RoPE ids whose three rows differ: a ``grid x
    grid`` patch block (t 0, h and w its coordinates), then text positions
    from ``grid`` on, the same id in all three rows (Qwen2-VL's layout of an
    image before its text)."""
    i = torch.arange(seq, device=device)
    n = grid * grid
    text = grid + (i - n)
    t = torch.where(i < n, torch.zeros_like(i), text)
    h = torch.where(i < n, i // grid, text)
    w = torch.where(i < n, i % grid, text)
    return torch.stack([t, h, w])[None].expand(batch, 3, seq).contiguous()


def _rotate_f64(torch, x, ang):
    """Split-half rotation of ``x (B, H, S, 2R)`` by ``ang (B, S, R)``, float64."""
    half = ang.shape[-1]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x.double()[..., :half], x.double()[..., half:2 * half]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def phase_positions(torch, mods) -> None:
    """The position encodings of model coverage on the card at their archs'
    full widths and 4096 positions, against formulas written here in float64:
    M-RoPE through ``apply_positions`` at qwen2-vl-72b's head_dim 128, with
    the published (16, 24, 24) split written as the component each frequency
    takes, on ids whose three rows differ; stablelm-12b's partial rotary (the
    first 40 of 160 dims); musicgen-large's sinusoid through the embedding
    (d 2048).  An f32 angle at position 4095 is off by up to ~1e-3 rad,
    hence 1e-2 per element and 1e-3 in norm."""
    from repro_torch.models import layers
    from repro_torch.sharding.parallel import ParallelContext

    tol = dict(atol=1e-2, rtol=1e-2, rel=1e-3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    out = {}
    qwen = mods.get_config("qwen2-vl-72b")
    hd = qwen.resolved_head_dim
    q = torch.randn((1, 8, SEQ, hd), generator=gen, device="cuda")
    k = torch.randn((1, 2, SEQ, hd), generator=gen, device="cuda")
    pos = mrope_ids(torch, 1, SEQ)
    got_q, got_k = layers.apply_positions(q, k, dataclasses.replace(qwen, dtype="float32"), pos)
    comp = torch.repeat_interleave(torch.arange(3, device="cuda"), torch.tensor([16, 24, 24], device="cuda"))
    freqs = 1.0 / qwen.rope_theta ** (torch.arange(0, hd, 2, device="cuda", dtype=torch.float64) / hd)
    ang = pos.double()[:, comp, :].transpose(1, 2) * freqs  # (1, S, 64)
    out["mrope_q"] = check_close(got_q, _rotate_f64(torch, q, ang), "M-RoPE q, head_dim 128", **tol)
    out["mrope_k"] = check_close(got_k, _rotate_f64(torch, k, ang), "M-RoPE k, head_dim 128", **tol)

    slm = mods.get_config("stablelm-12b")
    hd, rot = slm.resolved_head_dim, int(slm.resolved_head_dim * slm.rotary_pct)
    q = torch.randn((1, 8, SEQ, hd), generator=gen, device="cuda")
    pos = torch.arange(SEQ, device="cuda")[None]
    got_q, _ = layers.apply_positions(q, q[:, :1], dataclasses.replace(slm, dtype="float32"), pos)
    freqs = 1.0 / slm.rope_theta ** (torch.arange(0, rot, 2, device="cuda", dtype=torch.float64) / rot)
    exp = torch.cat([_rotate_f64(torch, q[..., :rot], pos.double()[..., None] * freqs),
                     q[..., rot:].double()], dim=-1)
    out["partial_rope"] = check_close(got_q, exp, "partial rotary, head_dim 160", **tol)

    mg = dataclasses.replace(mods.get_config("musicgen-large"), dtype="float32")
    zeros = torch.zeros((1, SEQ, mg.d_model), device="cuda")
    got = mods.transformer._embed({}, mg, zeros, pos, ParallelContext.local({}, zeros.device))
    half = mg.d_model // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, dtype=torch.float64))
                      * torch.arange(half, device="cuda", dtype=torch.float64) / half)
    ang = pos.double()[..., None] * freqs
    out["sinusoid"] = check_close(got, torch.cat([ang.sin(), ang.cos()], -1), "sinusoid, d 2048", **tol)
    emit("positions", positions=SEQ, **out)


def phase_embeddings_path(torch, np, arch, plans, mods) -> dict:
    """musicgen-large and qwen2-vl-72b take a stub frontend's vectors, and
    the serving engine drives token archs only (as in the JAX package): a
    1 x 4096 prefill of ``(1, 4096, d)`` N(0, 1) embeddings drawn from the
    seed through ``make_prefill_step`` at each plan (musicgen: sinusoidal
    positions; qwen2-vl: M-RoPE ids whose three rows differ), then
    ``EMBED_DECODE_STEPS`` ``decode_step``s of one embeddings row each from
    an empty cache.  Exact launches, the plan's tile launched, no plain
    attention on the card, finite logits, the decoded rows within
    ``DECODE_VS_FORWARD_REL_PER_SQRT_LAYER`` sqrt(n_layers) of a forward of
    the same rows; qwen2-vl at its depth cut.  The prefill is
    ``phase_prefill``'s with this batch."""
    ops, tf = mods.ops, mods.transformer
    cfg = mods.get_config(arch)
    if arch in CUT_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS[arch])
    t0 = time.perf_counter()
    params = tf.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, n_layers=cfg.n_layers, seconds=time.perf_counter() - t0,
         params=sum(t.numel() for t in _leaves(params)))
    dt = getattr(torch, cfg.dtype)
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((1, SEQ, cfg.d_model),
                                                                     dtype=np.float32)).to("cuda", dt)
    positions = (mrope_ids(torch, 1, SEQ) if cfg.pos_kind == "mrope"
                 else mods.make_positions(cfg, 1, SEQ, device="cuda"))
    batch = {"inputs": x, "positions": positions}
    with plain_attention_watch() as seen:
        prefill, step, _ = phase_prefill(torch, np, cfg, params, plans, ops, mods.make_prefill_step,
                                         mods.make_positions, mods.tiles_from_plan, batch)
    _check_no_plain_attention(seen, f"{cfg.name} prefill")

    cache = tf.init_cache(cfg, 1, EMBED_DECODE_STEPS, device="cuda")
    ops.reset_counters()
    dec, times = [], []
    with plain_attention_watch() as seen:
        for t in range(EMBED_DECODE_STEPS):
            t1 = time.perf_counter()
            lg, cache = tf.decode_step(params, cfg, cache, x[:, t:t + 1], t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            dec.append(lg)
    counts = ops.launch_counts()
    want = {k: v * EMBED_DECODE_STEPS for k, v in _expected_decode_counts(cfg).items()}
    if counts != want:
        raise AssertionError(f"{cfg.name} decode launches {counts}, expected {want}")
    _check_no_plain_attention(seen, f"{cfg.name} decode")
    dec = torch.stack(dec, dim=1)  # (1, steps, V)
    if tuple(dec.shape) != (1, EMBED_DECODE_STEPS, cfg.vocab_size) or not bool(dec.isfinite().all()):
        raise AssertionError(f"{cfg.name}: decode logits of the wrong shape or not finite")
    # the decoded rows against a forward of the same rows at the decode's
    # own positions (text ids: for M-RoPE the same id in all three rows)
    with torch.no_grad():
        fwd = tf.forward(params, cfg, x[:, :EMBED_DECODE_STEPS],
                         mods.make_positions(cfg, 1, EMBED_DECODE_STEPS, device="cuda"),
                         tiles=mods.tiles_from_plan(plans[0])).float()
    d = dec.float() - fwd
    lim = DECODE_VS_FORWARD_REL_PER_SQRT_LAYER * math.sqrt(cfg.n_layers)
    vs_forward = {"max_abs_diff": d.abs().max().item(), "rel_diff": (d.norm() / fwd.norm()).item(),
                  "rel_tol": lim}
    if not vs_forward["rel_diff"] <= lim:
        raise AssertionError(f"{cfg.name}: the decoded rows are {vs_forward['rel_diff']:.4g} from a "
                             f"forward of the same rows (relative norm, limit {lim:.4g})")
    emit("decode", arch=cfg.name, n_layers=cfg.n_layers, steps=EMBED_DECODE_STEPS, launches=counts,
         median_step_ms=statistics.median(times) * 1e3, step_ms=[t * 1e3 for t in times],
         vs_forward_rows=vs_forward)
    emit("profile", arch=cfg.name, note="profiler on: wall times include its overhead",
         prefill=_profile_one(torch, lambda: step(params, batch)),
         decode=_profile_one(torch, lambda: tf.decode_step(params, cfg, cache, x[:, :1], 0)))
    del params, cache, dec, step
    gc.collect()
    torch.cuda.empty_cache()
    return {n: prefill[n] + counts[n] for n in KERNELS}


def phase_embed_decode_parity(torch, np, mods) -> None:
    """The embeddings archs' decode on the card in f32 at full width and 2
    layers: ``EMBED_DECODE_STEPS`` ``decode_step``s of one embeddings row
    each from an empty cache against the card's forward of the same rows at
    the decode's positions (text ids), held at phase_parity's 1e-3.  It sees
    musicgen's sinusoid at each row's ``cur`` and qwen2-vl's decoded id in
    all three M-RoPE components, where bf16 at full depth leaves room."""
    tf, n = mods.transformer, EMBED_DECODE_STEPS
    rng = np.random.default_rng(SEED + 5)
    tiles = mods.tiles_from_plan(mods.SchedulePlan(attn_block=(128, 128)))  # f32 launches it at 64 and 128
    for arch in COVERAGE_EMBED_ARCHS:
        cfg = dataclasses.replace(mods.get_config(arch), n_layers=2, dtype="float32")
        params = tf.init_params(cfg, SEED, device="cuda")
        x = torch.from_numpy(rng.standard_normal((1, n, cfg.d_model), dtype=np.float32)).cuda()
        cache = tf.init_cache(cfg, 1, n, device="cuda")
        with torch.no_grad():
            dec = torch.stack([tf.decode_step(params, cfg, cache, x[:, t:t + 1], t)[0] for t in range(n)], 1)
            fwd = tf.forward(params, cfg, x, mods.make_positions(cfg, 1, n, device="cuda"), tiles=tiles)
        stats = check_close(dec, fwd, f"{cfg.name} 2-layer f32 decode vs forward", atol=1e-3, rtol=1e-3)
        emit("decode_parity", arch=cfg.name, n_layers=2, dtype="float32", steps=n, **stats)
        del params, cache
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:45"),
    # the gradient of that kernel, which the JAX package takes with jax.vjp
    # of its oracle (src/repro/kernels/ref.py:108); the TPU has no kernel of it
    "rmsnorm_backward": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:45"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:129"),
    "moe_gemm": ("src/repro_torch/kernels/csrc/moe_gemm.cu", "src/repro/kernels/moe_gemm.py:69"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:90"),
    # the gradients of the flash and scan kernels, which the JAX package takes
    # with jax.vjp of its oracles (src/repro/kernels/ref.py:16 and :50); the
    # TPU has no kernel of either
    "flash_attention_backward": ("src/repro_torch/kernels/csrc/flash_attention_backward.cu",
                                 "src/repro/kernels/flash_attention.py:129"),
    "selective_scan_backward": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                                "src/repro/kernels/selective_scan.py:90"),
    "quantize_int8": ("src/repro_torch/kernels/csrc/quantize.cu", "src/repro/kernels/quantize.py:36"),
    "dequantize_int8": ("src/repro_torch/kernels/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:65"),
    # the JAX package's decode attention is plain jnp: no Pallas kernel
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "none (plain jnp: src/repro/models/attention.py decode_step)"),
}
_SUMMARY_KEYS = ("shape", "dtype", "role", "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "vs_library", "achieved_tflops", "device_ms",
                 "library_device_ms", "exp_bound_ms", "kernel_launches_per_call", "fwd_bwd_ms",
                 "fwd_bwd_vs_library", "library_bwd_ms", "bwd_vs_library", "bit_equal")


# ---------------------------------------------------------------------------
# mesh: an 8-card node's mesh, its ranks sharing the one card
# ---------------------------------------------------------------------------
# a microbatch's tokens, the sequence cut: the grouped GEMMs' backward
# contracts over the MoE capacity C, which block_d = 256 must divide, and
# EP's capacity(T, block=8) is a multiple of 256 at T = 800 (C = 256) and
# then only at multiples of 4096 (2048 gives 640 and raises: ROADMAP Queue
# C); the one process's capacity(800, block=128) is 256 too.  At 4096 the
# 8 ranks' logits alone (vocab 49,155, the plan's vocab_shard off) run the
# card out of memory
MESH_SEQ = 800
MESH_STEPS = 2
# the depth cut: 8 whole replicas of granite-moe's training state (the
# plan's moe_mode "dense" replicates every expert) do not fit one card's 80
# GB at 24 layers (~12 GB of weights, f32 gradients and int8 moments a
# replica plus the optimizer's f32 temporaries of the stacked expert leaves,
# ~9.7 GB); expert parallelism fits at 24 layers (5.13 GiB a rank) but a
# step there took 96 s a rank (1,600 host-staged collectives a rank a step),
# more than the script's time limit affords beside the other phases
MESH_MOE_LAYERS = 6
MAMBA_MESH_LAYERS, MAMBA_MESH_SEQ = 2, 1024
MESH_LOSS_ABS_F32, MESH_PARAM_ABS_F32 = 2e-3, 5e-3  # the CPU tests' bounds
# Every job is also held leaf by leaf: a leaf's update_rel is the norm of
# (mesh weights after step 1 - one process's) over the norm of one
# process's update (its weights after step 1 - the seed's).  Adam's first
# step moves an element by about lr * sign(g), so a gradient whose sign
# differs moves it by 2 lr, and an absolute bound near 2 lr cannot tell a
# wrong gradient from rounding; a leaf left unchanged reads 1, and a
# gradient that misses part of its sum (a norm's, not summed over the
# sequence-parallel ranks) flips about a third of the signs (~1.2).  Where
# the mesh does the one process's arithmetic (f32, no expert parallelism)
# a leaf must read below 1e-2: on an H100 80GB HBM3 at 700 W the worst
# read 1.37e-3 (attn.wk).  Elsewhere below 0.5: EP's combine rounds each
# rank's partial to bf16 before the sum, as the reference's does (worst
# leaf: f32 EP 0.152, the router; bf16 EP at 6 layers 0.248, w_down),
# falcon-mamba bf16 read 0.113 (conv_w) and the dense bf16 plan 0.0
# (bit-equal).  bf16: each step's loss within 5e-3 of the first step's
# (one process) and the first step's grad norm within 5e-2 relative too.
MESH_LEAF_REL_EXACT, MESH_LEAF_REL = 1e-2, 0.5
MESH_LOSS_REL_BF16, MESH_GNORM_REL_BF16 = 5e-3, 5e-2
RING_ELEMS = 1 << 22
MESH_KERNELS = {
    "granite-moe-1b-a400m": ("rmsnorm", "rmsnorm_backward", "flash_attention",
                             "flash_attention_backward", "moe_gemm", "quantize_int8",
                             "dequantize_int8"),
    "falcon-mamba-7b": ("rmsnorm", "rmsnorm_backward", "selective_scan", "selective_scan_backward",
                        "quantize_int8", "dequantize_int8"),
}


def _mesh_setup(job):
    """The config, plan, optimizer config and shape of a mesh job."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.space import SchedulePlan
    from repro_torch.training import optimizer as optim

    cfg = get_config(job["arch"])
    cfg = dataclasses.replace(cfg.reduced() if job.get("reduced") else cfg, n_layers=job["layers"],
                              dtype=job["dtype"])
    plan = SchedulePlan.from_dict(job["plan"])
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, moment_dtype=plan.opt_dtype)
    return cfg, plan, oc, InputShape("mesh_chip", job["seq"], plan.microbatches, "train")


def _mesh_batch(torch, cfg, plan, seq, device):
    from repro_torch.training.train_step import make_positions

    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    tok = torch.randint(0, cfg.vocab_size, (plan.microbatches, seq), generator=g).to(device)
    return {"inputs": tok, "labels": tok,
            "positions": make_positions(cfg, plan.microbatches, seq, device=device)}


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _mesh_rank_job(torch, mesh, job, out_dir):
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.sharding import collectives as cc
    from repro_torch.sharding.parallel import gather_leaf
    from repro_torch.training import optimizer as optim
    from repro_torch.training.train_step import make_prefill_step, make_train_step, shard_params

    cfg, plan, oc, shape = _mesh_setup(job)
    step = make_train_step(cfg, shape, plan, oc, mesh=mesh)
    par = step.par
    full = transformer.init_params(cfg, SEED, device=mesh.device)  # the one process's weights
    params = shard_params(full, par)
    del full
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    opt = optim.init_opt_state(params, oc, par)
    batch = _mesh_batch(torch, cfg, plan, job["seq"], mesh.device)
    prefill = make_prefill_step(cfg, shape, plan, mesh=mesh)
    _sync(torch, mesh.device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    cc.reset_host_staged()
    steps, whole = [], {}

    def one_step():
        nonlocal params, opt
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        _sync(torch, mesh.device)
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "ms": (time.perf_counter() - t0) * 1e3})

    with plain_attention_watch() as seen:
        one_step()
        # the weights after step 1, whole, to rank 0 (every rank takes part): a
        # second int8-moment step can turn a near tie into a jump of m / eps,
        # so the comparison with one process reads these and step 2's loss
        for path, t in optim.leaves(params):
            leaf = gather_leaf(t.detach(), par.flat_specs[path], mesh, path.rsplit(".", 1)[-1])
            if mesh.rank == 0:
                whole[path] = leaf.to("cpu", copy=True)
            del leaf
        t0 = time.perf_counter()
        logits = prefill(params, {k: v[:1] for k, v in batch.items()})
        _sync(torch, mesh.device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(MESH_STEPS - 1):
            one_step()
    counts, staged = ops.launch_counts(), dict(cc.HOST_STAGED)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    local = sum(t.numel() for _, t in optim.leaves(params))
    if mesh.rank == 0:
        torch.save({"params": whole, "logits": logits.cpu()}, os.path.join(out_dir, job["name"] + ".pt"))
    del params, opt, logits, whole, step, prefill
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"steps": steps, "prefill_ms": prefill_ms, "launches": counts, "host_staged": staged,
            "plain_attention_on_card": seen.count("cuda"), "peak_gib": peak / 2**30,
            "local_params": local, "moe_ep": par.moe_ep, "seq_split": par.for_seq(job["seq"]).seq}


def _mesh_rank_ring(torch, mesh, elems):
    """The int8 ring over the 8 ranks: on the card (the quantize kernels)
    against the same ring over CPU copies (their plain versions), and
    against the exact sum."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives as cc
    from repro_torch.training.grad_compress import compressed_psum

    g = torch.Generator(device="cpu").manual_seed(SEED + 100 + mesh.rank)
    x = torch.randn(elems, generator=g).to(mesh.device)
    _sync(torch, mesh.device)
    ops.reset_counters()
    cc.reset_host_staged()
    t0 = time.perf_counter()
    red, err = compressed_psum(x, mesh, "model")
    _sync(torch, mesh.device)
    ms = (time.perf_counter() - t0) * 1e3
    counts, staged = ops.launch_counts(), dict(cc.HOST_STAGED)
    red_plain, err_plain = compressed_psum(x.cpu(), mesh, "model")
    true = cc.all_reduce_(x.clone(), mesh, "model")
    return {"ms": ms, "launches": counts, "host_staged": staged,
            "equal_to_plain": bool(torch.equal(red.cpu(), red_plain) and torch.equal(err.cpu(), err_plain)),
            "rel_to_sum": ((red - true).abs().max() / true.abs().max()).item(), "elements": elems}


def mesh_rank(mesh, jobs, out_dir, ring_elems):
    """What each rank of the mesh phase runs (``run_on_mesh``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 jobs in true f32, as the one process
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": mesh.backend, "device": str(mesh.device), "jobs": {}}
    for job in jobs:
        t0 = time.perf_counter()
        out["jobs"][job["name"]] = _mesh_rank_job(torch, mesh, job, out_dir)
        if mesh.rank == 0:
            print(json.dumps({"phase": "mesh_progress", "job": job["name"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    out["ring"] = _mesh_rank_ring(torch, mesh, ring_elems)
    return out


def _mesh_reference(torch, mods, job, device):
    """One process on the card, from the same seed's weights and batch: its
    steps, the weights after step 1 and the seed's, and the prefill logits
    after step 1."""
    optim = mods.optim
    cfg, plan, oc, shape = _mesh_setup(job)
    params = mods.transformer.init_params(cfg, SEED, device=device)
    init = {k: v.detach().to("cpu", copy=True) for k, v in optim.leaves(params)}
    opt = optim.init_opt_state(params, oc)
    step = mods.make_train_step(cfg, shape, plan, oc, device=device)
    batch = _mesh_batch(torch, cfg, plan, job["seq"], device)
    prefill = mods.make_prefill_step(cfg, shape, plan, device=device)
    steps, after1 = [], None
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        _sync(torch, device)
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "ms": (time.perf_counter() - t0) * 1e3})
        if i == 0:
            after1 = {k: v.detach().to("cpu", copy=True) for k, v in optim.leaves(params)}
            logits = prefill(params, {k: v[:1] for k, v in batch.items()})
    out = (steps, after1, init, logits.cpu())
    del params, opt, step, logits
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_compare(torch, job, ranks, ref, path) -> dict:
    """The mesh job against one process: every rank's losses agree, and
    the losses of both steps, the weights after step 1 (leaf by leaf) and
    the prefill logits after it hold the stated bounds (f32: the CPU
    tests'; bf16: relative)."""
    steps_ref, p_ref, init, logits_ref = ref
    got = torch.load(path, weights_only=True)
    losses = [[s["loss"] for s in r["jobs"][job["name"]]["steps"]] for r in ranks]
    f32 = job["dtype"] == "float32"
    exact = f32 and job["plan"].get("moe_mode") != "ep"
    leaf_bound = MESH_LEAF_REL_EXACT if exact else MESH_LEAF_REL
    loss_ref = [s["loss"] for s in steps_ref]
    loss_abs = max(abs(a - b) for a, b in zip(losses[0], loss_ref))
    loss_rel = loss_abs / abs(loss_ref[0])  # of the first step's loss: a second can be near 0
    gnorm = ranks[0]["jobs"][job["name"]]["steps"][0]["grad_norm"]
    gnorm_rel = abs(gnorm - steps_ref[0]["grad_norm"]) / steps_ref[0]["grad_norm"]
    num = den = worst_abs = 0.0
    leaf_rel = {}
    for k, v in p_ref.items():
        d = got["params"][k].float() - v.float()
        worst_abs = max(worst_abs, d.abs().max().item())
        dn = d.double().square().sum().item()
        un = (v.float() - init[k].float()).double().square().sum().item()
        num, den = num + dn, den + un
        if un > 0:  # a bf16 norm weight does not move by lr at 1.0
            leaf_rel[k] = math.sqrt(dn / un)
    update_rel = math.sqrt(num / max(den, 1e-300))
    logits_rel = ((got["logits"].float() - logits_ref.float()).norm() / logits_ref.float().norm()).item()
    worst_leaf = max(leaf_rel, key=leaf_rel.get) if leaf_rel else None
    ok = (all(l == losses[0] for l in losses) and worst_leaf is not None
          and leaf_rel[worst_leaf] < leaf_bound)
    if f32:
        ok = ok and loss_abs < MESH_LOSS_ABS_F32 and worst_abs < MESH_PARAM_ABS_F32
    else:
        ok = ok and loss_rel < MESH_LOSS_REL_BF16 and gnorm_rel < MESH_GNORM_REL_BF16
    res = {"loss_mesh": losses[0], "loss_one_process": loss_ref,
           "ranks_losses_equal": all(l == losses[0] for l in losses), "loss_abs_err": loss_abs,
           "loss_rel_err": loss_rel, "grad_norm_mesh": gnorm,
           "grad_norm_one_process": steps_ref[0]["grad_norm"], "grad_norm_rel_err": gnorm_rel,
           "param_max_abs_err": worst_abs, "update_rel": update_rel,
           "worst_leaf_update_rel": [worst_leaf, leaf_rel.get(worst_leaf)],
           "leaves_held": len(leaf_rel), "prefill_logits_rel": logits_rel,
           "bounds": ({"loss_abs": MESH_LOSS_ABS_F32, "param_abs": MESH_PARAM_ABS_F32,
                       "leaf_update_rel": leaf_bound} if f32 else
                      {"loss_rel_of_first": MESH_LOSS_REL_BF16, "grad_norm_rel": MESH_GNORM_REL_BF16,
                       "leaf_update_rel": leaf_bound}),
           "one_process_step_ms": [s["ms"] for s in steps_ref]}
    if not ok or not all(math.isfinite(x) for x in losses[0]):
        raise AssertionError(f"mesh {job['name']}: against one process {res}")
    return res


def phase_mesh(torch, mods, device="cuda", small=False) -> dict:
    """granite-moe-1b-a400m and falcon-mamba-7b under the plans ``mcts_1s``
    picks for the H100 node (``hw="h100"``, mesh ``single``: 1 x 8), as 8
    ranks sharing the one card over gloo (``share_card=True``), each
    against one process on the card; then the int8 ring over the 8 ranks.
    No collective here runs over NVLink, and no time here is a node's.
    ``device="cpu", small=True`` rehearses it on the CPU (reduced configs,
    short sequences, the launch checks off)."""
    from repro_torch.core.space import get_mesh
    from repro_torch.launch.mesh import run_on_mesh

    spec = get_mesh("h100", "single")
    plans = {a: mods.autotune(a, "train_4k", algo="mcts_1s", hw="h100", mesh="single").plan
             for a in (TRAIN_ARCH, MAMBA_ARCH)}
    moe = plans[TRAIN_ARCH].to_dict()
    f32_tile = {"attn_block": (256, 256)}  # the plan's (256, 512) has no f32 flash build
    cut = dict(reduced=True, seq=64) if small else {}
    jobs = [
        dict(name="moe_f32_2l", arch=TRAIN_ARCH, layers=2, dtype="float32", seq=MESH_SEQ,
             plan={**moe, **f32_tile}),
        dict(name="moe_f32_2l_ep", arch=TRAIN_ARCH, layers=2, dtype="float32", seq=MESH_SEQ,
             plan={**moe, **f32_tile, "moe_mode": "ep"}),
        dict(name="moe_bf16_dense", arch=TRAIN_ARCH, layers=MESH_MOE_LAYERS, dtype="bfloat16",
             seq=MESH_SEQ, plan=moe),
        dict(name="moe_bf16_ep", arch=TRAIN_ARCH, layers=MESH_MOE_LAYERS, dtype="bfloat16",
             seq=MESH_SEQ, plan={**moe, "moe_mode": "ep"}),
        dict(name="mamba_bf16", arch=MAMBA_ARCH, layers=MAMBA_MESH_LAYERS, dtype="bfloat16",
             seq=MAMBA_MESH_SEQ, plan=plans[MAMBA_ARCH].to_dict()),
    ]
    jobs = [{**j, **cut} for j in jobs]
    out_dir = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    # eight allocators share the card: each rank's cached-but-free blocks
    # (1.2 GiB a rank without this, on the H100) would add up, so the ranks map memory
    # in growable segments (the ranks inherit this; this process's allocator
    # is already set up)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = run_on_mesh(spec, mesh_rank, jobs, str(out_dir), 1024 if small else RING_ELEMS,
                            device=device, share_card=True, timeout=900)
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ranks_s = time.perf_counter() - t0
    total = {n: 0 for n in KERNELS}
    refs, uses = {}, {}

    def ref_key(job):  # EP and dense: the one process runs them alike
        return (job["arch"], job["layers"], job["dtype"], job["seq"])

    for job in jobs:
        uses[ref_key(job)] = uses.get(ref_key(job), 0) + 1
    for job in jobs:
        name = job["name"]
        per_rank = [r["jobs"][name] for r in ranks]
        need = MESH_KERNELS[job["arch"]]
        for i, r in enumerate(per_rank):
            missing = [k for k in need if not r["launches"][k]] if device == "cuda" else []
            if missing or r["plain_attention_on_card"]:
                raise AssertionError(f"mesh {name} rank {i}: no launch of {missing}, "
                                     f"plain attention on the card {r['plain_attention_on_card']}")
            for k in KERNELS:
                total[k] += r["launches"][k]
        key = ref_key(job)
        if key not in refs:
            refs[key] = _mesh_reference(torch, mods, job, device)
        cmp = _mesh_compare(torch, job, ranks, refs[key], out_dir / f"{name}.pt")
        emit("mesh", job=name, arch=job["arch"], n_layers=job["layers"], dtype=job["dtype"],
             plan=job["plan"], batch=job["plan"]["microbatches"], seq=job["seq"], ranks=spec.size,
             backend=ranks[0]["backend"], device=ranks[0]["device"],
             moe_ep=per_rank[0]["moe_ep"], seq_split=per_rank[0]["seq_split"],
             launches_per_rank=[r["launches"] for r in per_rank],
             host_staged_per_rank=[r["host_staged"] for r in per_rank],
             step_ms_per_rank=[[s["ms"] for s in r["steps"]] for r in per_rank],
             prefill_ms_per_rank=[r["prefill_ms"] for r in per_rank],
             peak_gib_per_rank=[r["peak_gib"] for r in per_rank],
             local_params_per_rank=[r["local_params"] for r in per_rank],
             one_process=cmp,
             nvlink="not used: the 8 ranks share one card over gloo; no time here is a node's")
        uses[key] -= 1
        if not uses[key]:
            del refs[key]
        gc.collect()
    ring = [r["ring"] for r in ranks]
    for i, r in enumerate(ring):
        if (not r["equal_to_plain"] or r["rel_to_sum"] >= 0.05
                or (device == "cuda" and not r["launches"]["quantize_int8"])):
            raise AssertionError(f"mesh ring rank {i}: {r}")
        for k in KERNELS:
            total[k] += r["launches"][k]
    emit("mesh_ring", ranks=spec.size, elements=ring[0]["elements"], backend=ranks[0]["backend"],
         ms_per_rank=[r["ms"] for r in ring], rel_to_sum=[r["rel_to_sum"] for r in ring],
         equal_to_plain=True, launches_per_rank=[r["launches"] for r in ring],
         host_staged_per_rank=[r["host_staged"] for r in ring],
         nvlink="not used: the ring's hops are host-staged gloo sends between processes on one card")
    staged = {}
    for r in ranks:
        for j in list(r["jobs"].values()) + [r["ring"]]:
            for op, n in j["host_staged"].items():
                staged[op] = staged.get(op, 0) + n
    emit("mesh_summary", backend=ranks[0]["backend"], ranks=spec.size, ranks_seconds=ranks_s,
         host_staged_total=staged, launches_all_ranks=total,
         nvlink="no collective ran over NVLink: one card, 8 processes, gloo through host memory")
    return total


# ---------------------------------------------------------------------------
# mesh_decode: decode over the node's mesh, its ranks sharing the one card
# ---------------------------------------------------------------------------
# each job's cell: 16 rows over a cache of 8192 positions, built from the
# seed whole (one period's leaf at a time) and sharded by cache_pspecs;
# teacher-forced steps from two positions before the boundary of the 1 x 8
# mesh's position shards (8192 / 8)
MESH_DECODE_ROWS, MESH_DECODE_LEN, MESH_DECODE_STEPS = 16, 8192, 8
MESH_DECODE_START = MESH_DECODE_LEN // 8 - 2
# the depth cut: the phase's time beside the others (every layer adds two
# host-staged bf16 all-reduces a step on each of the 8 ranks)
MESH_DECODE_LAYERS = {"granite-3-2b": 8, "granite-moe-1b-a400m": 8, "falcon-mamba-7b": 8,
                      "stablelm-12b": 8}
MESH_DECODE_ARCHS = tuple(MESH_DECODE_LAYERS)
# logits against one process, each step, and the cache's written window
# (dequantized) after the last: relative norm of the difference.  f32 jobs
# do the one process's arithmetic up to the order of sums: exact up to
# rounding (NVIDIA H100 80GB HBM3, 700 W: 1.0e-5, the TP plan with an int8
# cache, and 0.0).  bf16 jobs drift by the order of sums alone: with the
# weights replicated, where only the softmax combine adds in another order,
# the logits moved 0.7e-2 to 1.9e-2 at 8 layers; the search's plans, whose
# TP partial sums are rounded to bf16 and added over 8 ranks, 1.7e-2 (the
# falcon-mamba plan) to 7.7e-2 (granite-moe's, EP, whose combine is bf16
# too); the cache windows 0.4e-2 to 1.9e-2.  Broken code is caught by the
# f32 jobs' bounds (scripts/torch_fault_check.py)
MESH_DECODE_REL = {"float32": 1e-3, "bfloat16": 1e-1}
MESH_DECODE_CACHE_REL = {"float32": 1e-3, "bfloat16": 5e-2}
MESH_DECODE_KERNELS = {"granite-3-2b": ("rmsnorm", "decode_attention"),
                       "granite-moe-1b-a400m": ("rmsnorm", "moe_gemm", "decode_attention"),
                       "falcon-mamba-7b": ("rmsnorm",),
                       "stablelm-12b": ("decode_attention",)}  # stablelm: layernorm


def _mesh_decode_setup(job):
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.space import SchedulePlan

    cfg = get_config(job["arch"])
    cfg = cfg.reduced() if job.get("reduced") else cfg
    cfg = dataclasses.replace(cfg, n_layers=job["layers"], dtype=job.get("dtype", cfg.dtype))
    return cfg, SchedulePlan.from_dict(job["plan"]), InputShape("mesh_decode", job["len"], job["rows"],
                                                                 "decode")


def _mesh_decode_inputs(torch, cfg, job, device):
    """Every step's tokens, positions and commit mask: a scalar position
    for the search's plans; per-row positions (up to three behind) and a
    row left out for the sequence-split ones."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 23)
    B = job["rows"]
    tok = torch.randint(0, cfg.vocab_size, (job["steps"], B, 1), generator=g).to(device)
    if job["per_row"]:
        start = job["start"] - torch.arange(B) % 4
        commit = (torch.arange(B) != 3).to(device)
    else:
        start, commit = torch.tensor(job["start"]), None
    return tok, [(start + t).to(device) for t in range(job["steps"])], commit


def _fill_decode_cache(torch, transformer, cfg, cache, par, job, kv_dtype) -> int:
    """Every leaf of ``cache`` (``par``'s shard, or whole on one device) from
    the seed: each period's whole leaf drawn on the card, this rank's shard
    kept.  Returns the whole cache's bytes."""
    from repro_torch.sharding.parallel import shard_leaf

    shapes = transformer.cache_shapes(cfg, job["rows"], job["len"], kv_dtype)
    whole_bytes = 0
    for bi, b in enumerate(sorted(cache)):
        for li, name in enumerate(sorted(cache[b])):
            leaf, shape = cache[b][name], shapes[b][name]
            spec = par.cache_spec(name, shape)
            whole_bytes += math.prod(shape) * leaf.element_size()
            for p in range(shape[0]):
                g = torch.Generator(device=leaf.device).manual_seed(SEED + 10_000 * bi + 100 * li + p)
                kw = dict(generator=g, device=leaf.device)
                if leaf.dtype == torch.int8:
                    whole = torch.randint(-127, 128, shape[1:], dtype=torch.int8, **kw)
                elif name in ("k_s", "v_s"):
                    whole = torch.rand(shape[1:], **kw) * 0.04 + 0.01
                else:
                    whole = torch.randn(shape[1:], **kw) * (0.1 if name == "ssm" else 0.5)
                leaf[p].copy_(shard_leaf(whole, spec[1:], par.mesh, name))
                del whole
    return whole_bytes


def _decode_window(job):
    """The global positions the check of the cache reads: the rows the run
    writes, with the ones just before them."""
    return job["start"] - 5, job["start"] + job["steps"]


def _cache_window(torch, cache, par, job) -> dict:
    """Of each attention leaf, the part of the written window this rank
    holds (on the host), with its first KV head and position in the
    window."""
    from repro_torch.sharding.rules import axes_of

    w0, w1 = _decode_window(job)
    out = {}
    for b, c in cache.items():
        if "k" not in c:
            continue
        H, L = c["k"].shape[2], c["k"].shape[3]
        h0 = par.mesh.index("model") * H if axes_of(par.kv[1]) else 0
        seq = axes_of(par.kv[2])
        o = par.mesh.index(seq) * L if seq else 0
        lo, hi = max(o, w0), min(o + L, w1)
        for name, leaf in c.items():
            if hi > lo:
                out[f"{b}.{name}"] = (leaf[:, :, :, lo - o:hi - o].to("cpu", copy=True), h0, lo - w0)
    return out


def _dequantized_window(torch, parts: dict, b: str):
    k, v = parts[f"{b}.k"].float(), parts[f"{b}.v"].float()
    if f"{b}.k_s" in parts:
        k, v = k * parts[f"{b}.k_s"], v * parts[f"{b}.v_s"]
    return torch.cat([k.flatten(), v.flatten()])


def _mesh_decode_rank_job(torch, mesh, job, out_dir):
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.sharding import collectives as cc
    from repro_torch.training.train_step import make_serve_step, shard_params

    cfg, plan, shape = _mesh_decode_setup(job)
    step = make_serve_step(cfg, shape, plan, mesh=mesh)
    par = step.par
    on_card = mesh.device.type == "cuda"
    params = None
    for r in range(mesh.spec.size):  # one rank at a time holds the whole weights
        if mesh.rank == r:
            full = transformer.init_params(cfg, SEED, device=mesh.device)
            params = shard_params(full, par)
            del full
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        dist.barrier()
    _sync(torch, mesh.device)
    base = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the weights' shards
    cache = transformer.init_cache(cfg, job["rows"], job["len"], plan.kv_dtype, device=mesh.device,
                                   par=par)
    whole_bytes = _fill_decode_cache(torch, transformer, cfg, cache, par, job, plan.kv_dtype)
    local_bytes = sum(t.numel() * t.element_size() for c in cache.values() for t in c.values())
    ref = torch.load(os.path.join(out_dir, job["name"] + ".pt"), weights_only=True)["logits"]
    tok, curs, commit = _mesh_decode_inputs(torch, cfg, job, mesh.device)
    _sync(torch, mesh.device)
    ops.reset_counters()
    cc.reset_host_staged()
    errs, ms = [], []
    for t in range(job["steps"]):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok[t], curs[t], commit)
        _sync(torch, mesh.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        got = logits.float().cpu()
        errs.append(((got - ref[t]).norm() / ref[t].norm()).item()
                    if torch.isfinite(got).all() else math.inf)
    counts, staged = ops.launch_counts(), dict(cc.HOST_STAGED)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window = _cache_window(torch, cache, par, job)
    del params, cache, logits, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"rel_err": errs, "ms": ms, "launches": counts, "host_staged": staged,
            "peak_gib": peak / 2**30, "peak_above_weights_gib": (peak - base) / 2**30 if on_card else 0,
            "cache_local_gib": local_bytes / 2**30, "cache_whole_gib": whole_bytes / 2**30,
            "kv": list(par.kv), "window": window}


def mesh_decode_rank(mesh, jobs, out_dir):
    """What each rank of the mesh_decode phase runs (``run_on_mesh``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 jobs in true f32, as the one process
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": mesh.backend, "device": str(mesh.device), "jobs": {}}
    for job in jobs:
        t0 = time.perf_counter()
        out["jobs"][job["name"]] = _mesh_decode_rank_job(torch, mesh, job, out_dir)
        if mesh.rank == 0:
            print(json.dumps({"phase": "mesh_decode_progress", "job": job["name"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return out


def _mesh_decode_reference(torch, mods, job, device, out_dir) -> dict:
    """One process on the card from the same seed's weights and cache: each
    step's logits (f32, on the host) and the cache's written window, saved
    for the ranks and the check."""
    cfg, plan, shape = _mesh_decode_setup(job)
    params = mods.transformer.init_params(cfg, SEED, device=device)
    step = mods.make_serve_step(cfg, shape, plan, device=device)
    cache = mods.transformer.init_cache(cfg, job["rows"], job["len"], plan.kv_dtype, device=device)
    _fill_decode_cache(torch, mods.transformer, cfg, cache, step.par, job, plan.kv_dtype)
    tok, curs, commit = _mesh_decode_inputs(torch, cfg, job, device)
    logits, ms = [], []
    for t in range(job["steps"]):
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tok[t], curs[t], commit)
        _sync(torch, device)
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.float().cpu())
    window = {k: v[0] for k, v in _cache_window(torch, cache, step.par, job).items()}
    torch.save({"logits": torch.stack(logits), "window": window},
               os.path.join(out_dir, job["name"] + ".pt"))
    del params, cache, lg, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"ms": ms}


def _window_rel(torch, job, per_rank, ref_window) -> float:
    """The written window assembled from every rank's parts against one
    process's: relative norm of the dequantized K and V."""
    whole = {k: torch.zeros_like(v) for k, v in ref_window.items()}
    for r in per_rank:
        for k, (part, h0, p0) in r["window"].items():
            whole[k][:, :, h0:h0 + part.shape[2], p0:p0 + part.shape[3]] = part
    blocks = sorted({k.split(".")[0] for k in whole})
    if not blocks:
        return 0.0
    got = torch.cat([_dequantized_window(torch, whole, b) for b in blocks])
    exp = torch.cat([_dequantized_window(torch, ref_window, b) for b in blocks])
    return ((got - exp).norm() / exp.norm()).item()


def mesh_decode_jobs(mods, small: bool = False) -> list:
    """The phase's jobs: each arch under its ``decode_32k`` plan, and
    granite-3-2b with the cache split by position, bf16 and int8."""
    plans = {a: mods.autotune(a, "decode_32k", algo="mcts_1s", hw="h100", mesh="single").plan.to_dict()
             for a in MESH_DECODE_ARCHS}
    seq = {**mods.SchedulePlan().to_dict(), "param_strategy": "replicated", "seq_shard": True}
    cell = dict(rows=MESH_DECODE_ROWS, len=MESH_DECODE_LEN, steps=MESH_DECODE_STEPS,
                start=MESH_DECODE_START)
    if small:
        cell = dict(cell, reduced=True, len=64, rows=8, start=64 // 8 - 2)
    jobs = [dict(name=a, arch=a, layers=MESH_DECODE_LAYERS[a], plan=plans[a], per_row=False, **cell)
            for a in MESH_DECODE_ARCHS]
    jobs += [dict(name=f"granite_seq_{kv}", arch="granite-3-2b", plan={**seq, "kv_dtype": kv},
                  layers=MESH_DECODE_LAYERS["granite-3-2b"], per_row=True, **cell)
             for kv in ("bf16", "int8")]
    # the same layouts in f32, held to one process up to rounding
    jobs += [dict(j, name=j["name"] + "_f32", dtype="float32") for j in jobs
             if j["arch"] in ("granite-3-2b", "falcon-mamba-7b")]
    if small:
        for j in jobs:
            j["layers"] = len(mods.get_config(j["arch"]).layer_plan()) * 2
    return jobs


def phase_mesh_decode(torch, mods, device="cuda", small=False, jobs=None) -> dict:
    """Decode over the H100 node's mesh (1 x 8) as 8 ranks sharing the one
    card over gloo: ``mesh_decode_jobs``' granite-3-2b,
    granite-moe-1b-a400m, falcon-mamba-7b and stablelm-12b (head_dim 160)
    under the plans ``mcts_1s`` picks for ``decode_32k`` (``hw="h100"``,
    mesh ``single``), and granite-3-2b with its cache split by position
    (``replicated``, ``seq_shard``), bf16 and int8; and the granite-3-2b
    and falcon-mamba-7b jobs again in f32.  Each job against one process on
    the card: the logits at every step and the cache's written window after
    the last (relative norms within ``MESH_DECODE_REL`` and
    ``MESH_DECODE_CACHE_REL`` of the model's dtype); every rank's launches
    (non-zero for the path's kernels, equal across ranks), host-staged
    collectives a step, step ms (a rank on a shared card, not a node's) and
    peak (what the cache's build and the steps add to the weights' shards:
    below one whole cache).  Every job is reported before a failure raises.
    ``device="cpu", small=True`` rehearses it on the CPU (reduced configs,
    a short cache, the launch and memory checks off)."""
    from repro_torch.core.space import get_mesh
    from repro_torch.launch.mesh import run_on_mesh

    spec = get_mesh("h100", "single")
    jobs = jobs or mesh_decode_jobs(mods, small)
    out_dir = ROOT / "build" / "chip_smoke_mesh_decode"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    refs = {j["name"]: _mesh_decode_reference(torch, mods, j, device, str(out_dir)) for j in jobs}
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = run_on_mesh(spec, mesh_decode_rank, jobs, str(out_dir), device=device,
                            share_card=True, timeout=900)
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ranks_s = time.perf_counter() - t0
    total = {n: 0 for n in KERNELS}
    failed = []
    for job in jobs:
        name = job["name"]
        per_rank = [r["jobs"][name] for r in ranks]
        dtype = _mesh_decode_setup(job)[0].dtype
        bound, cache_bound = MESH_DECODE_REL[dtype], MESH_DECODE_CACHE_REL[dtype]
        ref = torch.load(out_dir / f"{name}.pt", weights_only=True)
        cache_rel = _window_rel(torch, job, per_rank, ref["window"])
        int8 = job["plan"]["kv_dtype"] == "int8"
        need = MESH_DECODE_KERNELS[job["arch"]] + (("quantize_int8",) if int8 else ())
        for i, r in enumerate(per_rank):
            missing = [k for k in need if not r["launches"][k]] if device == "cuda" else []
            if missing or r["launches"] != per_rank[0]["launches"]:
                failed.append(f"{name} rank {i}: no launch of {missing}, launches {r['launches']} "
                              f"against rank 0's {per_rank[0]['launches']}")
            if not max(r["rel_err"]) <= bound:
                failed.append(f"{name} rank {i}: logits error {r['rel_err']} (bound {bound})")
            if device == "cuda" and not r["peak_above_weights_gib"] < r["cache_whole_gib"]:
                failed.append(f"{name} rank {i}: peak {r['peak_above_weights_gib']} GiB above the "
                              f"weights, not below one whole cache ({r['cache_whole_gib']} GiB)")
            for k in KERNELS:
                total[k] += r["launches"][k]
        if not cache_rel <= cache_bound:
            failed.append(f"{name}: the cache's written window {cache_rel} from one process's "
                          f"(bound {cache_bound})")
        emit("mesh_decode", job=name, arch=job["arch"], n_layers=job["layers"], dtype=dtype,
             plan=job["plan"], rows=job["rows"],
             cache_len=job["len"], steps=job["steps"], start=job["start"], per_row_cur=job["per_row"],
             ranks=spec.size, backend=ranks[0]["backend"], kv_spec=per_rank[0]["kv"],
             rel_err_per_rank=[r["rel_err"] for r in per_rank],
             worst_rel_err=max(max(r["rel_err"]) for r in per_rank), bound=bound,
             cache_window_rel=cache_rel, cache_bound=cache_bound,
             launches_per_rank=[r["launches"] for r in per_rank],
             host_staged_per_step_per_rank=[{op: n / job["steps"] for op, n in r["host_staged"].items()}
                                            for r in per_rank],
             step_ms_per_rank=[r["ms"] for r in per_rank], one_process_step_ms=refs[name]["ms"],
             peak_gib_per_rank=[r["peak_gib"] for r in per_rank],
             peak_above_weights_gib_per_rank=[r["peak_above_weights_gib"] for r in per_rank],
             cache_local_gib=per_rank[0]["cache_local_gib"],
             cache_whole_gib=per_rank[0]["cache_whole_gib"],
             nvlink="not used: the 8 ranks share one card over gloo; a step's ms is a rank's on a "
                    "shared card, not a node's")
    emit("mesh_decode_summary", ranks=spec.size, ranks_seconds=ranks_s, launches_all_ranks=total)
    if failed:
        raise AssertionError("mesh_decode: " + "; ".join(failed))
    return total

# the dry run's card check: granite-moe-1b-a400m's programs at the card
# measurement's cut (6 of 24 layers, core/measure.CUT_ROWS rows), by shape
# and plan: both remat policies' train steps (all five of its kernels under
# the first), a 1 x 32,768 prefill and a 16-row decode over an int8 cache
DRYRUN_CARD_PROGRAMS = (
    ("train_4k", dict(remat="full", microbatches=2, opt_dtype="int8", grad_comm="int8")),
    ("train_4k", dict(remat="dots", microbatches=2)),
    ("prefill_32k", {}),
    ("decode_32k", dict(kv_dtype="int8")),
)
DRYRUN_PEAK_REL = 0.10  # the dry run's peak against torch.cuda.max_memory_allocated
# the production-mesh records, full config at full depth, each mesh of the
# H100 (the 1 x 8 node and two of them); and the other cut archs on the node
DRYRUN_CELLS = tuple((a, s, m) for a, s in (("granite-moe-1b-a400m", "train_4k"),
                                           ("deepseek-67b", "train_4k"), ("deepseek-67b", "prefill_32k"),
                                           ("stablelm-12b", "train_4k"))
                     for m in ("single", "multi")) + (
    ("qwen2-vl-72b", "prefill_32k", "single"), ("falcon-mamba-7b", "train_4k", "single"))
DRYRUN_TIMEOUT_S = 600
# what every dry-run record must hold (launch/dryrun_impl.py)
DRYRUN_RECORD_FIELDS = frozenset({
    "arch", "shape", "mesh", "plan", "hw", "source", "chips", "rank", "step_s", "compute_s",
    "memory_s", "collective_s", "dominant", "flops_per_device", "dot_flops_per_device",
    "flops_total", "hbm_bytes_total", "coll_bytes_per_chip", "coll_wire_bytes_per_chip",
    "coll_by_kind", "coll_counts", "memory", "bytes_per_device", "fits_hbm", "launches",
    "model_flops", "useful_flops_ratio", "mfu"})


def _cut_program(mods, shape_name: str, plan_kw: dict):
    """(config, input shape, plan) of granite-moe's program at the card
    measurement's cut, as ``launch/measure.evaluate_cell`` builds it."""
    from repro_torch.configs import get_shape

    cfg = dataclasses.replace(mods.get_config(TRAIN_ARCH), n_layers=mods.quickstart.MEASURE_LAYERS)
    shape = get_shape(shape_name)
    rows = mods.measure.CUT_ROWS[shape.kind]
    plan = mods.SchedulePlan(**plan_kw)
    plan = dataclasses.replace(plan, microbatches=min(plan.microbatches, rows))
    return cfg, mods.InputShape(f"{shape_name}-cut", shape.seq_len, rows, shape.kind), plan


def _card_program(torch, np, mods, cfg, shape, plan) -> dict:
    """One real run of the program on the card after a warm-up step, under
    ``FlopCounterMode`` and the launch counters, its peak memory from a reset
    just before it; then three runs timed without the counter."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device("cuda")
    kind, rows, seq = shape.kind, shape.global_batch, shape.seq_len
    rng = np.random.default_rng(SEED)
    params = mods.transformer.init_params(cfg, SEED, device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, 1 if kind == "decode" else seq)))
    tokens = tokens.to(dev)
    if kind == "train":
        oc = mods.optim.OptimizerConfig(peak_lr=0.0, moment_dtype=plan.opt_dtype)
        state = {"opt": mods.optim.init_opt_state(params, oc)}
        batch = {"inputs": tokens, "labels": tokens,
                 "positions": mods.make_positions(cfg, rows, seq, device=dev)}
        step = mods.make_train_step(cfg, shape, plan, oc, device=dev)

        def run():
            _, state["opt"], _ = step(params, state["opt"], batch)
    elif kind == "prefill":
        batch = {"inputs": tokens, "positions": mods.make_positions(cfg, rows, seq, device=dev)}
        step = mods.make_prefill_step(cfg, shape, plan, device=dev)

        def run():
            step(params, batch)
    else:
        cache = mods.transformer.init_cache(cfg, rows, seq, kv_dtype=plan.kv_dtype, device=dev)
        step = mods.make_serve_step(cfg, shape, plan, device=dev)

        def run():
            step(params, cache, tokens, seq - 1)
    run()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    mods.ops.reset_counters()
    flops = FlopCounterMode(display=False)
    with flops:
        run()
    torch.cuda.synchronize()
    out = {"launches": mods.ops.launch_counts(), "flops": flops.get_total_flops(),
           "peak_bytes": torch.cuda.max_memory_allocated(), "allocated_before": resident}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["step_ms"] = statistics.median(times) * 1e3
    out["step_runs_ms"] = [t * 1e3 for t in times]
    return out


def _dryrun_subprocesses(out_dir: Path):
    """One ``python -m repro_torch.launch.dryrun`` a cell of ``DRYRUN_CELLS``,
    all started at once with no card visible (a dry run is the host's:
    meta tensors, no device)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        out = out_dir / f"{arch}_{shape}_{mesh}.json"
        procs[(arch, shape, mesh)] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--hw", "h100", "--json-out", str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def phase_dryrun(torch, np, mods) -> dict:
    """The production-mesh dry run (``launch/dryrun_impl.py``).  (a) The
    card's check: each of ``DRYRUN_CARD_PROGRAMS`` run for real on the card
    and dry on the meta device must give exactly equal launches by kernel
    and ``FlopCounterMode`` FLOPs (the aten products: the kernels are no
    aten op on the card), and a peak within ``DRYRUN_PEAK_REL`` of
    ``torch.cuda.max_memory_allocated``; the measured step beside the dry
    run's roofline ``step_s`` (their ratio recorded, not asserted).  (b)
    ``DRYRUN_CELLS``' records at full depth on the H100's meshes, one
    subprocess each, started together after (a): every field, and what a
    rank holds beside the card's memory.  Returns the real runs' launches."""
    from repro_torch.core.space import ONE_CARD
    from repro_torch.launch import dryrun_impl

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    checks, failed = [], []
    launches = {n: 0 for n in KERNELS}
    for shape_name, plan_kw in DRYRUN_CARD_PROGRAMS:
        cfg, shape, plan = _cut_program(mods, shape_name, plan_kw)
        real = _card_program(torch, np, mods, cfg, shape, plan)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dry = dryrun_impl.dry_run(cfg, shape, plan, ONE_CARD, hw="h100", local=True)
        dry_s = time.perf_counter() - t0
        for n in KERNELS:
            launches[n] += real["launches"][n]
        peak_rel = dry["memory"]["peak_bytes"] / real["peak_bytes"] - 1.0
        what = f"{shape_name} {plan_kw}"
        if dry["launches"] != real["launches"]:
            failed.append(f"{what}: launches dry {dry['launches']} card {real['launches']}")
        if dry["aten_flops_per_device"] != real["flops"]:
            failed.append(f"{what}: FLOPs dry {dry['aten_flops_per_device']} card {real['flops']}")
        if abs(peak_rel) > DRYRUN_PEAK_REL:
            failed.append(f"{what}: peak dry {dry['memory']['peak_bytes']} card {real['peak_bytes']}")
        checks.append({
            "program": what, "layers": cfg.n_layers, "rows": shape.global_batch, "seq": shape.seq_len,
            "launches": real["launches"], "launches_equal": dry["launches"] == real["launches"],
            "flops_card": real["flops"], "flops_dry": dry["aten_flops_per_device"],
            "kernel_flops_dry": dry["kernel_flops_per_device"],
            "peak_gib_card": real["peak_bytes"] / 2**30,
            "peak_gib_dry": dry["memory"]["peak_bytes"] / 2**30, "peak_rel": peak_rel,
            "resident_gib_dry": dry["memory"]["resident_bytes"] / 2**30,
            "allocated_before_gib_card": real["allocated_before"] / 2**30,
            "step_ms_card": real["step_ms"], "step_runs_ms_card": real["step_runs_ms"],
            "step_ms_dry": dry["step_s"] * 1e3, "dominant_dry": dry["dominant"],
            "card_over_dry_step": real["step_ms"] / (dry["step_s"] * 1e3), "dryrun_s": dry_s})
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = _dryrun_subprocesses(out_dir)
    records = []
    try:
        for (arch, shape, mesh), (out, proc) in procs.items():
            _, err = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
            if proc.returncode != 0:
                raise AssertionError(f"dryrun {arch} x {shape} x {mesh}: exit {proc.returncode}\n"
                                     f"{err[-3000:]}")
            rec = json.loads(out.read_text())
            missing = DRYRUN_RECORD_FIELDS - set(rec)
            # what the step's prefill or training launches (decode: the plain attention and scan)
            kernels = (set() if rec["shape"].startswith("decode") else
                       {"flash_attention"} if mods.get_config(arch).n_heads else {"selective_scan"})
            if missing or rec["source"] != "dryrun" or not all(rec["launches"][k] for k in kernels):
                raise AssertionError(f"dryrun {arch} x {shape} x {mesh}: missing {missing}, "
                                     f"launches {rec['launches']}")
            mem = rec["memory"]
            records.append({
                "arch": arch, "shape": shape, "mesh": mesh, "chips": rec["chips"],
                "layers": mods.get_config(arch).n_layers, "plan": rec["plan"],
                "resident_gib": mem["resident_bytes"] / 2**30, "peak_gib": mem["peak_bytes"] / 2**30,
                "params_gib": mem["params_bytes"] / 2**30, "opt_state_gib": mem["opt_state_bytes"] / 2**30,
                "fits_hbm": rec["fits_hbm"], "flops_per_device": rec["flops_per_device"],
                "dot_flops_per_device": rec["dot_flops_per_device"],
                "hbm_bytes_total": rec["hbm_bytes_total"], "coll_bytes_per_chip": rec["coll_bytes_per_chip"],
                "coll_by_kind": rec["coll_by_kind"], "compute_ms": rec["compute_s"] * 1e3,
                "memory_ms": rec["memory_s"] * 1e3, "collective_ms": rec["collective_s"] * 1e3,
                "step_ms": rec["step_s"] * 1e3, "dominant": rec["dominant"], "mfu": rec["mfu"],
                "launches": {k: v for k, v in rec["launches"].items() if v},
                "dryrun_s": rec["dryrun_s"]})
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    records_s = time.perf_counter() - t0
    emit("dryrun", card_check=checks, card_launches=launches, records=records,
         records_wall_s=records_s, seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError("dryrun: " + "; ".join(failed))
    return launches


def _summary_row(n: str, rows: list, launches: int) -> dict:
    """One kernel's entry of the ``kernels`` line; for the int8 pair, from the
    quantize phase's rows (``dequant_*`` fields for the dequantize)."""
    src, replaces = SOURCES[n]
    head = {"name": n, "route": "cuda", "source": src, "replaces": replaces, "launches": launches}
    timed_rows = [r for r in rows if "ms" in r and r.get("main_path", True)]
    if n in ("quantize_int8", "dequantize_int8"):
        pre = "" if n == "quantize_int8" else "dequant_"
        err = (lambda r: 0.0) if n == "quantize_int8" else (  # q and scale bit-equal
            lambda r: max(r["dequant_float32_max_abs_err"], r["dequant_bfloat16_max_abs_err"]))
        main_shapes = [{"shape": r["shape"], "dtype": r["dtype"], "role": r["role"],
                        "max_abs_err": err(r), **({} if pre else {"regime": r["regime"]}),
                        **{k: r[pre + k] for k in (
                            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                       for r in timed_rows]
        return {**head, **main_shapes[0], "max_abs_err": max(err(r) for r in rows),
                "main_path_shapes": main_shapes}
    row = timed_rows[0]  # the main path's first shape
    return {
        **head, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "main_max_abs_err": row["max_abs_err"], "main_mean_abs_exp": row["mean_abs_exp"],
        "main_rel_err": row["rel_err"], **{k: row.get(k) for k in _SUMMARY_KEYS if k != "max_abs_err"},
        "main_path_shapes": [{k: r.get(k) for k in _SUMMARY_KEYS} for r in timed_rows],
    }


def make_mods():
    """The port's modules the phases use (``src`` on ``sys.path``)."""
    import types

    from repro_torch.configs import InputShape, get_config
    from repro_torch.core import measure
    from repro_torch import device
    from repro_torch.core.autotuner import autotune, make_mdp
    from repro_torch.core.cost_model import JIT_MIN_BATCH
    from repro_torch.core.engine import CachedMDP, PinnedWorkerPool, make_cost_backend
    from repro_torch.core.hardware import H100
    from repro_torch.core.measure_fleet import MeasurementFleet
    from repro_torch.core.space import SchedulePlan, attn_block_options
    from repro_torch.kernels import geometry, ops
    from repro_torch.launch import quickstart
    from repro_torch.launch.measure import CardTarget
    from repro_torch.models import moe, transformer
    from repro_torch.models.losses import cross_entropy
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import optimizer as optim
    from repro_torch.training.train_step import (
        make_positions, make_prefill_step, make_serve_step, make_train_step, tiles_from_plan,
    )
    from repro_torch.training.trainer import Trainer, TrainerConfig

    return types.SimpleNamespace(
        get_config=get_config, ops=ops, transformer=transformer, ServingEngine=ServingEngine,
        make_prefill_step=make_prefill_step, make_serve_step=make_serve_step,
        make_train_step=make_train_step,
        make_positions=make_positions, tiles_from_plan=tiles_from_plan, moe=moe, optim=optim,
        cross_entropy=cross_entropy, InputShape=InputShape, Trainer=Trainer,
        TrainerConfig=TrainerConfig, SchedulePlan=SchedulePlan, quickstart=quickstart,
        geometry=geometry, H100=H100, attn_block_options=attn_block_options, autotune=autotune,
        measure=measure, MeasurementFleet=MeasurementFleet, CardTarget=CardTarget,
        make_mdp=make_mdp, JIT_MIN_BATCH=JIT_MIN_BATCH, CachedMDP=CachedMDP,
        PinnedWorkerPool=PinnedWorkerPool, make_cost_backend=make_cost_backend, device=device,
    )


def main() -> int:
    # segments that grow in place: stablelm-12b's full-depth training peaks
    # at ~72 GiB, and with fixed segments the card ran out of memory for a
    # 5.27 GiB gradient while 9.85 GiB sat reserved in pieces (set before
    # the first allocation, which reads it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import quantize as qt
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import selective_scan as ss

    mods = make_mods()
    get_config, SchedulePlan = mods.get_config, mods.SchedulePlan
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
    _build.build(LIBRARIES)
    ptxas = {n: ptxas_lines(_build.ptxas_report(n)) for n in LIBRARIES}
    # the TMA -> wgmma kernels: registers and spill bytes of every instantiation
    bf16 = [k for n in ("flash_attention", "flash_attention_backward", "moe_gemm") for k in ptxas[n]
            if "bf16" in k["kernel"]]
    emit("build", seconds=time.perf_counter() - t0, flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas,
         bf16_registers={k["kernel"]: k.get("registers") for k in bf16},
         bf16_spill_bytes={k["kernel"]: k.get("spill_stores", 0) + k.get("spill_loads", 0) for k in bf16})
    spilled = [k["kernel"] for k in bf16 if k.get("spill_stores", 0) + k.get("spill_loads", 0)]
    if not bf16 or spilled:
        raise AssertionError(f"bf16 wgmma kernels spill registers: {spilled or 'none found in ptxas'}")
    # the backward at head_dim 160 (bf16 and f32): four instantiations, none spilling
    bwd160 = [k for k in ptxas["flash_attention_backward"] if k["kernel"].endswith("<160>")]
    emit("build_backward_160", registers={k["kernel"]: k.get("registers") for k in bwd160},
         spill_bytes={k["kernel"]: k.get("spill_stores", 0) + k.get("spill_loads", 0) for k in bwd160})
    if len(bwd160) != 4 or any(k.get("spill_stores", 0) + k.get("spill_loads", 0) for k in bwd160):
        raise AssertionError(f"flash backward at head_dim 160: {bwd160}")

    phase_s = {"build": time.perf_counter() - t0}
    # the train phase's jobs: name -> (arch, batch, plan); plan (a) runs all
    # five of granite-moe's kernels, (b) has f32 moments; falcon-mamba-7b
    # puts the scan's backward and stablelm-12b the flash backward at
    # head_dim 160 on the main path (layernorm: no rmsnorm launches).  Their
    # dry-run peaks are counted on the host meanwhile
    train_jobs = {
        "a": (TRAIN_ARCH, 2, SchedulePlan(remat="full", microbatches=2, opt_dtype="int8", grad_comm="int8")),
        "b": (TRAIN_ARCH, 2, SchedulePlan(remat="dots", microbatches=2)),
        "mamba": (MAMBA_ARCH, 1, SchedulePlan(**TRAIN_PLANS[MAMBA_ARCH])),
        "stablelm": (STABLELM_ARCH, 1, SchedulePlan(**TRAIN_PLANS[STABLELM_ARCH])),
    }
    train_dry = TrainDryRuns({n: (a, b, p.to_dict(), None) for n, (a, b, p) in train_jobs.items()})
    atexit.register(train_dry.close)

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t
        return out

    rows = {
        "rmsnorm": timed_phase("kernels", phase_kernels_rmsnorm, torch, F, rn),
        "flash_attention": timed_phase("kernels", phase_kernels_flash, torch, F, fa),
        "moe_gemm": timed_phase("kernels", phase_kernels_moe, torch, F, mg),
        "selective_scan": timed_phase("kernels", phase_kernels_scan, torch, F, ss),
    }
    rows["quantize_int8"] = rows["dequantize_int8"] = timed_phase(
        "kernels", phase_kernels_quantize, torch, qt, quantize_moment_rows(mods))
    rows["decode_attention"] = timed_phase("kernels", phase_kernels_decode_attention, torch, da)
    rows.update(timed_phase("grad", phase_grad, torch, rn, fa, mg, ss))

    plans = {
        "granite-3-2b": [SchedulePlan(), SchedulePlan(attn_block=(128, 128))],
        "granite-moe-1b-a400m": [SchedulePlan()],
        "falcon-mamba-7b": [SchedulePlan(), SchedulePlan(scan_chunk=64)],
    }
    launches = {n: 0 for n in KERNELS}

    def add(counts):
        for n in KERNELS:
            launches[n] += counts[n]

    for arch in ARCHS:
        for counts in timed_phase(f"serving {arch}", run_path, torch, np, arch, plans[arch], mods):
            add(counts)
        gc.collect()  # the engine holds its weights in a reference cycle
        torch.cuda.empty_cache()
    # model coverage: five more archs at full width, deepseek-67b and
    # qwen2-vl-72b at a depth cut; at head_dim 128 and 160 every tile that
    # launches (the JAX default (256, 256) does not: 640 threads), at 64 the
    # default and (128, 128)
    timed_phase("positions", phase_positions, torch, mods)

    def coverage_plans(arch):
        hd = get_config(arch).resolved_head_dim
        if hd == 64:
            return [SchedulePlan(), SchedulePlan(attn_block=(128, 128))]
        return [SchedulePlan(attn_block=t) for t in mods.geometry.launchable_attn_blocks(hd, "bfloat16")]

    for arch in COVERAGE_TOKEN_ARCHS:
        for counts in timed_phase(f"coverage {arch}", run_path, torch, np, arch, coverage_plans(arch),
                                  mods, CUT_LAYERS.get(arch)):
            add(counts)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in COVERAGE_EMBED_ARCHS:
        add(timed_phase(f"coverage {arch}", phase_embeddings_path, torch, np, arch,
                        coverage_plans(arch), mods))
    # training at full width and depth
    must_launch = {"a": ("quantize_int8", "dequantize_int8", "moe_gemm"),
                   "mamba": ("selective_scan", "selective_scan_backward", "rmsnorm_backward"),
                   "stablelm": ("flash_attention", "flash_attention_backward", "quantize_int8")}
    for name, (arch, batch, plan) in train_jobs.items():
        counts = timed_phase("train", phase_train, torch, name, plan, mods, arch, batch, None,
                             train_dry.peak(name))
        if not all(counts[n] for n in must_launch.get(name, ())):
            raise AssertionError(f"train {name} ({arch}) launched {counts}")
        add(counts)
    train_dry.close()
    # the quickstart: tune on the host, then train and serve with the tuned plan
    res, tuned_row = timed_phase("search", phase_search, torch, F, fa, mods)
    rows["flash_attention"].append(tuned_row)
    add(timed_phase("quickstart", phase_quickstart, torch, np, mods, res))
    # the int8 KV cache on the measurement's decode cut, then the measured search
    decode_counts = timed_phase("decode_int8", phase_decode_int8, torch, np, mods)
    if not decode_counts["quantize_int8"]:
        raise AssertionError("the int8 decode launched no quantize_int8 kernel")
    add(decode_counts)
    # the serve step's CUDA graph at the benchmark cells' shapes
    add(timed_phase("serve_graph", phase_serve_graph, torch, np, mods))
    counts, records, measure_res, measure_cache, cut = timed_phase(
        "measure", phase_measure, torch, np, mods, res)
    add(counts)
    # the compiled pricing path, learned-cost serving and the tuner daemon
    timed_phase("jit_pricing", phase_jit_pricing, torch, np, mods)
    timed_phase("learned", phase_learned, torch, np, mods, records)
    timed_phase("service", phase_service, torch, mods, res, measure_res, measure_cache, cut)
    # distribution: the H100 node's mesh as 8 ranks on the one card
    add(timed_phase("mesh", phase_mesh, torch, mods))
    add(timed_phase("mesh_decode", phase_mesh_decode, torch, mods))
    for n in KERNELS:
        if launches[n] == 0:
            raise AssertionError(f"the main paths launched no {n} kernel")
    emit("work_check", cases=WORK_CHECKS)
    # the production-mesh dry run: its card check and records (its real
    # runs' launches on its own line, apart from the main paths')
    timed_phase("dryrun", phase_dryrun, torch, np, mods)

    # 320 tokens: scan_chunk 64 divides them (JAX's divisibility)
    parity_plans = {"granite-3-2b": SchedulePlan(), "granite-moe-1b-a400m": SchedulePlan(),
                    "falcon-mamba-7b": SchedulePlan(scan_chunk=64),
                    # in f32 at head_dim 160 and 128 only (128, 128) of the JAX tiles launches
                    "stablelm-12b": SchedulePlan(attn_block=(128, 128)),
                    "qwen2-vl-72b": SchedulePlan(attn_block=(128, 128))}
    for arch in parity_plans:
        timed_phase("parity", phase_parity, torch, np, get_config(arch), parity_plans[arch], ops,
                    mods.transformer, mods.moe, mods.make_positions, mods.tiles_from_plan)
    timed_phase("parity", phase_embed_decode_parity, torch, np, mods)
    timed_phase("train_parity", phase_train_parity, torch, np, mods)
    timed_phase("train_parity", phase_train_parity, torch, np, mods, MAMBA_ARCH, 320,
                SchedulePlan(scan_chunk=64))
    # head_dim 160 in f32: (128, 128) is the one JAX tile the f32 forward
    # launches there.  The int8 optimizer step, the same code for every
    # arch, is held by the two runs above: over stablelm's 1.58 B f32
    # parameters on the host it would add minutes to the script
    timed_phase("train_parity", phase_train_parity, torch, np, mods, STABLELM_ARCH, 512,
                SchedulePlan(attn_block=(128, 128)), False)
    emit("phase_seconds", seconds=phase_s, total_s=time.perf_counter() - T_START)

    summary = [_summary_row(n, rows[n], launches[n]) for n in KERNELS]
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
