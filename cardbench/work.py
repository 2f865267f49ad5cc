"""The yardstick's arithmetic: a kernel call's work, a model step's work, and
the peaks the shares divide by.

**Kernels.**  A frozen copy of the program's work formulas
(``src/repro_torch/kernels/work.py`` as it stood when the benchmark was
written; ``tests/test_cardbench_work.py`` holds the two equal at both
cells' shapes): the operations a call performs and the bytes it must move,
each input read once and each output written once.

**Model steps.**

* ``train_flops``: ``6 x (the parameters that multiply) x tokens``, the
  usual count of a training step's products (2 forward, 4 backward);
  recompute is not counted, nor the embedding lookup, nor the scan's
  elementwise recurrence.  The parameters that multiply are the leaves of
  two or more axes that enter a product: the mixers' projections and
  depthwise conv taps, the MLPs' and experts' matrices (the experts a token
  is routed to only), and the output head (the tied table where tied).
* ``decode_work``: one decode step of ``rows`` slots at the given cache
  positions: products ``2 x (active parameters that multiply) x rows`` plus
  attention's ``4 x head_dim x (positions seen) x q-heads`` a row; bytes:
  every weight read once (of an untied embedding table, the rows looked
  up), each slot's cache read up to its own position
  in the cache's dtype (int8 codes and float32 scales, or bfloat16), the
  new K/V rows written, the logits written.

**Peaks** of one NVIDIA H100 SXM (data sheet, dense, at 700 W): 989e12
FLOP/s bf16 on the tensor cores, 67e12 FLOP/s float32 outside them,
3.35e12 B/s of HBM3.  A share is stated beside the card's ``power.limit``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_OPS = {"bfloat16": PEAK_BF16, "float32": PEAK_F32}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    ops_dtype: str  # "bfloat16" (tensor cores) or "float32"


def bound_s(work: Work) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time a card could take."""
    t_bytes = work.bytes / HBM_BYTES_PER_S
    t_ops = work.flops / PEAK_OPS[work.ops_dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _esize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype]


# ---------------------------------------------------------------------------
# Kernels: a frozen copy of the program's formulas
# ---------------------------------------------------------------------------
def visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    if not causal:
        return Sq * Skv
    if Sq <= Skv:
        return Sq * (Skv - Sq) + Sq * (Sq + 1) // 2
    return Skv * (Skv + 1) // 2


def rmsnorm(n: int, d: int, dtype: str) -> Work:
    e = _esize(dtype)
    return Work(4 * n, 2 * n * e + d * e, "float32")


def rmsnorm_backward(n: int, d: int, dtype: str) -> Work:
    e = _esize(dtype)
    return Work(10 * n, 3 * n * e + 2 * d * e, "float32")


def flash_attention(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int, dtype: str,
                    causal: bool = True, with_lse: bool = False) -> Work:
    e = _esize(dtype)
    nbytes = 2 * B * Hq * Sq * D * e + 2 * B * Hkv * Skv * D * e + (4 * B * Hq * Sq if with_lse else 0)
    return Work(4 * D * visible_pairs(Sq, Skv, causal) * B * Hq, nbytes, dtype)


def flash_attention_backward(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int, dtype: str,
                             causal: bool = True) -> Work:
    e = _esize(dtype)
    nbytes = (3 * B * Hq * Sq * D + 4 * B * Hkv * Skv * D) * e + 4 * B * Hq * Sq
    return Work(10 * D * visible_pairs(Sq, Skv, causal) * B * Hq, nbytes, dtype)


def moe_gemm(E: int, C: int, d: int, f: int, dtype: str) -> Work:
    return Work(2 * E * C * d * f, (E * C * d + E * d * f + E * C * f) * _esize(dtype), dtype)


def selective_scan(B: int, L: int, Di: int, N: int, dtype: str) -> Work:
    nbytes = (3 * B * L * Di + 2 * B * L * N) * _esize(dtype) + (Di * N + Di) * 4
    return Work(B * L * Di * (7 * N + 3), nbytes, "float32")


def selective_scan_backward(B: int, L: int, Di: int, N: int, dtype: str) -> Work:
    nbytes = (5 * B * L * Di + 4 * B * L * N) * _esize(dtype) + 2 * (Di * N + Di) * 4
    return Work(25 * B * L * Di * N, nbytes, "float32")


def quantize_int8(R: int, C: int, dtype: str) -> Work:
    return Work(4 * R * C, R * C * _esize(dtype) + R * C + 4 * R, "float32")


def dequantize_int8(R: int, C: int, out_dtype: str) -> Work:
    return Work(R * C, R * C + 4 * R + R * C * _esize(out_dtype), "float32")


# ---------------------------------------------------------------------------
# Model steps, from the sizes of a configuration file
# ---------------------------------------------------------------------------
def _slot_matmul_params(s: dict, mixer: str, mlp: str, active: bool) -> int:
    d = s["d_model"]
    n = 0
    if mixer == "mamba":
        di, dtr, N = s["d_inner"], s["dt_rank"], s["ssm_state"]
        n += d * 2 * di + s["conv_width"] * di + di * (dtr + 2 * N) + dtr * di + di * d
    else:
        hd = s["head_dim"]
        n += d * (s["n_heads"] + 2 * s["n_kv_heads"]) * hd + s["n_heads"] * hd * d
    if mlp != "none":
        one = 3 * d * s["d_ff"]
        if mlp == "moe":
            n += d * s["n_experts"] + one * (s["experts_per_token"] if active else s["n_experts"])
        else:
            n += one
    return n


def matmul_params(sizes: dict, active: bool = False) -> int:
    """The parameters that multiply (see the module's docstring), of every
    expert or of the ``experts_per_token`` a token is routed to."""
    n_periods = sizes["n_layers"] // len(sizes["period"])
    per = sum(_slot_matmul_params(sizes, mx, ml, active) for mx, ml in sizes["period"])
    return per * n_periods + sizes["vocab_size"] * sizes["d_model"]


def weight_bytes(sizes: dict, dtype: str) -> int:
    """Every weight a decode step reads, once: the matrices in ``dtype``,
    norms, biases and f32 leaves at their own width; an embedding table apart
    from the head is not counted (a step reads its rows alone)."""
    e = _esize(dtype)
    d = sizes["d_model"]
    n_periods = sizes["n_layers"] // len(sizes["period"])
    total = matmul_params(sizes) * e + d * e  # final norm
    for mixer, mlp in sizes["period"]:
        small = d  # norm1
        if mixer == "mamba":
            di, N = sizes["d_inner"], sizes["ssm_state"]
            total += n_periods * ((di * N + di) * 4)  # A_log, Dp in f32
            small += 2 * di  # conv_b, dt_b
        if mlp != "none":
            small += d  # norm2
            if mlp == "moe":
                total += n_periods * d * sizes["n_experts"] * (4 - e)  # the router is f32
        total += n_periods * small * e
    return total


def train_flops(sizes: dict, tokens: int) -> float:
    return 6.0 * matmul_params(sizes, active=True) * tokens


def decode_work(sizes: dict, positions: Sequence[int], kv_dtype: str, dtype: str = "bfloat16") -> Work:
    """One decode step of ``len(positions)`` slots, slot ``b`` writing
    position ``positions[b]`` and attending to positions ``0..positions[b]``."""
    rows = len(positions)
    n_attn = sum(mx == "attn" for mx, _ in sizes["period"]) * (sizes["n_layers"] // len(sizes["period"]))
    hd, Hq, Hkv = sizes.get("head_dim", 0), sizes.get("n_heads", 0), sizes.get("n_kv_heads", 0)
    seen = sum(p + 1 for p in positions)
    flops = 2.0 * matmul_params(sizes, active=True) * rows + n_attn * 4.0 * hd * Hq * seen
    row = 2 * Hkv * hd + 2 * Hkv * 4 if kv_dtype == "int8" else 2 * Hkv * hd * _esize(dtype)
    lookup = 0 if sizes.get("tie_embeddings") else rows * sizes["d_model"] * _esize(dtype)
    nbytes = (weight_bytes(sizes, dtype) + lookup + n_attn * row * (seen + rows)
              + rows * sizes["vocab_size"] * _esize(dtype))
    return Work(flops, nbytes, "bfloat16")
