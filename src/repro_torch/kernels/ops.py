"""Kernel entry points the models call, with dispatch by device.

The counterpart of the JAX package's ``kernels/ops.py``.  There is no mode
switch: a tensor on the CPU takes a kernel's plain PyTorch version, a tensor
on a CUDA device launches the hand-written kernel or raises.  Kernel block
shapes come from the schedule plan (``KernelTiles``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gemm as _mg
from repro_torch.kernels import quantize as _qt
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import selective_scan as _ss
from repro_torch.runtime import tracing


@dataclasses.dataclass(frozen=True)
class KernelTiles:
    """Schedule-tunable kernel block shapes (the JAX package's defaults)."""

    attn_block_q: int = 256
    attn_block_kv: int = 256
    scan_chunk: int = 128
    scan_d_block: int = 256
    moe_block_c: int = 128
    moe_block_f: int = 256
    moe_block_d: int = 256


DEFAULT_TILES = KernelTiles()

# every kernel of the port, by name, with its launch counter
COUNTERS = {
    "rmsnorm": _rn.LAUNCHES,
    "rmsnorm_backward": _rn.BWD_LAUNCHES,
    "flash_attention": _fa.LAUNCHES,
    "flash_attention_backward": _fa.BWD_LAUNCHES,
    "moe_gemm": _mg.LAUNCHES,
    "selective_scan": _ss.LAUNCHES,
    "selective_scan_backward": _ss.BWD_LAUNCHES,
    "quantize_int8": _qt.QUANT_LAUNCHES,
    "dequantize_int8": _qt.DEQUANT_LAUNCHES,
    "decode_attention": _da.LAUNCHES,
}


def reset_counters() -> None:
    """Every counter of the program: the launch counters and the spans
    (``runtime.tracing``)."""
    for c in COUNTERS.values():
        c.reset()
    tracing.reset()


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def attention(q, k, v, *, causal: bool = True, tiles: KernelTiles = DEFAULT_TILES) -> torch.Tensor:
    return _fa.flash_attention(
        q, k, v, causal=causal, block_q=tiles.attn_block_q, block_kv=tiles.attn_block_kv
    )


def decode_attention(q, k, v, k_s, v_s, cur, o: int, scale: float) -> tuple:
    """One new query a row over the KV cache as stored: ``q (B, Hq, hd)``,
    ``k``/``v (B, Hk, L, hd)`` (int8 with ``k_s``/``v_s (B, Hk, L, 1)``, or
    bf16/f32 with None), ``cur`` the new token's global position (scalar or
    ``(B,)``, on the device), ``o`` the first position ``k`` holds ->
    ``(att (B, Hq, hd) f32, lse (B, Hq) f32)``."""
    return _da.decode_attention(q, k, v, k_s, v_s, cur, o, scale)


def rmsnorm(x, w, *, eps: float = 1e-6) -> torch.Tensor:
    return _rn.rmsnorm(x, w, eps=eps)


def selective_scan(u, dt, A, Bm, Cm, D, *, tiles: KernelTiles = DEFAULT_TILES) -> torch.Tensor:
    return _ss.selective_scan(
        u, dt, A, Bm, Cm, D, chunk=tiles.scan_chunk, d_block=tiles.scan_d_block
    )


selective_scan_step = _ref.selective_scan_step  # decode step: plain, as in the JAX package


def moe_gemm(x, w, *, tiles: KernelTiles = DEFAULT_TILES) -> torch.Tensor:
    return _mg.moe_gemm(
        x, w, block_c=tiles.moe_block_c, block_f=tiles.moe_block_f, block_d=tiles.moe_block_d
    )


def quantize_int8(x) -> tuple:
    """``x (R, C)`` -> ``(q int8 (R, C), scale f32 (R, 1))``, rowwise symmetric."""
    return _qt.quantize_int8(x)


def dequantize_int8(q, scale, dtype=torch.float32) -> torch.Tensor:
    return _qt.dequantize_int8(q, scale, dtype=dtype)
