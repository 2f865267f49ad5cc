"""Rowwise symmetric int8: the CUDA kernels' wrappers, their launch counters and plain versions.

Replaces the Pallas TPU kernels of ``src/repro/kernels/quantize.py``:
``quantize_int8`` (``pallas_call`` at line 36, body ``_quant_kernel`` at
line 17) and ``dequantize_int8`` (line 65, body ``_dequant_kernel`` at line
26).  ``scale = amax/127`` (1 where ``amax == 0``), ``q = clip(round(x /
scale), ±127)`` rounded half to even, and ``q * scale`` back.  Both kernels
are ``csrc/quantize.cu``: bound by bytes, one warp per row with vector
loads and the row's max reduced in registers and shuffles; any number of
rows (the TPU's ``block_rows`` divisibility was a tiling artefact, and the
optimizer quantizes leaves such as the tied embedding's ``(49155, 1024)``),
a ragged width masked, never padded.  ``q`` is bit-equal to the plain
version: both divide in true IEEE f32 (see ``ref.quantize_int8``).

A CPU tensor takes the plain version (``ref.quantize_int8`` /
``ref.dequantize_int8``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_int8 as dequantize_int8_plain
from repro_torch.kernels.ref import quantize_int8 as quantize_int8_plain

QUANT_LAUNCHES = _build.LaunchCounter("quantize_int8")
DEQUANT_LAUNCHES = _build.LaunchCounter("dequantize_int8")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous (R, C) tensor; got {tuple(t.shape)}")


def quantize_int8(x: torch.Tensor):
    """``x (R, C)`` f32 or bf16 -> ``(q int8 (R, C), scale f32 (R, 1))``."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    _check_2d("quantize_int8", x)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"quantize_int8 kernel takes float32 or bfloat16, not {x.dtype}")
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    if R == 0 or C == 0:
        return q, scale.fill_(1.0)
    vec = int(C % (16 // x.element_size()) == 0 and _aligned(x, q))
    lib, fn = _build.launcher("quantize", "quantize_int8_launch", _ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), R, C, _DTYPE_CODES[x.dtype], vec,
             _build.stream(x))
    if err:
        _build.check(lib, "quantize", err)
    QUANT_LAUNCHES.add()
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``q (R, C)`` int8, ``scale (R, 1)`` f32 -> ``q * scale`` in ``dtype`` (f32 or bf16)."""
    if q.device.type == "cpu":
        return dequantize_int8_plain(q, scale, dtype=dtype)
    _check_2d("dequantize_int8", q)
    R, C = q.shape
    if q.dtype != torch.int8 or dtype not in _DTYPE_CODES:
        raise ValueError(f"dequantize_int8 kernel takes int8 to float32 or bfloat16, not "
                         f"{q.dtype} to {dtype}")
    if (scale.dtype != torch.float32 or scale.device != q.device
            or tuple(scale.shape) != (R, 1) or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous ({R}, 1) float32 on {q.device}; got "
                         f"{tuple(scale.shape)} {scale.dtype} on {scale.device}")
    out = torch.empty((R, C), dtype=dtype, device=q.device)
    if R == 0 or C == 0:
        return out
    vec = int(C % 4 == 0 and _aligned(q, out))
    lib, fn = _build.launcher("quantize", "dequantize_int8_launch", _ARGS)
    err = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C, _DTYPE_CODES[dtype], vec,
             _build.stream(q))
    if err:
        _build.check(lib, "quantize", err)
    DEQUANT_LAUNCHES.add()
    return out
