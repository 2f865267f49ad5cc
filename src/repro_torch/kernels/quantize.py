"""Rowwise symmetric int8: the CUDA kernels' wrappers, their launch counters and plain versions.

Replaces the Pallas TPU kernels of ``src/repro/kernels/quantize.py``:
``quantize_int8`` (``pallas_call`` at line 36, body ``_quant_kernel`` at
line 17) and ``dequantize_int8`` (line 65, body ``_dequant_kernel`` at line
26).  ``scale = amax/127`` (1 where ``amax == 0``), ``q = clip(round(x /
scale), ±127)`` rounded half to even, and ``q * scale`` back.  Both kernels
are ``csrc/quantize.cu`` and bound by bytes.  Quantize keeps each row on
chip between its amax and the write of q, so x is read once, in the regime
``geometry.quantize_launch`` picks from the width: several rows a warp
(``narrow``: decode KV rows, the router, the int8 ring), a warp a row
(``warp``, up to 4 KiB), a block a row through bulk copies into shared
memory (``cta``, up to 115,456 bytes), a thread-block cluster of 2-8 blocks
a row whose partial maxima meet in distributed shared memory
(``cluster``: the untied head's rows), and a block reading a wider row
twice (``two_pass``: no width is refused).  Any number of rows (the TPU's
``block_rows`` divisibility was a tiling artefact, and the optimizer
quantizes leaves such as the tied embedding's ``(49155, 1024)``); a ragged
width or an offset pointer takes masked scalar loads, never padding.
Dequantize is one warp a row.  ``q`` is bit-equal to the plain version:
both divide in true IEEE f32 (see ``ref.quantize_int8``).

A CPU tensor takes the plain version (``ref.quantize_int8`` /
``ref.dequantize_int8``); a CUDA tensor launches the kernel or raises: a
launch the card refuses (a cluster it cannot place) raises too.  A meta
tensor runs the CUDA branch's checks (the regime's launch included) and
allocations and records the launch instead of making it
(``work.dry_launch``: the dry run).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.geometry import QUANT_REGIMES, quantize_launch
from repro_torch.kernels.ref import dequantize_int8 as dequantize_int8_plain
from repro_torch.kernels.ref import quantize_int8 as quantize_int8_plain

QUANT_LAUNCHES = _build.LaunchCounter("quantize_int8")
DEQUANT_LAUNCHES = _build.LaunchCounter("dequantize_int8")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_REGIME_CODES = {name: i for i, name in enumerate(QUANT_REGIMES)}


_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p)
_QUANT_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on cuda, cpu or meta tensors, not {t.device}")
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous (R, C) tensor; got {tuple(t.shape)}")


@functools.lru_cache(maxsize=1024)  # called on every launch: pure in its arguments
def _launch_args(R: int, C: int, dtype: torch.dtype) -> tuple:
    """The launcher's regime, threads, group, per_lane and smem arguments
    for ``geometry.quantize_launch(R, C, dtype)``."""
    g = quantize_launch(R, C, _DTYPE_NAMES[dtype])
    group, per_lane = (g.lanes, g.units_per_lane) if g.lanes else (g.cluster, g.slice_units)
    return _REGIME_CODES[g.regime], g.threads, group, per_lane, g.smem_bytes


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
    vec = int(C % 16 == 0 and _aligned(x, q))  # 16-byte loads of x and stores of q
    if x.device.type == "meta":
        _launch_args(R, C, x.dtype)  # the regime's launch, as the card's
        plain = work.plain_products(("fwd", ("quantize_int8", work.signature(x))),
                                    lambda: quantize_int8_plain(x))
        work.dry_launch(QUANT_LAUNCHES.name, work.quantize_int8(R, C, _DTYPE_NAMES[x.dtype]), plain)
        return q, scale
    lib, fn = _build.launcher("quantize", "quantize_int8_launch", _QUANT_ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), R, C, _DTYPE_CODES[x.dtype], vec,
             *_launch_args(R, C, x.dtype), _build.stream(x))
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
    if q.device.type == "meta":
        plain = work.plain_products(("fwd", ("dequantize_int8", work.signature(q, scale), str(dtype))),
                                    lambda: dequantize_int8_plain(q, scale, dtype=dtype))
        work.dry_launch(DEQUANT_LAUNCHES.name, work.dequantize_int8(R, C, _DTYPE_NAMES[dtype]), plain)
        return out
    lib, fn = _build.launcher("quantize", "dequantize_int8_launch", _ARGS)
    err = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C, _DTYPE_CODES[dtype], vec,
             _build.stream(q))
    if err:
        _build.check(lib, "quantize", err)
    DEQUANT_LAUNCHES.add()
    return out
