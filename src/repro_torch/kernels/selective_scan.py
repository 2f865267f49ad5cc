"""Mamba-1 selective scan: the CUDA kernel's wrapper, its launch counter and its plain version.

Replaces the Pallas TPU kernel ``selective_scan`` of
``src/repro/kernels/selective_scan.py`` (``pallas_call`` at line 90, body
``_scan_kernel`` at line 31): ``x_t = exp(dt_t A) x_{t-1} + dt_t u_t B_t``,
``y_t = <x_t, C_t> + D u_t`` with the state in f32.  The kernel is
``csrc/selective_scan.cu``: a chunk-parallel scan in which ``chunk`` splits
``L``: each chunk scanned from a zero state (its end state and ``sum(dt)``
kept), the carries folded over the chunks in order, then each chunk
scanned again from its carry-in to give ``y`` -- three launches a call (one
when ``chunk == L``), through an f32 scratch of ``B * L/chunk * Di * (N+1)``
floats that the wrapper allocates.  ``ref.selective_scan_chunked`` is the
same three passes in plain PyTorch.

``u``, ``dt``, ``Bm`` and ``Cm`` arrive in the model dtype; ``A`` and ``D``
in f32 whatever the model dtype (``models/mamba.py``).  The tile is the
caller's: ``kernels/geometry.scan_launch`` applies the JAX kernel's clamp,
raises ``ValueError`` where the JAX kernel asserts divisibility or the tile
does not fit a Hopper block, and changes nothing else.  ``LAUNCHES`` counts
one per call, and ``LAUNCHES.tiles`` records every ``(chunk, d_block)``
launched since the last reset.

A CPU tensor takes the plain version (``ref.selective_scan``); a CUDA tensor
launches the kernel or raises.  The kernel has no gradient yet: on a CUDA
input that requires grad (with grad enabled) the wrapper raises
``NotImplementedError`` naming ROADMAP item A12, never returning an output
that is silently cut from the graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.geometry import scan_launch
from repro_torch.kernels.ref import selective_scan as selective_scan_plain

LAUNCHES = _build.LaunchCounter("selective_scan")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def selective_scan(
    u: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di)
    A: torch.Tensor,  # (Di, N) f32
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,  # (Di,) f32
    *,
    chunk: int = 128,
    d_block: int = 128,
) -> torch.Tensor:
    if u.device.type == "cpu":
        return selective_scan_plain(u, dt, A, Bm, Cm, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, dt, A, Bm, Cm, D)):
        raise NotImplementedError(
            "selective_scan has no gradient on the card yet (Mamba training): ROADMAP item A12"
        )
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, not {u.device}")
    if u.dtype not in _DTYPE_CODES:
        raise ValueError(f"selective_scan kernel takes float32 or bfloat16, not {u.dtype}")
    B, L, Di = u.shape
    N = A.shape[-1]
    want = {
        "dt": (dt, (B, L, Di), u.dtype), "A": (A, (Di, N), torch.float32),
        "Bm": (Bm, (B, L, N), u.dtype), "Cm": (Cm, (B, L, N), u.dtype),
        "D": (D, (Di,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != u.device:
            raise ValueError(
                f"{name} must be {shape} {dtype} on {u.device}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    launch = scan_launch(B, L, Di, N, _DTYPE_NAMES[u.dtype], chunk, d_block)
    for name, t in (("u", u), *((n, v[0]) for n, v in want.items())):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan kernel takes a contiguous {name}")
    y = torch.empty_like(u)
    scratch = (torch.empty(launch.scratch_floats, dtype=torch.float32, device=u.device)
               if launch.scratch_floats else None)
    lib, fn = _build.launcher("selective_scan", "selective_scan_launch", _ARGS)
    err = fn(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), None if scratch is None else scratch.data_ptr(), B, L, Di, N,
        launch.chunk, launch.d_block, launch.smem_bytes, _DTYPE_CODES[u.dtype],
        _build.stream(u),
    )
    if err:
        _build.check(lib, "selective_scan", err)
    LAUNCHES.add(tile=(launch.chunk, launch.d_block))
    return y
