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
launches the kernel or raises; a meta tensor runs the CUDA branch's checks
(the chunk included) and allocations and records the launch instead of
making it (``work.dry_launch``: the dry run).  Where autograd records
(grad enabled and an input that requires grad), the launch goes through
``ScanFn``: the forward
keeps its scratch (each chunk's carry-in after the carry pass) and the
backward launches the backward kernel at the forward's tile (the same
``.cu``: the chunks' local adjoints, their reverse fold, each chunk
recomputed from its carry-in and walked back, and a reduction of the
partial dB, dC, dA and dD sums; ``geometry.scan_backward_launch``).  It
returns ``du, ddt, dA, dBm, dCm, dD`` in the inputs' dtypes.
``BWD_LAUNCHES`` counts one per backward call, whatever its kernel
launches.  The JAX kernel is forward-only: the backward is held to
``jax.vjp`` of the JAX package's ``ref.selective_scan`` through its plain
versions, ``ref.selective_scan_backward`` and the chunked
``ref.selective_scan_chunked_backward``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.geometry import scan_backward_launch, scan_launch
from repro_torch.kernels.ref import selective_scan as selective_scan_plain
from repro_torch.kernels.ref import selective_scan_backward as selective_scan_backward_plain

LAUNCHES = _build.LaunchCounter("selective_scan")
BWD_LAUNCHES = _build.LaunchCounter("selective_scan_backward")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 8 + (_I,) * 8 + (_P,)
_BWD_ARGS = (_P,) * 15 + (_I,) * 8 + (_P,)


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
    launch = _check(u, dt, A, Bm, Cm, D, chunk, d_block)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, dt, A, Bm, Cm, D)):
        B, L, Di = u.shape
        bwd = scan_backward_launch(B, L, Di, A.shape[-1], _DTYPE_NAMES[u.dtype], chunk, d_block)
        return ScanFn.apply(u, dt, A, Bm, Cm, D, lambda *t: _launch(*t, launch),
                            lambda *t: _launch_backward(*t, bwd))
    return _launch(u, dt, A, Bm, Cm, D, launch)[0]


class ScanFn(torch.autograd.Function):
    """``launch(u, dt, A, Bm, Cm, D) -> (y, saved)`` forward;
    ``launch_backward(u, dt, A, Bm, Cm, D, saved, gy) -> (du, ddt, dA, dBm,
    dCm, dD)`` backward.

    Saves the six inputs and ``saved``: on the card the forward kernel's
    scratch (each chunk's carry-in; None for one chunk), which the backward
    kernel reads.  The tests pass the plain versions (``saved`` None) to
    check the Function on the CPU.
    """

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D, launch, launch_backward):
        y, saved = launch(u, dt, A, Bm, Cm, D)
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, saved)
        ctx.launch_backward = launch_backward
        return y

    @staticmethod
    def backward(ctx, gy):
        *inputs, saved = ctx.saved_tensors
        grads = ctx.launch_backward(*inputs, saved, gy.contiguous())
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None, None)


def _check(u, dt, A, Bm, Cm, D, chunk: int, d_block: int):
    """Raise on what the kernels do not take; return the forward's launch."""
    if u.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan runs on cuda, cpu or meta tensors, not {u.device}")
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
    return launch


def _steps(ins, l: int):
    """The scan's inputs cut to their first ``l`` time steps (the plain
    version's products are the same each step: ``work.per_step``)."""
    u, dt, A, Bm, Cm, D = ins
    return u[:, :l], dt[:, :l], A, Bm[:, :l], Cm[:, :l], D


def _launch(u, dt, A, Bm, Cm, D, launch):
    """``(y, scratch)``: the scratch holds each chunk's carry-in after the
    carry pass (None for one chunk)."""
    B, L, Di = u.shape
    N = A.shape[-1]
    y = torch.empty_like(u)
    scratch = (torch.empty(launch.scratch_floats, dtype=torch.float32, device=u.device)
               if launch.scratch_floats else None)
    if u.device.type == "meta":
        ins = (u, dt, A, Bm, Cm, D)
        plain = work.per_step(L, lambda l: work.plain_products(
            ("fwd", ("selective_scan", work.signature(*_steps(ins, l)))),
            lambda: selective_scan_plain(*_steps(ins, l))))
        work.dry_launch(LAUNCHES.name, work.selective_scan(B, L, Di, N, _DTYPE_NAMES[u.dtype]), plain,
                        tile=(launch.chunk, launch.d_block))
        return y, scratch
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
    return y, scratch


def _launch_backward(u, dt, A, Bm, Cm, D, states, gy, bwd):
    if gy.shape != u.shape or gy.dtype != u.dtype or not gy.is_contiguous():
        raise ValueError(f"selective_scan backward: gy must be a contiguous {tuple(u.shape)} "
                         f"{u.dtype}; got {tuple(gy.shape)} {gy.dtype}")
    B, L, Di = u.shape
    N = A.shape[-1]
    if bwd.grid[2] > 1 and states is None:
        raise ValueError("selective_scan backward needs the forward's carry-ins")
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dA, dBm, dCm, dD = (torch.empty_like(t) for t in (A, Bm, Cm, D))
    scratch = torch.empty(bwd.scratch_floats, dtype=torch.float32, device=u.device)
    if u.device.type == "meta":
        ins = (u, dt, A, Bm, Cm, D)
        needs = tuple(t.requires_grad for t in ins)
        needs = needs if any(needs) else (True,) * 6
        plain = work.per_step(L, lambda l: work.autograd_products(
            ("selective_scan", work.signature(*_steps(ins, l)), needs), selective_scan_plain,
            _steps(ins, l), needs, gy[:, :l]))
        work.dry_launch(BWD_LAUNCHES.name, work.selective_scan_backward(B, L, Di, N, _DTYPE_NAMES[u.dtype]),
                        plain, tile=(bwd.chunk, bwd.d_block))
        return du, ddt, dA, dBm, dCm, dD
    lib, fn = _build.launcher("selective_scan", "selective_scan_backward_launch", _BWD_ARGS)
    err = fn(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        gy.data_ptr(), None if states is None else states.data_ptr(), scratch.data_ptr(),
        du.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), dD.data_ptr(),
        B, L, Di, N, bwd.chunk, bwd.d_block, bwd.smem_bytes, _DTYPE_CODES[u.dtype],
        _build.stream(u),
    )
    if err:
        _build.check(lib, "selective_scan", err)
    BWD_LAUNCHES.add(tile=(bwd.chunk, bwd.d_block))
    return du, ddt, dA, dBm, dCm, dD
