"""Flash attention: the CUDA kernel's wrapper, its launch counter and its plain version.

Replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (``pallas_call`` at line 129, body
``_fwd_kernel`` at line 29): causal GQA forward with an online softmax,
queries at the last ``Sq`` of ``Skv`` keys, kv tiles above the diagonal
skipped, rows that see no key giving 0.  The kernel is
``csrc/flash_attention.cu``: bound by operations at prefill shapes, so bf16
is a TMA -> wgmma pipeline (a producer warpgroup streams K and V 64 keys at
a time into a ring of shared-memory stages; consumer warpgroups of 64 query
rows run both products on the tensor cores with f32 accumulators and keep
scores and the running state in registers); f32 runs in true f32 (no
TF32).  One block serves one ``block_q`` query tile and loops over the keys
up to the causal diagonal; ``block_kv`` sets how many keys the ring holds.

The tile is the caller's: ``kernels/geometry.flash_launch`` applies the JAX
kernel's clamp to the sequence length and raises ``ValueError`` for a tile
that does not fit a Hopper block; nothing else changes it.
``LAUNCHES.tiles`` records every tile launched since the last reset.

A CPU tensor takes the plain version (``ref.attention``); a CUDA tensor
launches the kernel or raises; a meta tensor runs the CUDA branch's checks
(the tile's launchability included) and allocations and records the launch
instead of making it (``work.dry_launch``: the dry run).  Where autograd
records (grad enabled and an input that requires grad), the launch goes
through ``FlashAttentionFn``:
the forward kernel also writes each row's log-sum-exp (``lse``), the
Function saves ``q``, ``k``, ``v`` and ``lse`` (never the ``S x S``
scores), and its backward launches the backward kernel
(``csrc/flash_attention_backward.cu``: a dQ kernel that also sums ``Delta
= rowsum(P * dP)``, then a dK/dV kernel that sums each GQA group in its
block; bf16 both TMA -> wgmma pipelines; deterministic, its tiles its own,
``geometry.flash_backward_launch``, at every head_dim the forward takes
(16, 32, 64, 128, 160), with an f32 scratch the wrapper allocates for the
dQ kernel to hand lse and Delta to the dK/dV kernel).
``BWD_LAUNCHES`` counts one per backward call, whatever its two kernel
launches, and records the dK/dV and dQ tiles.  The JAX kernel is
forward-only: the backward is held to ``jax.vjp`` of the JAX package's
``ref.attention`` through its plain version, ``ref.attention_backward``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.geometry import flash_backward_launch, flash_launch
from repro_torch.kernels.ref import attention as attention_plain
from repro_torch.kernels.ref import attention_backward as attention_backward_plain

LAUNCHES = _build.LaunchCounter("flash_attention")
BWD_LAUNCHES = _build.LaunchCounter("flash_attention_backward")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 5 + (_I,) * 12 + (ctypes.c_float, _I, _P)
_BWD_ARGS = (_P,) * 9 + (_I,) * 15 + (ctypes.c_float, _I, _P)


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta tensors, not {q.device}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or tuple(t.shape) != (B, Hkv, Skv, D):
            raise ValueError(
                f"{name} must be {(B, Hkv, Skv, D)} {q.dtype} on {q.device}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    dtype = _DTYPE_NAMES[q.dtype]
    launch = flash_launch(B, Hq, Sq, Skv, D, dtype, block_q, block_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        bwd = flash_backward_launch(B, Hq, Hkv, Sq, Skv, D, dtype)
        return FlashAttentionFn.apply(
            q, k, v, causal, lambda a, b, c: _launch(a, b, c, causal, launch, with_lse=True),
            lambda *t: _launch_backward(*t, causal, bwd),
        )
    return _launch(q, k, v, causal, launch)[0]


class FlashAttentionFn(torch.autograd.Function):
    """``launch(q, k, v) -> (o, lse)`` forward; ``launch_backward(q, k, v,
    lse, do) -> (dq, dk, dv)`` backward.

    Saves ``q``, ``k``, ``v`` and ``lse``.  On the card both are the
    kernels; the tests pass the plain versions (``ref.attention_lse``,
    ``ref.attention_backward``) to check the Function on the CPU.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, launch, launch_backward):
        o, lse = launch(q, k, v)
        ctx.save_for_backward(q, k, v, lse)
        ctx.launch_backward = launch_backward
        return o

    @staticmethod
    def backward(ctx, go):
        q, k, v, lse = ctx.saved_tensors
        gq, gk, gv = ctx.launch_backward(q, k, v, lse, go.contiguous())
        return gq, gk, gv, None, None, None


def _check_layout(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel takes contiguous, 16-byte aligned {name}")


def _launch(q, k, v, causal: bool, launch, with_lse: bool = False):
    """``(o, lse)``: ``lse`` (B, Hq, Sq) f32 is written only ``with_lse``
    (training), else it is None and the kernel is passed a null pointer."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    _check_layout(q=q, k=k, v=v, o=o)
    if q.device.type == "meta":
        key = ("flash_attention", work.signature(q, k, v), causal)
        plain = work.plain_products(("fwd", key), lambda: attention_plain(q, k, v, causal=causal))
        wk = work.flash_attention(B, Hq, Hkv, Sq, Skv, D, _DTYPE_NAMES[q.dtype], causal, with_lse)
        work.dry_launch(LAUNCHES.name, wk, plain, tile=(launch.block_q, launch.block_kv))
        return o, lse
    lib, fn = _build.launcher("flash_attention", "flash_attention_launch", _ARGS)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, launch.block_q, launch.block_kv, launch.kv_pad,
        launch.threads, launch.smem_bytes, int(causal), float(D ** -0.5),
        _DTYPE_CODES[q.dtype], _build.stream(q),
    )
    if err:
        _build.check(lib, "flash_attention", err)
    LAUNCHES.add(tile=(launch.block_q, launch.block_kv))
    return o, lse


def _launch_backward(q, k, v, lse, do, causal: bool, bwd):
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != (B, Hq, Sq):
        raise ValueError(f"flash_attention backward: do must be {tuple(q.shape)} {q.dtype} and lse "
                         f"{(B, Hq, Sq)}; got {tuple(do.shape)} {do.dtype} and {tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(bwd.scratch_floats, dtype=torch.float32, device=q.device)
    _check_layout(q=q, k=k, v=v, do=do, lse=lse)
    if q.device.type == "meta":
        needs = tuple(t.requires_grad for t in (q, k, v))
        needs = needs if any(needs) else (True, True, True)
        plain = work.autograd_products(
            ("flash_attention", work.signature(q, k, v), causal, needs),
            lambda a, b, c: attention_plain(a, b, c, causal=causal), (q, k, v), needs, do)
        wk = work.flash_attention_backward(B, Hq, Hkv, Sq, Skv, D, _DTYPE_NAMES[q.dtype], causal)
        work.dry_launch(BWD_LAUNCHES.name, wk, plain, tile=(bwd.dkdv_tile, bwd.dq_tile))
        return dq, dk, dv
    lib, fn = _build.launcher("flash_attention_backward", "flash_attention_backward_launch", _BWD_ARGS)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(), scratch.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, *bwd.dkdv_tile, *bwd.dq_tile, bwd.dkdv_threads, bwd.dq_threads,
        bwd.dkdv_smem, bwd.dq_smem, int(causal), float(D ** -0.5), _DTYPE_CODES[q.dtype], _build.stream(q),
    )
    if err:
        _build.check(lib, "flash_attention_backward", err)
    BWD_LAUNCHES.add(tile=(bwd.dkdv_tile, bwd.dq_tile))
    return dq, dk, dv
