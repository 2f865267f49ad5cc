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
launches the kernel or raises.  Where autograd records (grad enabled and an
input that requires grad), the launch goes through ``FlashAttentionFn``: the
JAX kernel is forward-only, so its backward recomputes the plain version
from the saved ``q``, ``k``, ``v`` (never the ``S x S`` scores, which are
not saved) and returns its gradient; at 1x4096 with 16 heads that backward
holds one layer's f32 scores, about 1 GiB, at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.geometry import flash_launch
from repro_torch.kernels.ref import attention as attention_plain

LAUNCHES = _build.LaunchCounter("flash_attention")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 12 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
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
    launch = flash_launch(B, Hq, Sq, Skv, D, _DTYPE_NAMES[q.dtype], block_q, block_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(
            q, k, v, causal, lambda a, b, c: _launch(a, b, c, causal, launch)
        )
    return _launch(q, k, v, causal, launch)


class FlashAttentionFn(torch.autograd.Function):
    """``launch(q, k, v)`` forward; backward by recompute through ``ref.attention``.

    Saves only ``q``, ``k``, ``v``.  ``launch`` is the kernel on the card
    (the tests pass the plain version to check the backward on the CPU).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, launch):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return launch(q, k, v)

    @staticmethod
    def backward(ctx, go):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            o = attention_plain(qd, kd, vd, causal=ctx.causal)
            gq, gk, gv = torch.autograd.grad(o, (qd, kd, vd), go)
        return gq, gk, gv, None, None


def _launch(q, k, v, causal: bool, launch) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    o = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel takes contiguous, 16-byte aligned {name}")
    lib, fn = _build.launcher("flash_attention", "flash_attention_launch", _ARGS)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, launch.block_q, launch.block_kv, launch.kv_pad,
        launch.threads, launch.smem_bytes, int(causal), float(D ** -0.5),
        _DTYPE_CODES[q.dtype], _build.stream(q),
    )
    if err:
        _build.check(lib, "flash_attention", err)
    LAUNCHES.add(tile=(launch.block_q, launch.block_kv))
    return o
