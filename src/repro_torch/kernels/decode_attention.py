"""Decode attention over the KV cache: the CUDA kernel's wrapper, its launch counter and its plain version.

Replaces no Pallas kernel: the JAX package's decode attention
(``src/repro/models/attention.py``, ``decode_step``) is plain jnp, and so
was the port's until this kernel, the plain version below.  That version
converts the whole cache, int8 -> bf16 -> f32 with masked positions
included, and runs two f32 products over it at every layer of every step;
at 16 rows of a 32k int8 cache that is ~5 ms a layer where reading the
visible rows once takes ~0.12.  The kernel (``csrc/decode_attention.cu``)
reads the cache as stored, int8 codes with their f32 row scales or bf16 (or
f32) rows, splits each (row, KV head)'s positions into chunks
(flash-decoding: ``splits``), skips the chunks past the row's ``cur``, and
combines the chunks' partial softmaxes in a second, small launch.  Math in
f32 on CUDA cores, as the plain version.

Both return ``att (B, Hq, hd)`` f32, the attention of each query head, and
``lse (B, Hq)`` f32, the log-sum-exp of its masked logits, so that a cache
split by position over ranks combines from ``lse``
(``collectives.softmax_combine``).  A rank that holds no visible position
of a row gives that row ``lse = -inf`` from the kernel (att 0) and about
-1e30 from the plain version (its masked logits' value): both weigh 0.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises; a meta tensor runs the CUDA branch's checks and allocations and
records the launch instead of making it (``work.dry_launch``: the dry run,
which cannot read ``cur`` and counts every position of the cache).
``cur`` stays on the device: nothing here reads a device value.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, work

LAUNCHES = _build.LaunchCounter("decode_attention")
HEAD_DIMS = (16, 32, 64, 128, 160)  # flash attention's
MAX_GROUP = 8  # query heads a KV head
_KV_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_Q_DTYPES = (torch.bfloat16, torch.float32)
# blocks a launch aims at: 16 an SM of the H100's 132, a few waves at the
# two or three blocks an SM holds.  Measured at the benchmark cell's shapes
# (PERF.md): 8 or 32 an SM are slower, by a block's set-up or by the tail
TARGET_BLOCKS = 132 * 16
MIN_CHUNK = 256  # positions: below this a block's set-up outweighs its reads

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = ((_P, _L, _L, _I) + (_P, _L, _L) * 4 + (_I, _P, _I, _L, ctypes.c_float) + (_I,) * 7
         + (_P,) * 5)


def splits(L: int, rows_heads: int) -> Tuple[int, int]:
    """``(n_split, chunk)``: how many chunks of ``chunk`` positions each
    (row, KV head)'s ``L`` cache positions split into.  A function of ``L``
    and ``B * Hk`` alone, never of ``cur`` (a device value)."""
    n = max(1, min(math.ceil(TARGET_BLOCKS / rows_heads), math.ceil(L / MIN_CHUNK)))
    chunk = math.ceil(L / n)
    return math.ceil(L / chunk), chunk


def decode_attention_plain(q, k, v, k_s, v_s, cur, o: int, scale: float):
    """The plain PyTorch version: ``q (B, Hq, hd)``, ``k``/``v (B, Hk, L,
    hd)`` as the cache holds them, ``k_s``/``v_s (B, Hk, L, 1)`` f32 scales
    of an int8 cache (None otherwise), ``cur`` scalar or ``(B,)``, ``o`` the
    first global position of ``k``.  GQA-grouped masked attention: query
    heads reshape to (Hk, groups) so the cache is never repeated; f32 on the
    logits, as the JAX package's decode attention."""
    B, Hq, hd = q.shape
    L = k.shape[2]
    int8_kv = k_s is not None
    if int8_kv:
        k_scale = k_s[..., 0][:, :, None, None, :]  # (B, Hkv, 1, 1, L)
        v_scale = v_s[..., 0][:, :, None, None, :]
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    Hk = k.shape[1]
    qg = q.reshape(B, Hk, Hq // Hk, 1, hd)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg.float(), k.float()) * scale
    if int8_kv:
        logits = logits * k_scale
    t = torch.arange(o, o + L, device=q.device)  # global positions
    lim = cur[:, None, None, None, None] if cur.ndim == 1 else cur
    logits = logits.masked_fill(~(t <= lim), -1e30)
    probs = torch.softmax(logits, dim=-1)
    if int8_kv:
        probs = probs * v_scale
    att = torch.einsum("bkgqt,bktd->bkgqd", probs, v.float())
    return att.reshape(B, Hq, hd), torch.logsumexp(logits, dim=-1).reshape(B, Hq)


def _check(q, k, v, k_s, v_s, cur) -> None:
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda, cpu or meta tensors, not {dev}")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention takes q (B, Hq, hd) and k, v (B, Hk, L, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    Bk, Hk, L, hdk = k.shape
    if Bk != B or hdk != hd or Hq % Hk or Hq // Hk > MAX_GROUP:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not group over k {tuple(k.shape)} "
                         f"(at most {MAX_GROUP} query heads a KV head)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel is built for head_dim {HEAD_DIMS}, not {hd}")
    if q.dtype not in _Q_DTYPES or k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise ValueError(f"decode_attention kernel takes q in bf16/f32 and k, v in int8/bf16/f32; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (k_s is None) != (k.dtype != torch.int8) or (v_s is None) != (k_s is None):
        raise ValueError("decode_attention: an int8 cache comes with k_s and v_s, another without")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_s", k_s), ("v_s", v_s), ("cur", cur)):
        if t is not None and t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {dev}")
    if q.stride(2) != 1:
        raise ValueError("decode_attention: q's head dimension must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd or (t.stride(0) * t.element_size()) % 16 \
                or (t.stride(1) * t.element_size()) % 16 or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name}'s (row, head) slabs must be contiguous "
                             f"rows of hd and 16-byte aligned; strides {t.stride()}")
    for name, t in (("k_s", k_s), ("v_s", v_s)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (B, Hk, L, 1)
                              or t.stride(2) != 1):
            raise ValueError(f"decode_attention: {name} must be float32 (B, Hk, L, 1) with "
                             f"contiguous positions; got {t.dtype} {tuple(t.shape)} {t.stride()}")
    if cur.dtype != torch.int64 or cur.ndim > 1 or (cur.ndim == 1 and tuple(cur.shape) != (B,)) \
            or not cur.is_contiguous():
        raise ValueError(f"decode_attention: cur must be an int64 scalar or ({B},); got "
                         f"{cur.dtype} {tuple(cur.shape)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_s: Optional[torch.Tensor], v_s: Optional[torch.Tensor], cur: torch.Tensor,
                     o: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(att (B, Hq, hd) f32, lse (B, Hq) f32)`` of one new query a row over
    global positions ``<= cur`` of the cache ``k``/``v`` (``(B, Hk, L, hd)``,
    positions ``[o, o + L)``; int8 with ``k_s``/``v_s``, else bf16 or f32),
    taken through its strides: a view of some KV heads is not copied."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_s, v_s, cur, o, scale)
    _check(q, k, v, k_s, v_s, cur)
    B, Hq, hd = q.shape
    Hk, L = k.shape[1], k.shape[2]
    g = Hq // Hk
    n_split, chunk = splits(L, B * Hk)
    f32 = dict(dtype=torch.float32, device=q.device)
    att, lse = torch.empty((B, Hq, hd), **f32), torch.empty((B, Hq), **f32)
    part_o = torch.empty((B * Hk, n_split, g, hd), **f32)
    part_lse = torch.empty((B * Hk, n_split, g), **f32)
    if q.device.type == "meta":
        plain = work.plain_products(
            ("fwd", ("decode_attention", work.signature(q, k, v, cur))),
            lambda: decode_attention_plain(q, k, v, k_s, v_s, cur, o, scale))
        work.dry_launch(LAUNCHES.name, work.decode_attention(
            B, Hq, Hk, hd, B * L, str(k.dtype).replace("torch.", ""),
            str(q.dtype).replace("torch.", "")), plain)
        return att, lse
    lib, fn = _build.launcher("decode_attention", "decode_attention_launch", _ARGS)
    scaled = k_s is not None
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), int(q.dtype == torch.bfloat16),
             k.data_ptr(), k.stride(0), k.stride(1), v.data_ptr(), v.stride(0), v.stride(1),
             k_s.data_ptr() if scaled else None, k_s.stride(0) if scaled else 0,
             k_s.stride(1) if scaled else 0,
             v_s.data_ptr() if scaled else None, v_s.stride(0) if scaled else 0,
             v_s.stride(1) if scaled else 0,
             _KV_CODES[k.dtype], cur.data_ptr(), int(cur.ndim == 1), o, scale,
             B, Hk, g, L, hd, n_split, chunk,
             part_o.data_ptr(), part_lse.data_ptr(), att.data_ptr(), lse.data_ptr(),
             _build.stream(q))
    if err:
        _build.check(lib, "decode_attention", err)
    LAUNCHES.add()
    return att, lse

