"""What one launch of each hand kernel does, and its record on the meta device.

**Work.**  Each function gives one call's ``Work``: the operations it
performs and the bytes it must move (each input read once, each output
written once), from the call's shapes and element sizes, and the peak its
operations run at (``ops_dtype``: bf16 tensor cores or f32 CUDA cores).
These are the formulas behind ``chip_smoke.py``'s bound columns and
``PERF.md`` section 6:

* rmsnorm: 4 f32 operations an element; x read, y written, w read;
  backward 10 an element, x and gy read, dx written, w read and dw written;
* flash attention: 4·D operations a visible (query, key) pair a q-head
  (the two products); q, k, v read and o written once (and the f32 lse
  where training writes it); backward 10·D a pair (five products), q, k,
  v, lse and do read, dq, dk, dv written;
* moe_gemm: 2·E·C·d·f; x and w read, the output written;
* selective scan: B·L·Di·(7·N + 3) f32 operations; u, dt, y (a channel
  each), Bm, Cm (a state each) and A, D; backward 25 a state update;
* quantize: x read, q and the scales written, 4 operations an element;
  dequantize: q and the scales read, the output written, 1 an element;
* decode attention: 4·D f32 operations a visible (position, q-head) pair
  (the two products); each visible K and V row read once (and its two f32
  scales in an int8 cache), q read, att and lse written.

``bound_ms`` turns a ``Work`` into the least time a card could take.

**The meta device.**  A wrapper given meta tensors runs its CUDA branch's
checks and allocations and, where the CUDA branch would call the kernel,
``dry_launch``: it adds to ``DRY`` one launch of the kernel (the wrapper's
own counter, which ``chip_smoke.py`` reads, counts only the card's
launches), the call's ``Work`` and the products its plain PyTorch version would run
on the same tensors (``plain_products``: counted once per signature by a
``FlopCounterMode`` of its own, the surrounding dispatch modes set aside,
so that what the card runs and what the plain version would are counted
apart; the scan's, whose plain loop repeats one step's products, from its
first two steps, ``per_step``).  A backward's plain products are those of
autograd through the forward's plain version, as the CPU path computes
them.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Hashable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    ops_dtype: str  # "bfloat16" (tensor cores) or "float32"


def bound_ms(work: Work, hbm_bytes_per_s: float, peak_ops: Dict[str, float]) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes = work.bytes / hbm_bytes_per_s * 1e3
    t_ops = work.flops / peak_ops[work.ops_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _esize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]


def visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs a causal mask leaves visible, queries at the last
    ``Sq`` of ``Skv`` positions (all of them without the mask)."""
    if not causal:
        return Sq * Skv
    if Sq <= Skv:
        return Sq * (Skv - Sq) + Sq * (Sq + 1) // 2
    return Skv * (Skv + 1) // 2


def rmsnorm(n: int, d: int, dtype: str) -> Work:
    """``n`` elements in rows of ``d``."""
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


def decode_attention(B: int, Hq: int, Hkv: int, D: int, seen: int, kv_dtype: str,
                     q_dtype: str) -> Work:
    """One new query a row over ``seen`` visible positions summed over the
    ``B`` rows, each read for every one of the ``Hkv`` KV heads."""
    row = 2 * D * _esize(kv_dtype) + (8 if kv_dtype == "int8" else 0)
    nbytes = seen * Hkv * row + B * Hq * D * _esize(q_dtype) + B * Hq * (D + 1) * 4
    return Work(4 * D * Hq * seen, nbytes, "float32")


# ---------------------------------------------------------------------------
# The meta device's record
# ---------------------------------------------------------------------------
class DryRecord:
    """Per kernel (by ``ops.COUNTERS``' names) since the last reset: the
    launches the meta device recorded, their ``Work`` summed, the products
    their plain versions would run, and the tiles launched."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches: Dict[str, int] = defaultdict(int)
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes: Dict[str, float] = defaultdict(float)
        self.plain_flops: Dict[str, float] = defaultdict(float)
        self.tiles: Dict[str, set] = defaultdict(set)

    def add(self, name: str, work: Work, plain: float, tile=None) -> None:
        self.launches[name] += 1
        self.flops[name] += work.flops
        self.bytes[name] += work.bytes
        self.plain_flops[name] += plain
        if tile is not None:
            self.tiles[name].add(tile)


DRY = DryRecord()
_PLAIN: Dict[Hashable, int] = {}


def signature(*tensors) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def plain_products(key: Hashable, run: Callable[[], None]) -> int:
    """The products ``run`` performs (``FlopCounterMode``'s count), once per
    ``key``: run with every dispatch mode around it set aside and saved
    tensors kept as they are (so a checkpoint around the wrapper sees
    nothing of it)."""
    if key not in _PLAIN:
        from torch.utils._python_dispatch import _disable_current_modes
        from torch.utils.flop_counter import FlopCounterMode

        with _disable_current_modes(), torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                                                lambda t: t):
            counter = FlopCounterMode(display=False)
            with counter:
                run()
        _PLAIN[key] = counter.get_total_flops()
    return _PLAIN[key]


def autograd_products(key: Hashable, plain: Callable, inputs, needs, grad_out_like) -> int:
    """The products of autograd through ``plain(*inputs)`` for the inputs
    ``needs`` marks, without the forward's: a backward kernel's plain count."""
    def fwd():
        plain(*(t.detach() for t in inputs))

    def both():
        ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        with torch.enable_grad():
            out = plain(*ins)
        torch.autograd.grad(out, [t for t, n in zip(ins, needs) if n],
                            torch.empty_like(grad_out_like))

    return plain_products(("bwd", key), both) - plain_products(("fwd", key), fwd)


def per_step(L: int, count: Callable[[int], int]) -> int:
    """``count(L)`` of a plain version that repeats the same products each of
    its ``L`` steps (the scan's loop over time): ``count(1)`` and
    ``count(2)`` give the first step and each one after, exactly, without a
    walk of ``L`` steps."""
    if L <= 2:
        return count(L)
    first, two = count(1), count(2)
    return first + (L - 1) * (two - first)


def dry_launch(name: str, work: Work, plain: int, tile=None) -> None:
    """A launch of kernel ``name`` on the meta device, recorded in ``DRY``
    where the card would launch it (the wrappers' own counters count only
    launches made on the card)."""
    DRY.add(name, work, plain, tile)
