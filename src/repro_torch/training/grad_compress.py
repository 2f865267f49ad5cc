"""Int8 error-feedback ring all-reduce for data-parallel gradients.

The counterpart of the JAX package's ``training/grad_compress.py``, step
for step: the same 128-lane padding, the ring reduce-scatter (``n - 1``
hops of an int8 chunk and its scales, each hop adding the local chunk
``c = (idx - step - 1) % n`` and requantizing) and the int8 ring all-gather,
and the error feedback (the residual ``g - dequant(quant(g))`` of the
local contribution, carried into the next step).  The hops are
``sharding.collectives.ppermute`` over the axis's process group; the
quantize and dequantize are ``ops.quantize_int8`` / ``ops.dequantize_int8``
(the hand kernels on the card, whose rowwise function is the reference's
``_quant`` / ``_dequant``).  The all-gather makes ``n - 1`` hops, where the
reference's loop makes ``n`` and drops the last one's result.

Wire cost: a f32 ring all-reduce moves ~2 x size x 4 bytes a rank, this one
~2 x size x 1 byte plus a scale per 128 values.  As in the JAX package it
is a library function held to the reference; the train step's
``grad_comm="int8"`` applies the same numerics as a fake quantization of the
summed gradient (``train_step.fake_quant_rowwise``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding.collectives import ppermute

LANES = 128


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return ops.quantize_int8(x)


def _dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return ops.dequantize_int8(q, s)


def _ring_allreduce_int8(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce a ``(rows, 128)`` f32 tensor over ``axis`` with an int8
    payload on the wire; rows divide by the axis size."""
    n, idx = mesh.size(axis), mesh.index(axis)
    chunk = x.shape[0] // n

    def get_chunk(c):
        return x[c * chunk:(c + 1) * chunk]

    # reduce-scatter: after n - 1 hops rank i holds the sum of chunk (i + 1) % n
    q, s = _quant(get_chunk(idx))  # the first hop carries our own chunk
    for step in range(n - 1):
        q, s = ppermute(q, mesh, axis), ppermute(s, mesh, axis)
        c = (idx - step - 1) % n  # the chunk this rank adds at this hop
        q, s = _quant(_dequant(q, s) + get_chunk(c))
    own = (idx + 1) % n
    # all-gather the reduced chunks
    out = torch.zeros_like(x)
    for step in range(n):
        c = (own - step) % n  # the chunk id held
        out[c * chunk:(c + 1) * chunk] = _dequant(q, s)
        if step < n - 1:
            q, s = ppermute(q, mesh, axis), ppermute(s, mesh, axis)
    return out


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data",
                    error: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sum of ``x`` over ``axis`` through the int8 ring, with error
    feedback: ``(reduced in x's dtype, new error f32)``, both of ``x``'s
    shape; every rank of the axis calls it."""
    n = mesh.size(axis)
    flat = x.float().reshape(-1)
    if error is not None:
        flat = flat + error.reshape(-1)
    pad = (-flat.numel()) % (LANES * n)
    fp = F.pad(flat, (0, pad)).reshape(-1, LANES)
    fp = F.pad(fp, (0, 0, 0, (-fp.shape[0]) % n))  # rows divide by n
    reduced = _ring_allreduce_int8(fp, mesh, axis)
    # error feedback: the local contribution actually transmitted vs intended
    sent_q, sent_s = _quant(fp)
    new_err = (fp - _dequant(sent_q, sent_s)).reshape(-1)
    size = flat.numel()
    return (reduced.reshape(-1)[:size].reshape(x.shape).to(x.dtype),
            new_err[:size].reshape(x.shape))


def make_compressed_allreduce(mesh, axis: str = "data"):
    """Tree-level compressed all-reduce: ``(grads, errors) -> (reduced,
    new errors)``, leaf by leaf, for trees of this rank's gradients."""

    def allreduce(grads: dict, errors: dict):
        out, err = {}, {}
        for k, g in grads.items():
            if isinstance(g, dict):
                out[k], err[k] = allreduce(g, errors[k])
            else:
                out[k], err[k] = compressed_psum(g, mesh, axis, error=errors[k])
        return out, err

    return allreduce
