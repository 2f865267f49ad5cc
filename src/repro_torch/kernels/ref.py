"""Plain PyTorch versions of the ported kernels.

The same arithmetic as the JAX package's oracles (``repro/kernels/ref.py``):
the CPU path of every wrapper, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    groups = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(groups, dim=1).float()
    vv = v.repeat_interleave(groups, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) * scale
    if causal:
        # queries are the LAST S positions of the Skv-long key sequence
        qpos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vv)
    return out.to(q.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor, eps: float = 1e-6):
    """``(dx, dw)`` of ``rmsnorm`` in closed form, in f32 and cast at the end
    (dx to x.dtype, dw to w.dtype): with ``inv = rsqrt(mean(x^2) + eps)``
    and ``g = gy * w``, ``dx = inv * g - x * inv^3 * mean(x * g)`` and ``dw``
    the sum over rows of ``gy * x * inv`` -- what ``jax.vjp`` of the JAX
    package's ``ref.rmsnorm`` gives."""
    d = x.shape[-1]
    xf, gf = x.float(), gy.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = gf * w.float()
    dx = inv * g - xf * (inv * inv * inv) * torch.mean(xf * g, dim=-1, keepdim=True)
    dw = (xf * inv * gf).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def selective_scan(
    u: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di)   (already softplus'd)
    A: torch.Tensor,  # (Di, N)      (negative reals)
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,  # (Di,)
) -> torch.Tensor:
    """y_t = C_t . x_t + D*u_t with x_t = exp(dt_t A) x_{t-1} + dt_t u_t B_t;
    the state in f32, the output in ``u.dtype``."""
    Bsz, L, Di = u.shape
    N = A.shape[1]
    uf, dtf = u.float(), dt.float()
    Af, Bf, Cf = A.float(), Bm.float(), Cm.float()
    x = torch.zeros((Bsz, Di, N), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])  # (B, Di, N)
        dBu = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        x = dA * x + dBu
        ys.append(torch.einsum("bdn,bn->bd", x, Cf[:, t]))
    y = torch.stack(ys, dim=1) + uf * D.float()[None, None]
    return y.to(u.dtype)


def selective_scan_chunked(
    u: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di)
    A: torch.Tensor,  # (Di, N)
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,  # (Di,)
    chunk: int,
) -> torch.Tensor:
    """``selective_scan`` in the CUDA kernel's three passes over chunks of
    ``chunk`` steps (``chunk`` divides ``L``): (1) each chunk but the last
    scanned from a zero state, keeping its end state ``h_c`` and ``sum(dt)``
    over the chunk; (2) the carry folded over the chunks in order,
    ``carry_{c+1} = exp(A * sum(dt)_c) * carry_c + h_c``; (3) each chunk
    scanned again from its carry-in, giving ``y``.  The same function as
    ``selective_scan`` up to f32 rounding."""
    Bsz, L, Di = u.shape
    if L % chunk:
        raise ValueError(f"chunk {chunk} does not divide L={L}")
    nc = L // chunk
    uf, dtf = u.float(), dt.float()
    Af, Bf, Cf = A.float(), Bm.float(), Cm.float()

    def scan(c, h, out):
        for t in range(c * chunk, (c + 1) * chunk):
            dBu = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
            h = torch.exp(dtf[:, t, :, None] * Af[None]) * h + dBu
            if out is not None:
                out.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
        return h

    zero = torch.zeros((Bsz, Di, A.shape[1]), dtype=torch.float32, device=u.device)
    ends = [scan(c, zero, None) for c in range(nc - 1)]  # pass 1
    dtsum = dtf.reshape(Bsz, nc, chunk, Di).sum(dim=2)  # (B, nc, Di)
    carry, carries = zero, [zero]  # pass 2: carry-in of each chunk
    for c in range(nc - 1):
        carry = torch.exp(Af[None] * dtsum[:, c, :, None]) * carry + ends[c]
        carries.append(carry)
    ys = []
    for c in range(nc):  # pass 3
        scan(c, carries[c], ys)
    y = torch.stack(ys, dim=1) + uf * D.float()[None, None]
    return y.to(u.dtype)


def selective_scan_step(
    x: torch.Tensor,  # (B, Di, N) carried state
    u: torch.Tensor,  # (B, Di)
    dt: torch.Tensor,  # (B, Di)
    A: torch.Tensor,  # (Di, N)
    b: torch.Tensor,  # (B, N)
    c: torch.Tensor,  # (B, N)
    D: torch.Tensor,  # (Di,)
):
    """Single decode step; returns (new_state, y).  ``dt * u`` is taken in the
    input dtype before the f32 cast, as the JAX step does."""
    xf = x.float()
    dA = torch.exp(dt.float()[..., None] * A.float()[None])
    dBu = (dt * u).float()[..., None] * b.float()[:, None, :]
    xf = dA * xf + dBu
    y = torch.einsum("bdn,bn->bd", xf, c.float())
    y = y + u.float() * D.float()[None]
    return xf.to(x.dtype), y.to(u.dtype)


def moe_gemm(x: torch.Tensor, w: torch.Tensor, *, x_t: bool = False, w_t: bool = False) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f); f32 accumulation, output in x.dtype.

    ``x_t`` / ``w_t``: that operand is given as stored transposed, x as
    ``(E, d, C)`` and w as ``(E, f, d)``; the product is the same."""
    spec = f"{'edc' if x_t else 'ecd'},{'efd' if w_t else 'edf'}->ecf"
    return torch.einsum(spec, x.float(), w.float()).to(x.dtype)


def quantize_int8(x: torch.Tensor):
    """Rowwise symmetric int8: ``x (R, C)`` -> ``(q int8 (R, C), scale f32 (R, 1))``.

    ``scale = amax / 127`` (1 where ``amax == 0``), ``q = clip(round(x /
    scale), ±127)``, rounded half to even.  Both divisions are true IEEE f32
    divisions, as in the JAX package's eager ``ref.quantize_int8``: 127 is
    passed as a tensor because PyTorch on CUDA divides by a Python scalar as a
    multiply by its reciprocal, which moves the scale by an ulp on some rows.
    (Inside ``jax.jit`` XLA makes the same rewrite of ``amax / 127.0``, so
    the jitted JAX optimizer's scales can differ from these by one ulp.)
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
