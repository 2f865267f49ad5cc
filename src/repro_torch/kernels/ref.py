"""Plain PyTorch versions of the ported kernels.

The same arithmetic as the JAX package's oracles (``repro/kernels/ref.py``):
the CPU path of every wrapper, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def _attention_logits(q, k, causal: bool, scale: float) -> torch.Tensor:
    """Scaled f32 scores ``(B, Hq, Sq, Skv)``, ``-inf`` above the causal diagonal."""
    S, Skv = q.shape[2], k.shape[2]
    groups = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(groups, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) * scale
    if causal:
        # queries are the LAST S positions of the Skv-long key sequence
        qpos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, float("-inf"))
    return logits


def _check_heads(q, k) -> None:
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    _check_heads(q, k)
    groups = q.shape[1] // k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_attention_logits(q, k, causal, scale), dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, v.repeat_interleave(groups, dim=1).float())
    return out.to(q.dtype)


def attention_lse(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
):
    """``(o, lse)``: ``attention``'s output and each row's log-sum-exp of its
    scaled scores, ``lse (B, Hq, Sq)`` f32 in natural-log units -- what the
    flash kernel's forward leaves for its backward.  A row that sees no key
    gets ``o = 0`` and ``lse = -inf``, as the kernel gives them."""
    _check_heads(q, k)
    groups = q.shape[1] // k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _attention_logits(q, k, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - _finite_or_inf(lse)[..., None])
    out = torch.einsum("bhst,bhtd->bhsd", p, v.repeat_interleave(groups, dim=1).float())
    return out.to(q.dtype), lse


def _finite_or_inf(lse: torch.Tensor) -> torch.Tensor:
    """``lse`` with ``-inf`` (a row that sees no key) made ``+inf``, so that
    ``exp(score - lse)`` is 0 on such a row rather than NaN."""
    return torch.where(lse == float("-inf"), float("inf"), lse)


def attention_backward(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    lse: torch.Tensor,  # (B, Hq, Sq) f32, natural-log units (``attention_lse``)
    do: torch.Tensor,  # (B, Hq, Sq, D) the output's gradient
    *,
    causal: bool = True,
    scale: Optional[float] = None,
):
    """``(dq, dk, dv)`` of ``attention`` in closed form, f32 inside, each cast
    to its input's dtype: with ``P = exp(S - lse)``, ``dP = do v^T`` and
    ``Delta = rowsum(P * dP)``, ``dv = P^T do``, ``dS = P * (dP - Delta)``,
    ``dq = scale * dS k`` and ``dk = scale * dS^T q``, the group's q-heads
    summed into their kv-head -- what ``jax.vjp`` of the JAX package's
    ``ref.attention`` gives.  ``Delta`` equals ``rowsum(do * o)``; it is
    summed from P and dP, as the kernel does, because ``o`` rounded to bf16
    moves it by more than ``dP - Delta`` on a row whose softmax is near
    one-hot.  A row that sees no key (``lse = -inf``) gives no gradient."""
    _check_heads(q, k)
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    p = torch.exp(_attention_logits(q, k, causal, scale) - _finite_or_inf(lse.float())[..., None])
    dof = do.float()
    kk = k.repeat_interleave(groups, dim=1).float()
    vv = v.repeat_interleave(groups, dim=1).float()
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vv)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kk) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float()) * scale
    group_sum = lambda t: t.reshape(B, Hkv, groups, Skv, D).sum(dim=2)  # noqa: E731
    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


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


def _scan_grads_out(u, dt, A, Bm, Cm, D, du, ddt, dA, dB, dC, dD):
    return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
            dD.to(D.dtype))


def _scan_walk_back(t_range, hs, gnext, uf, dtf, Af, Bf, Cf, gyf, grads):
    """The adjoint recurrence ``g_t = gy_t C_t + a_{t+1} g_{t+1}`` over the
    steps ``t_range`` (descending), from ``gnext = a_{t+1} g_{t+1}`` after
    the last of them; ``hs[t]`` is the state after step ``t`` and ``hs[t -
    1]`` the one before it (zero before step 0).  Adds each step's terms to
    ``grads`` (du, ddt, dA, dB, dC, each f32) and returns the adjoint carried
    to the step before the first, ``a_{t0} g_{t0}``."""
    du, ddt, dA, dB, dC = grads
    for t in t_range:
        a = torch.exp(dtf[:, t, :, None] * Af[None])  # (B, Di, N)
        g = gyf[:, t, :, None] * Cf[:, t, None, :] + gnext
        hprev = hs[t - 1]
        gb = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        dC[:, t] += torch.einsum("bd,bdn->bn", gyf[:, t], hs[t])
        dB[:, t] += torch.einsum("bdn,bd->bn", g, dtf[:, t] * uf[:, t])
        du[:, t] += gb * dtf[:, t]
        ddt[:, t] += (g * Af[None] * a * hprev).sum(dim=-1) + gb * uf[:, t]
        dA += (g * dtf[:, t, :, None] * a * hprev).sum(dim=0)
        gnext = a * g
    return gnext


def _scan_grads_init(uf, Af, Bf):
    return (torch.zeros_like(uf), torch.zeros_like(uf), torch.zeros_like(Af),
            torch.zeros_like(Bf), torch.zeros_like(Bf))


def selective_scan_backward(
    u: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di)
    A: torch.Tensor,  # (Di, N)
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,  # (Di,)
    gy: torch.Tensor,  # (B, L, Di) the output's gradient
):
    """``(du, ddt, dA, dBm, dCm, dD)`` of ``selective_scan`` in closed form,
    f32 inside, each cast to its input's dtype: the states ``h_t`` kept from
    a forward walk, then the adjoint ``g_t = gy_t C_t + a_{t+1} g_{t+1}``
    (``a_t = exp(dt_t A)``) walked back over ``L``, with ``dC_t = sum_d gy_t
    h_t``, ``dB_t = sum_d g_t dt_t u_t``, ``du_t = sum_n g_t dt_t B_t + D
    gy_t``, ``ddt_t = sum_n g_t (A a_t h_{t-1} + u_t B_t)``, ``dA = sum_{b,t}
    g_t dt_t a_t h_{t-1}`` and ``dD = sum_{b,t} gy_t u_t`` -- what
    ``jax.vjp`` of the JAX package's ``ref.selective_scan`` gives."""
    Bsz, L, Di = u.shape
    uf, dtf, gyf = u.float(), dt.float(), gy.float()
    Af, Bf, Cf = A.float(), Bm.float(), Cm.float()
    h = torch.zeros((Bsz, Di, A.shape[1]), dtype=torch.float32, device=u.device)
    hs = {-1: h}
    for t in range(L):
        dBu = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        h = hs[t] = torch.exp(dtf[:, t, :, None] * Af[None]) * h + dBu
    grads = _scan_grads_init(uf, Af, Bf)
    _scan_walk_back(range(L - 1, -1, -1), hs, torch.zeros_like(h), uf, dtf, Af, Bf, Cf, gyf, grads)
    du, ddt, dA, dB, dC = grads
    du += D.float()[None, None] * gyf
    return _scan_grads_out(u, dt, A, Bm, Cm, D, du, ddt, dA, dB, dC, (gyf * uf).sum(dim=(0, 1)))


def selective_scan_chunked_backward(
    u: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di)
    A: torch.Tensor,  # (Di, N)
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,  # (Di,)
    gy: torch.Tensor,  # (B, L, Di)
    chunk: int,
):
    """``selective_scan_backward`` in the CUDA backward kernel's passes over
    chunks of ``chunk`` steps (``chunk`` divides ``L``), from the carry-ins
    the forward's passes leave: (1) each chunk but the first walks the
    adjoint back from zero, keeping ``L_c = a_{t0} g_{t0}`` at its first step
    ``t0`` and ``sum(dt)`` over it; (2) the adjoint carries folded over the
    chunks in reverse, ``R_{c-1} = L_c + exp(A * sum(dt)_c) * R_c`` from
    ``R_{last} = 0``; (3) each chunk's states recomputed from its carry-in
    and the adjoint walked back from ``R_c``, giving every gradient.  The
    same function as ``selective_scan_backward`` up to f32 rounding."""
    Bsz, L, Di = u.shape
    if L % chunk:
        raise ValueError(f"chunk {chunk} does not divide L={L}")
    nc = L // chunk
    uf, dtf, gyf = u.float(), dt.float(), gy.float()
    Af, Bf, Cf = A.float(), Bm.float(), Cm.float()
    zero = torch.zeros((Bsz, Di, A.shape[1]), dtype=torch.float32, device=u.device)

    def states(c, h):  # the states after each step of chunk c, from the carry-in h
        hs = {c * chunk - 1: h}
        for t in range(c * chunk, (c + 1) * chunk):
            dBu = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
            h = hs[t] = torch.exp(dtf[:, t, :, None] * Af[None]) * h + dBu
        return hs

    # the forward's passes 1 and 2: the carry-in of every chunk
    dtsum = dtf.reshape(Bsz, nc, chunk, Di).sum(dim=2)  # (B, nc, Di)
    carries = [zero]
    for c in range(nc - 1):
        end = states(c, zero)[(c + 1) * chunk - 1]
        carries.append(torch.exp(Af[None] * dtsum[:, c, :, None]) * carries[-1] + end)
    # backward pass 1: each chunk but the first from a zero adjoint
    local = {}
    for c in range(1, nc):
        g = zero
        for t in range((c + 1) * chunk - 1, c * chunk - 1, -1):
            g = torch.exp(dtf[:, t, :, None] * Af[None]) * (gyf[:, t, :, None] * Cf[:, t, None, :] + g)
        local[c] = g
    # backward pass 2: the adjoint carries in reverse
    right = {nc - 1: zero}
    for c in range(nc - 1, 0, -1):
        right[c - 1] = local[c] + torch.exp(Af[None] * dtsum[:, c, :, None]) * right[c]
    # backward pass 3: each chunk rerun from its carry-in, walked back from R_c
    grads = _scan_grads_init(uf, Af, Bf)
    for c in range(nc):
        _scan_walk_back(range((c + 1) * chunk - 1, c * chunk - 1, -1), states(c, carries[c]),
                        right[c], uf, dtf, Af, Bf, Cf, gyf, grads)
    du, ddt, dA, dB, dC = grads
    du += D.float()[None, None] * gyf
    return _scan_grads_out(u, dt, A, Bm, Cm, D, du, ddt, dA, dB, dC, (gyf * uf).sum(dim=(0, 1)))


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
