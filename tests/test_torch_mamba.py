"""The port's Mamba on the CPU against the JAX package's.

The plain ``selective_scan`` against the Pallas kernel in interpret mode on
the parametrisations of ``test_kernels.py``; ``selective_scan_step`` against
the JAX step; ``mamba.forward`` and ``mamba.decode_step`` on reduced
falcon-mamba against ``repro.models.mamba`` with JAX-initialised weights.
A CPU tensor takes the plain version and never counts as a launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as jax_selective_scan
from repro.models import mamba as jmamba
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import mamba

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)  # test_kernels.py's


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _scan_inputs(B, L, Di, N, seed=20, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, L, Di)).astype(np.float32)
    # softplus; dt_shift -4 gives dt ~ 0.02, a state that lives across chunks
    dt = np.logaddexp(rng.standard_normal((B, L, Di)) + dt_shift, 0).astype(np.float32)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    D = np.linspace(0.1, 1.0, Di).astype(np.float32)
    return u, dt, A, Bm, Cm, D


# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "B,L,Di,N,chunk,dblk",
    [
        (2, 64, 32, 8, 16, 16),
        (1, 128, 64, 16, 64, 32),
        (2, 32, 16, 4, 32, 16),   # chunk == L
        (1, 96, 48, 8, 32, 48),   # dblk == Di
    ],
)
def test_selective_scan_plain_matches_pallas(B, L, Di, N, chunk, dblk):
    args = _scan_inputs(B, L, Di, N)
    exp = jax_selective_scan(*(jnp.asarray(a) for a in args), chunk=chunk, d_block=dblk,
                             interpret=True)
    tiles = ops.KernelTiles(scan_chunk=chunk, scan_d_block=dblk)
    ss.LAUNCHES.reset()
    got = ops.selective_scan(*(_t(a) for a in args), tiles=tiles)  # CPU: the plain version
    assert ss.LAUNCHES.count == 0 and ss.LAUNCHES.tiles == set()
    assert got.shape == (B, L, Di) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **SCAN_TOL)


@pytest.mark.parametrize(
    "B,L,Di,N,chunk,dt_shift",
    [
        (2, 64, 32, 8, 64, 0.0),    # 1 chunk: chunk == L, the output pass alone
        (1, 64, 16, 16, 32, 0.0),   # 2 chunks
        (2, 80, 16, 4, 16, 0.0),    # 5 chunks
        (1, 128, 16, 8, 4, 0.0),    # 32 chunks
        (1, 160, 16, 16, 32, -4.0),  # 5 chunks, slow decay: states cross chunks
    ],
)
def test_selective_scan_chunked_matches_plain_and_pallas(B, L, Di, N, chunk, dt_shift):
    # the CUDA kernel's three passes (chunk states from zero, carries folded
    # in order, each chunk rerun from its carry-in) give the scan
    args = _scan_inputs(B, L, Di, N, seed=24, dt_shift=dt_shift)
    ts = [_t(a) for a in args]
    got = ref.selective_scan_chunked(*ts, chunk)
    assert got.shape == (B, L, Di) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.selective_scan(*ts).numpy(), **SCAN_TOL)
    exp = jax_selective_scan(*(jnp.asarray(a) for a in args), chunk=chunk, d_block=Di,
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **SCAN_TOL)


def test_selective_scan_chunked_refuses_a_chunk_that_does_not_divide_L():
    with pytest.raises(ValueError, match="does not divide"):
        ref.selective_scan_chunked(*(_t(a) for a in _scan_inputs(1, 24, 8, 4)), 16)


def test_selective_scan_plain_bf16_keeps_f32_state_and_returns_u_dtype():
    u, dt, A, Bm, Cm, D = _scan_inputs(1, 24, 16, 4)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (u, dt)] + [jnp.asarray(A)] + [
        jnp.asarray(a, jnp.bfloat16) for a in (Bm, Cm)] + [jnp.asarray(D)]
    exp = jref.selective_scan(*bf)
    tb = [_t(a).bfloat16() for a in (u, dt)] + [_t(A)] + [_t(a).bfloat16() for a in (Bm, Cm)] + [_t(D)]
    got = ref.selective_scan(*tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_step_matches_jax(dtype):
    rng = np.random.default_rng(21)
    Bsz, Di, N = 3, 16, 8
    x = rng.standard_normal((Bsz, Di, N)).astype(np.float32)
    u, dt, A, Bm, Cm, D = _scan_inputs(Bsz, 1, Di, N, seed=22)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jargs = (jnp.asarray(x), jnp.asarray(u[:, 0], jdt), jnp.asarray(dt[:, 0], jdt), jnp.asarray(A),
             jnp.asarray(Bm[:, 0], jdt), jnp.asarray(Cm[:, 0], jdt), jnp.asarray(D))
    targs = (_t(x), _t(u[:, 0]).to(tdt), _t(dt[:, 0]).to(tdt), _t(A),
             _t(Bm[:, 0]).to(tdt), _t(Cm[:, 0]).to(tdt), _t(D))
    jx, jy = jref.selective_scan_step(*jargs)
    tx, ty = ops.selective_scan_step(*targs)
    assert tx.dtype == torch.float32 and ty.dtype == tdt
    # dt * u is taken in the input dtype before the f32 cast, as in JAX
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), atol=1e-5, rtol=1e-5)


def test_step_loop_replays_the_full_scan():
    B, L, Di, N = 2, 16, 8, 4
    u, dt, A, Bm, Cm, D = (_t(a) for a in _scan_inputs(B, L, Di, N, seed=23))
    full = ref.selective_scan(u, dt, A, Bm, Cm, D)
    x = torch.zeros((B, Di, N))
    ys = []
    for t in range(L):
        x, y = ref.selective_scan_step(x, u[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), full.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jmamba.init(jcfg, jax.random.PRNGKey(7))
    p = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _ident(a, _):
    return a


def test_init_layout_and_dtypes_match_jax(block):
    jcfg, cfg, *_ = block
    jp = jmamba.init(dataclasses.replace(jcfg, dtype="bfloat16"), jax.random.PRNGKey(0))
    p = mamba.init(dataclasses.replace(cfg, dtype="bfloat16"), torch.Generator().manual_seed(0),
                   "cpu", n_periods=3)
    assert p.keys() == jp.keys()
    for k in p:
        assert tuple(p[k].shape) == (3,) + tuple(jp[k].shape), k
        assert str(p[k].dtype).split(".")[1] == jp[k].dtype.name, k
    # the same values up to the last bit of torch's and XLA's log
    np.testing.assert_allclose(p["A_log"][1].numpy(), np.asarray(jp["A_log"]), rtol=1e-6)
    np.testing.assert_allclose(p["dt_b"][0].float().numpy(), np.asarray(jp["dt_b"], np.float32),
                               rtol=1e-2)


def test_conv_causal_matches_jax(block):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(24).standard_normal((2, 12, cfg.d_inner)).astype(np.float32)
    exp = jmamba._conv_causal(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    got = mamba._conv_causal(_t(x), p["conv_w"], p["conv_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("chunk", [4, 16])
def test_mamba_forward_matches_jax(block, chunk):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(25).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jtiles = jops.KernelTiles(scan_chunk=chunk, scan_d_block=64)
    exp = jmamba.forward(jp, jcfg, jnp.asarray(x), tiles=jtiles, shard=_ident)
    ss.LAUNCHES.reset()
    got = mamba.forward(p, cfg, _t(x), tiles=ops.KernelTiles(scan_chunk=chunk, scan_d_block=64))
    assert ss.LAUNCHES.count == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_mamba_decode_step_matches_jax_and_commits_only_its_rows(block):
    jcfg, cfg, jp, p = block
    Bsz = 3
    rng = np.random.default_rng(26)
    jcache = jmamba.init_cache(jcfg, Bsz, jnp.float32)
    cache = mamba.init_cache(cfg, Bsz, torch.float32, "cpu")
    for t in range(4):  # fill the conv window and the state
        x = rng.standard_normal((Bsz, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jmamba.decode_step(jp, jcfg, jcache, jnp.asarray(x), shard=_ident)
        out, got = mamba.decode_step(p, cfg, cache, _t(x))
        assert got is cache
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), **TOL)
    before = {k: v.clone() for k, v in cache.items()}
    commit = np.array([True, False, True])
    x = rng.standard_normal((Bsz, 1, cfg.d_model)).astype(np.float32)
    jout, jnew = jmamba.decode_step(jp, jcfg, jcache, jnp.asarray(x), shard=_ident)
    out, _ = mamba.decode_step(p, cfg, cache, _t(x), commit=_t(commit))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache[k][commit].numpy(), np.asarray(jnew[k])[commit], **TOL)
        assert torch.equal(cache[k][~commit], before[k][~commit])
