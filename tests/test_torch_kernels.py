"""The port's kernels on the CPU: plain versions against the JAX Pallas kernels.

Inputs are drawn with numpy from a seed and handed to both frameworks; the
Pallas kernels run in interpret mode, as ``test_kernels.py`` runs them.  A
CPU tensor takes a wrapper's plain version and never counts as a launch.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import _build, geometry, ops, ref
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = _DT[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,block", [((3, 7, 64), 4), ((16, 128), 16), ((5, 96), 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, block, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    exp = jax_rmsnorm(xj, wj, block_rows=block, interpret=True)
    rn.LAUNCHES.reset()
    got = rn.rmsnorm(xt, wt)  # a CPU tensor: the plain version
    assert rn.LAUNCHES.count == 0
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), **_tol(dtype))
    np.testing.assert_array_equal(_np(got), _np(ref.rmsnorm(xt, wt)))


@pytest.mark.parametrize("d", [64, 96, 1024])  # 96: a ragged width for the bf16 vector
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_plain_matches_jax_vjp(d, dtype):
    # the closed form the backward kernel computes, against jax.vjp of the
    # JAX oracle; f32 to 1e-5, bf16 at this file's bf16 tolerance
    rng = np.random.default_rng(30)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    gy = rng.standard_normal((3, 5, d)).astype(np.float32)
    (xj, xt), (wj, wt), (gj, gt) = (_pair(a, dtype) for a in (x, w, gy))
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b), xj, wj)
    edx, edw = vjp(gj)
    rn.BWD_LAUNCHES.reset()
    dx, dw = rn.rmsnorm_backward(xt, wt, gt)  # a CPU tensor: the plain version
    assert rn.BWD_LAUNCHES.count == 0
    assert (dx.dtype, dw.dtype) == (xt.dtype, wt.dtype) and dx.shape == xt.shape and dw.shape == (d,)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else _tol(dtype)
    np.testing.assert_allclose(_np(dx), np.asarray(edx, np.float32), **tol)
    np.testing.assert_allclose(_np(dw), np.asarray(edw, np.float32), **tol)


# ---------------------------------------------------------------------------
FLASH_CASES = [
    (2, 4, 2, 256, 64, 128, 128, True),
    (1, 8, 8, 128, 32, 64, 64, True),     # MHA
    (2, 4, 1, 256, 64, 128, 64, True),    # MQA, asymmetric blocks
    (1, 4, 2, 256, 128, 256, 128, True),  # block_q == S
    (2, 4, 2, 128, 64, 128, 128, False),  # non-causal
    (1, 2, 2, 512, 64, 128, 256, True),   # bkv > bq
    (1, 4, 2, 256, 160, 128, 128, True),  # head_dim 160 (stablelm-12b)
    (2, 4, 1, 128, 160, 64, 128, False),  # head_dim 160, MQA, non-causal
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,bq,bkv,causal", FLASH_CASES)
def test_attention_plain_matches_pallas(B, Hq, Hkv, S, D, bq, bkv, causal):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    exp = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, block_q=bq, block_kv=bkv, interpret=True,
    )
    tiles = ops.KernelTiles(attn_block_q=bq, attn_block_kv=bkv)
    fa.LAUNCHES.reset()
    got = ops.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, tiles=tiles
    )
    assert fa.LAUNCHES.count == 0 and fa.LAUNCHES.tiles == set()
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5, rtol=2e-5)


def test_attention_plain_matches_pallas_bf16():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    v = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in (q, k, v))
    exp = jax_flash_attention(qj, kj, vj, block_q=64, block_kv=64, interpret=True)
    got = fa.flash_attention(qt, kt, vt, block_q=64, block_kv=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32), **_tol("bfloat16"))


def test_attention_plain_matches_jnp_oracle_with_fewer_queries():
    # queries at the last Sq of Skv positions (the decode-style offset)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 24, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    exp = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = ref.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "dtype,D,tile,needs",
    [
        ("bfloat16", 64, (512, 512), "1024 threads"),
        ("bfloat16", 64, (512, 128), "1024 threads"),
        ("bfloat16", 128, (128, 512), "296072 bytes"),
        ("float32", 64, (256, 512), "262144 bytes"),
        ("float32", 64, (512, 128), "512 threads"),
    ],
)
def test_oversize_tile_raises_naming_it(dtype, D, tile, needs):
    with pytest.raises(ValueError) as ei:
        geometry.flash_launch(1, 32, 4096, 4096, D, dtype, *tile)
    msg = str(ei.value)
    assert f"block_q={tile[0]}, block_kv={tile[1]}" in msg and needs in msg


def test_tile_is_only_clamped_to_the_sequence():
    launch = geometry.flash_launch(1, 32, 4096, 4096, 64, "bfloat16", 256, 128)
    assert (launch.block_q, launch.block_kv) == (256, 128)
    assert launch.threads == 640 and launch.grid == (16, 32, 1)  # 4 consumer warpgroups + producer
    launch = geometry.flash_launch(2, 4, 100, 300, 64, "bfloat16", 256, 256)
    assert (launch.block_q, launch.block_kv) == (100, 256)  # JAX's min(block, S)
    assert launch.kv_pad == 256 and launch.grid == (1, 4, 2)
    assert launch.smem_bytes <= geometry.SMEM_PER_BLOCK


def test_launchable_attn_blocks_at_granite_head_dim():
    assert geometry.launchable_attn_blocks(64, "bfloat16") == [
        (128, 128), (128, 256), (128, 512), (256, 128), (256, 256), (256, 512)
    ]
    assert (256, 256) in geometry.launchable_attn_blocks(64, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_smem_formula_matches_kernel_layout(dtype):
    # bf16: 1,024 bytes of alignment slack, Q of two consumer warpgroups (64
    # rows of D each), a ring of 4 stages of K and V (64 keys of D each), and
    # 8-byte mbarriers (Q's and two a stage), 2-byte elements;
    # f32: K and V rows of D, 4 bytes
    kv_pad, smem = geometry.flash_smem_bytes(200, 64, dtype, 128)
    if dtype == "bfloat16":
        assert kv_pad == 256 and smem == 1024 + 2 * 64 * 64 * 2 + 4 * 2 * 64 * 64 * 2 + 8 * 9
    else:
        assert kv_pad == 208 and smem == 2 * 208 * 64 * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_smem_formula_at_head_dim_160(dtype):
    # bf16: the tile at its true width, 64 rows x 160 x 2 bytes (five 32-wide
    # chunks of the 64-byte swizzle, no padding to 192); f32: as at every
    # head_dim, K and V rows of D
    kv_pad, smem = geometry.flash_smem_bytes(256, 160, dtype, 128)
    if dtype == "bfloat16":
        assert kv_pad == 256 and smem == 1024 + 2 * 64 * 160 * 2 + 4 * 2 * 64 * 160 * 2 + 8 * 9 == 205_896
    else:
        assert kv_pad == 256 and smem == 2 * 256 * 160 * 4


def test_forward_launches_at_head_dim_160():
    assert 160 in geometry.FLASH_HEAD_DIMS and 160 in geometry.FLASH_BWD_HEAD_DIMS
    # bf16: a producer and two consumer warpgroups, as at 128
    launch = geometry.flash_launch(1, 32, 4096, 4096, 160, "bfloat16", 128, 256)
    assert (launch.threads, launch.kv_pad, launch.smem_bytes, launch.grid) == (384, 256, 205_896,
                                                                               (32, 32, 1))
    assert geometry.max_threads(160, "bfloat16") == 384
    assert geometry.launchable_attn_blocks(160, "bfloat16") == [(128, 128), (128, 256)]
    # f32: two threads a row, so block_q 128 takes the 256 threads the kernel is built for
    assert geometry.f32_lanes(160) == 2 and geometry.f32_lanes(128) == 1
    launch = geometry.flash_launch(1, 4, 300, 300, 160, "float32", 128, 128)
    assert (launch.threads, launch.kv_pad, launch.smem_bytes, launch.grid) == (256, 128, 163_840,
                                                                               (3, 4, 1))
    assert geometry.launchable_attn_blocks(160, "float32") == [(128, 128)]
    with pytest.raises(ValueError, match="512 threads"):
        geometry.flash_launch(1, 4, 4096, 4096, 160, "float32", 256, 128)
    with pytest.raises(ValueError, match="head_dim"):
        geometry.flash_launch(1, 4, 4096, 4096, 96, "bfloat16", 128, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_launches_at_head_dim_160(dtype):
    # stablelm-12b's training shape: 32/8 heads of 160 over 4096 tokens
    launch = geometry.flash_backward_launch(1, 32, 8, 4096, 4096, 160, dtype)
    if dtype == "bfloat16":
        # dK/dV: one consumer of 64 keys and the producer, 16 q rows a stage;
        # dQ: two consumers of 64 rows and the producer, 32 keys a stage
        assert (launch.dkdv_tile, launch.dq_tile) == ((64, 16), (128, 32))
        assert (launch.dkdv_threads, launch.dq_threads) == (256, 384)
        assert (launch.dkdv_smem, launch.dq_smem) == (83_528, 164_936)
        assert (launch.dkdv_grid, launch.dq_grid) == ((8, 1, 64), (32, 1, 32))
    else:
        # two threads a row, 64 rows a block
        assert (launch.dkdv_tile, launch.dq_tile) == ((64, 16), (64, 16))
        assert (launch.dkdv_threads, launch.dq_threads) == (128, 128)
        assert (launch.dkdv_grid, launch.dq_grid) == ((8, 1, 64), (32, 1, 64))


class _OtherDevice(torch.Tensor):
    """A tensor that reports a device the port runs on neither for real
    (cuda, cpu) nor for a dry run (meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def _other(*shape):
    return torch.empty(shape).as_subclass(_OtherDevice)


def test_wrappers_refuse_other_devices():
    x = _other(4, 64)
    with pytest.raises(ValueError):
        rn.rmsnorm(x, _other(64))
    q = _other(1, 2, 8, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    x = _other(2, 8, 16)
    with pytest.raises(ValueError):
        mg.moe_gemm(x, _other(2, 16, 16))
    u = _other(1, 8, 16)
    a = _other(16, 4)
    b = _other(1, 8, 4)
    with pytest.raises(ValueError):
        ss.selective_scan(u, u, a, b, b, _other(16))
    x = _other(4, 64)
    with pytest.raises(ValueError):
        rn.rmsnorm_backward(x, _other(64), x)
    q, kv = _other(2, 4, 64), _other(2, 2, 16, 64)
    with pytest.raises(ValueError):
        da.decode_attention(q, kv, kv, None, None, _other(2), 0, 0.125)


# ---------------------------------------------------------------------------
# moe_gemm and selective_scan launch geometry
def test_kernel_tiles_are_the_jax_defaults():
    t = ops.DEFAULT_TILES
    assert (t.attn_block_q, t.attn_block_kv, t.scan_chunk, t.scan_d_block) == (256, 256, 128, 256)
    assert (t.moe_block_c, t.moe_block_f, t.moe_block_d) == (128, 256, 256)
    assert set(ops.COUNTERS) == {"rmsnorm", "rmsnorm_backward", "flash_attention",
                                 "flash_attention_backward", "moe_gemm", "selective_scan",
                                 "selective_scan_backward", "quantize_int8", "dequantize_int8",
                                 "decode_attention"}


@pytest.mark.parametrize(
    "E,C,d,f,dtype,tile,launched,threads",
    [
        # granite-moe prefill up/gate and down, decode at 4 slots (C = 8)
        (32, 1280, 1024, 512, "bfloat16", (128, 256, 256), (128, 256, 256), 384),
        (32, 1280, 512, 1024, "bfloat16", (128, 256, 256), (128, 256, 256), 384),
        (32, 8, 1024, 512, "bfloat16", (128, 256, 256), (8, 256, 256), 256),
        # test_kernels.py's f32 tiles, f = 48 with block_f = 16 included
        (4, 32, 64, 48, "float32", (16, 16, 32), (16, 16, 32), 4),
        (2, 16, 32, 32, "float32", (16, 32, 16), (16, 32, 16), 8),
        (8, 8, 16, 16, "float32", (8, 16, 16), (8, 16, 16), 2),
        (32, 128, 1024, 512, "float32", (128, 256, 256), (128, 256, 256), 512),
    ],
)
def test_moe_tile_is_only_clamped(E, C, d, f, dtype, tile, launched, threads):
    launch = geometry.moe_gemm_launch(E, C, d, f, dtype, *tile)
    assert (launch.block_c, launch.block_f, launch.block_d) == launched  # JAX's min(block, dim)
    assert launch.threads == threads and launch.smem_bytes <= geometry.SMEM_PER_BLOCK
    assert launch.grid == (E, C // launched[0], f // launched[1])


def test_moe_default_tile_smem_matches_kernel_layout():
    # 1,024 bytes of alignment slack, a ring of block_d / 64 = 4 stages, each
    # x [128][64] and w [64][256] in bf16 plus two 8-byte mbarriers, and the
    # output's mbarrier
    launch = geometry.moe_gemm_launch(32, 1280, 1024, 512, "bfloat16", 128, 256, 256)
    assert launch.smem_bytes == 1024 + 4 * ((128 * 64 + 64 * 256) * 2 + 16) + 8 == 197_704
    # decode: the 8-row tile is padded to one consumer warpgroup's 64 rows
    launch = geometry.moe_gemm_launch(32, 8, 1024, 512, "bfloat16", 128, 256, 256)
    assert launch.smem_bytes == 1024 + 4 * ((64 * 64 + 64 * 256) * 2 + 16) + 8


@pytest.mark.parametrize(
    "x_t,w_t", [(False, False), (False, True), (True, False), (True, True)]
)
def test_moe_launch_layouts_keep_the_geometry(x_t, w_t):
    # the backward's shapes: dx = dy . w^T reads w (E,d,f) as stored, dw =
    # x^T . dy reads x (E,C,d) as stored; a layout changes no tile or size
    plain = geometry.moe_gemm_launch(32, 1024, 1280, 512, "bfloat16", 128, 256, 256)
    launch = geometry.moe_gemm_launch(32, 1024, 1280, 512, "bfloat16", 128, 256, 256, x_t=x_t, w_t=w_t)
    assert (launch.x_t, launch.w_t) == (x_t, w_t)
    assert (launch.block_c, launch.block_f, launch.block_d) == (128, 256, 256)
    assert (launch.threads, launch.smem_bytes, launch.grid) == (384, 197_704, (32, 8, 2))
    assert (plain.threads, plain.smem_bytes, plain.grid) == (launch.threads, launch.smem_bytes, launch.grid)
    # a column tile of 96 runs one 128-wide wgmma chunk; block_c 64 one consumer
    small = geometry.moe_gemm_launch(5, 48, 320, 96, "bfloat16", 64, 96, 40, x_t=x_t, w_t=w_t)
    assert geometry.moe_bn(96) == 128 and small.threads == 256
    assert small.smem_bytes == 1024 + 2 * ((64 * 64 + 64 * 128) * 2 + 16) + 8
    if x_t:  # a transposed x is read in rows of C: 16 bytes a multiple
        with pytest.raises(ValueError, match="multiples of 8"):
            geometry.moe_gemm_launch(2, 12, 32, 32, "bfloat16", 12, 32, 32, x_t=x_t, w_t=w_t)
    else:
        assert geometry.moe_gemm_launch(2, 12, 32, 32, "bfloat16", 12, 32, 32, w_t=w_t).grid == (2, 1, 1)
    if x_t or w_t:  # the f32 kernel takes contiguous operands
        with pytest.raises(ValueError, match="contiguous"):
            geometry.moe_gemm_launch(2, 16, 32, 32, "float32", 16, 32, 16, x_t=x_t, w_t=w_t)


@pytest.mark.parametrize(
    "E,C,d,f,dtype,tile,needs",
    [
        (4, 40, 64, 48, "float32", (16, 16, 32), "does not divide"),    # C % block_c
        (4, 32, 64, 48, "float32", (16, 32, 32), "does not divide"),    # f % block_f
        (4, 32, 64, 48, "float32", (16, 16, 48), "does not divide"),    # d % block_d
        (32, 1280, 1024, 512, "bfloat16", (256, 256, 256), "640 threads"),
        (32, 1280, 1024, 512, "bfloat16", (128, 256, 512), "bytes of shared memory"),
        (32, 1280, 1024, 512, "float32", (256, 256, 256), "1024 threads"),
        (2, 16, 36, 32, "bfloat16", (16, 32, 36), "multiples of 8"),
    ],
)
def test_moe_tile_that_cannot_launch_raises_naming_it(E, C, d, f, dtype, tile, needs):
    with pytest.raises(ValueError) as ei:
        geometry.moe_gemm_launch(E, C, d, f, dtype, *tile)
    assert "moe tile" in str(ei.value) and needs in str(ei.value)


@pytest.mark.parametrize(
    "B,L,Di,N,dtype,tile,launched",
    [
        (1, 4096, 8192, 16, "bfloat16", (128, 256), (128, 256)),
        (1, 4096, 8192, 16, "bfloat16", (64, 256), (64, 256)),
        (1, 4096, 8192, 16, "bfloat16", (256, 256), (256, 256)),  # launches now
        (1, 4096, 8192, 16, "float32", (256, 256), (256, 256)),
        (1, 320, 8192, 16, "float32", (64, 256), (64, 256)),
        (2, 64, 32, 8, "float32", (16, 16), (16, 16)),
        (1, 128, 64, 16, "float32", (64, 32), (64, 32)),
        (2, 32, 16, 4, "float32", (32, 16), (32, 16)),    # chunk == L
        (1, 96, 48, 8, "float32", (32, 48), (32, 48)),    # d_block == Di
        (1, 16, 48, 8, "float32", (32, 256), (16, 48)),   # both clamped
    ],
)
def test_scan_tile_is_only_clamped(B, L, Di, N, dtype, tile, launched):
    launch = geometry.scan_launch(B, L, Di, N, dtype, *tile)
    assert (launch.chunk, launch.d_block) == launched
    chunks = L // launched[0]
    assert launch.threads == launched[1] and launch.grid == (B, Di // launched[1], chunks)
    assert launch.smem_bytes == geometry.scan_smem_bytes(launched[0], N) <= geometry.SMEM_PER_BLOCK
    # the chunk, carry and output passes, or the output pass alone
    assert launch.kernels == (3 if chunks > 1 else 1)
    assert launch.scratch_floats == (B * chunks * Di * (N + 1) if chunks > 1 else 0)


@pytest.mark.parametrize(
    "chunk,N,smem",
    [
        (128, 16, 16_384),   # falcon-mamba's default: B and C of 128 steps, f32
        (64, 16, 8_192),
        (256, 16, 32_768),
        (32, 8, 2_048),
    ],
)
def test_scan_smem_formula_matches_kernel_layout(chunk, N, smem):
    # csrc/selective_scan.cu stages a chunk's B and C ([chunk][N] each) in
    # f32, whatever the input dtype; u and dt are read from device memory
    assert geometry.scan_smem_bytes(chunk, N) == 2 * chunk * N * 4 == smem
    for dtype in ("float32", "bfloat16"):
        assert geometry.scan_launch(1, 4 * chunk, 256, N, dtype, chunk, 256).smem_bytes == smem


def test_scan_scratch_at_falcon_mamba_prefill():
    # chunk 128: 32 chunks' end states (N = 16) and sums of dt, f32, ~17 MB
    launch = geometry.scan_launch(1, 4096, 8192, 16, "bfloat16", 128, 256)
    assert launch.scratch_floats * 4 == 32 * 8192 * 17 * 4 == 17_825_792
    assert launch.grid == (1, 32, 32) and launch.kernels == 3


@pytest.mark.parametrize(
    "L,Di,N,dtype,tile,needs",
    [
        (4096, 8192, 16, "bfloat16", (2048, 256), "262144 bytes"),
        (4096, 8192, 16, "float32", (4096, 256), "524288 bytes"),
        (96, 64, 8, "float32", (64, 32), "does not divide"),
        (64, 48, 8, "float32", (16, 32), "does not divide"),
        (64, 1024, 8, "float32", (16, 1024), "1024 threads"),
        (64, 64, 32, "float32", (16, 32), "N=32"),
    ],
)
def test_scan_tile_that_cannot_launch_raises_naming_it(L, Di, N, dtype, tile, needs):
    with pytest.raises(ValueError, match=needs):
        geometry.scan_launch(1, L, Di, N, dtype, *tile)


def test_launchable_scan_chunks_at_falcon_mamba_widths():
    assert geometry.launchable_scan_chunks(256, 16, "bfloat16") == [64, 128, 256]
    assert geometry.launchable_scan_chunks(256, 16, "float32") == [64, 128, 256]
    assert geometry.SCAN_CHUNK_OPTIONS == (64, 128, 256)


# ---------------------------------------------------------------------------
# The build step, with a stand-in for nvcc (the CPU box has none)
def _fake_nvcc(tmp_path, body: str):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_build_compiles_once_per_source_hash(tmp_path, monkeypatch):
    log = tmp_path / "calls"
    # writes the -o target and a ptxas-like line, counting calls
    nvcc = _fake_nvcc(tmp_path, (
        f'echo x >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
        'echo "ptxas info    : Used 32 registers" >&2\n'
    ))
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    paths = _build.build(["rmsnorm", "flash_attention"])
    assert all(p.read_text() == "lib\n" and p.parent == tmp_path / "build" for p in paths.values())
    assert "Used 32 registers" in _build.ptxas_report("rmsnorm")
    assert _build.build(["rmsnorm", "flash_attention"]) == paths  # cached: no second compile
    assert log.read_text().count("x") == 2
    assert not list((tmp_path / "build").glob("*.tmp"))
    # every digest covers the shared headers csrc/*.cuh: editing one rebuilds
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.build(["rmsnorm", "flash_attention"]) == paths  # the same bytes: no compile
    (csrc / "sm90.cuh").write_text((csrc / "sm90.cuh").read_text() + "\n// edited\n")
    rebuilt = _build.build(["rmsnorm", "flash_attention"])
    assert all(rebuilt[n] != paths[n] and rebuilt[n].exists() for n in paths)
    assert log.read_text().count("x") == 4


def test_launcher_sets_argtypes_once_and_caches(monkeypatch):
    # a stand-in library (libc) for a built one: the first call loads it and
    # sets the function's argtypes and restype, later calls only look it up
    loads = []

    def fake_load(name):
        loads.append(name)
        return ctypes.CDLL(None)

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_launchers", {})
    lib, fn = _build.launcher("quantize", "abs", (ctypes.c_int,))
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int and fn(-3) == 3
    assert _build.launcher("quantize", "abs", (ctypes.c_int,)) == (lib, fn)
    assert loads == ["quantize"]


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: identifier undefined" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="identifier undefined"):
        _build.build(["rmsnorm"])
    assert not _build.library_path("rmsnorm").exists()
