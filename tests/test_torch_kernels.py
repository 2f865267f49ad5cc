"""The port's kernels on the CPU: plain versions against the JAX Pallas kernels.

Inputs are drawn with numpy from a seed and handed to both frameworks; the
Pallas kernels run in interpret mode, as ``test_kernels.py`` runs them.  A
CPU tensor takes a wrapper's plain version and never counts as a launch.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import _build, geometry, ops, ref
from repro_torch.kernels import rmsnorm as rn

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


# ---------------------------------------------------------------------------
FLASH_CASES = [
    (2, 4, 2, 256, 64, 128, 128, True),
    (1, 8, 8, 128, 32, 64, 64, True),     # MHA
    (2, 4, 1, 256, 64, 128, 64, True),    # MQA, asymmetric blocks
    (1, 4, 2, 256, 128, 256, 128, True),  # block_q == S
    (2, 4, 2, 128, 64, 128, 128, False),  # non-causal
    (1, 2, 2, 512, 64, 128, 256, True),   # bkv > bq
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
        ("bfloat16", 128, (128, 512), "272384 bytes"),
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
    assert launch.threads == 512 and launch.grid == (16, 32, 1)
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
    # bf16: K rows (D + 8) and V transposed (kv_pad + 8) columns, 2 bytes;
    # f32: K and V rows of D, 4 bytes
    kv_pad, smem = geometry.flash_smem_bytes(200, 64, dtype)
    if dtype == "bfloat16":
        assert kv_pad == 256 and smem == (256 * 72 + 64 * 264) * 2
    else:
        assert kv_pad == 208 and smem == 2 * 208 * 64 * 4


def test_wrappers_refuse_other_devices():
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.empty((64,), device="meta"))
    q = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


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


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: identifier undefined" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="identifier undefined"):
        _build.build(["rmsnorm"])
    assert not _build.library_path("rmsnorm").exists()
