"""The port's int8 quantize / dequantize on the CPU against the JAX package's.

The plain versions (what a CPU tensor takes, and what the card's kernels are
held to bit for bit) against the Pallas kernels in interpret mode at
``test_kernels.py``'s shapes, and against ``repro.kernels.ref`` and the
optimizer's ``_mom_write`` at ragged shapes, on exact .5 ties and on zero
rows.  ``q`` must be bit-equal throughout.  The eager JAX oracles divide in
true IEEE f32, as the port does; the jitted Pallas kernel lets XLA turn
``amax / 127`` into a multiply by ``1/127``, so its scale is held at
``rtol=1e-6``, as ``test_kernels.py`` holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jqt
from repro.kernels import ref as jref
from repro.training import optimizer as joptim
from repro.training.train_step import _fake_quant_rowwise
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as qt
from repro_torch.training.train_step import fake_quant_rowwise

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ties(rows: int, cols: int, seed: int) -> np.ndarray:
    """Rows whose every element but the max is an exact tie: ``x = (k + 0.5)
    * scale`` with ``scale`` a power of two and ``amax = 127 * scale``, so
    ``x / scale`` is exactly ``k + 0.5``; both signs, even and odd ``k``."""
    rng = np.random.default_rng(seed)
    scale = np.exp2(rng.integers(-12, 4, (rows, 1))).astype(np.float32)
    k = rng.integers(-127, 127, (rows, cols)).astype(np.float32)
    x = (k + 0.5) * scale
    x[:, 0] = 127.0 * scale[:, 0] * np.where(rng.random(rows) < 0.5, 1, -1)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,C", [(8, 128), (16, 64), (4, 256)])
def test_plain_quantize_matches_pallas(R, C):
    x = (np.random.default_rng(R * C).standard_normal((R, C)) * 3.0).astype(np.float32)
    jq, js = jqt.quantize_int8(jnp.asarray(x), block_rows=4, interpret=True)
    qt.QUANT_LAUNCHES.reset()
    q, s = ops.quantize_int8(_t(x))  # a CPU tensor: the plain version
    assert qt.QUANT_LAUNCHES.count == 0
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (R, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    exp = jqt.dequantize_int8(jq, js, interpret=True)
    got = ops.dequantize_int8(q, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)
    err = np.abs(got.numpy() - x)  # within half a step of the scale
    assert (err <= s.numpy() * 0.5 + 1e-7).all()


@pytest.mark.parametrize("R,C", [(49155, 32), (49155, 1000), (7, 1000), (5, 17)])
@pytest.mark.parametrize("kind", ["normal", "ties", "zero rows"])
def test_plain_quantize_matches_jax_ref_and_mom_write(R, C, kind):
    rng = np.random.default_rng(R + C)
    if kind == "ties":
        x = _ties(R, C, R + C)
    else:
        x = (rng.standard_normal((R, C)) * rng.choice([1e-3, 1.0, 1e3], (R, 1))).astype(np.float32)
    if kind == "zero rows":
        x[::3] = 0.0
    jq, js = jref.quantize_int8(jnp.asarray(x))
    q, s = ref.quantize_int8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    mom = joptim._mom_write(jnp.asarray(x), {"q": None, "s": None})  # eager: true division
    np.testing.assert_array_equal(q.numpy(), np.asarray(mom["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(mom["s"]))
    if kind == "zero rows":
        assert (s.numpy()[::3] == 1.0).all() and (q.numpy()[::3] == 0).all()
    if kind == "ties":  # half to even: never the away-from-zero neighbour
        k = np.floor(x[:, 1:] / s.numpy())
        assert (q.numpy()[:, 1:] % 2 == 0).all()
        assert ((q.numpy()[:, 1:] == k) | (q.numpy()[:, 1:] == k + 1)).all()
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = ref.dequantize_int8(q, s, dtype=dtype)
        exp = jref.dequantize_int8(jq, js, dtype=jdt)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(exp, np.float32))


def test_plain_quantize_takes_bf16_input():
    x = (np.random.default_rng(3).standard_normal((40, 512)) * 2).astype(np.float32)
    jq, js = jref.quantize_int8(jnp.asarray(x, jnp.bfloat16))
    q, s = ref.quantize_int8(_t(x).bfloat16())
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(3, 24, 64), (1024, 32), (5, 8), (64,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_matches_jax(shape, dtype):
    g = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    exp = _fake_quant_rowwise(jnp.asarray(g, dtype))  # eager: true division
    got = fake_quant_rowwise(_t(g).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(exp, np.float32))


def test_cpu_scalar_division_is_not_what_the_plain_version_does():
    """Why ``ref.quantize_int8`` divides by a tensor 127: ``amax * (1/127)``
    (what PyTorch on CUDA does for a Python scalar divisor, and XLA inside
    jit) moves the scale by an ulp on some rows."""
    amax = torch.from_numpy(np.random.default_rng(0).random(4096).astype(np.float32))
    true = amax / amax.new_tensor(127.0)
    recip = amax * (torch.tensor(1.0) / 127.0)
    assert (true != recip).any()
    np.testing.assert_array_equal(true.numpy(), amax.numpy() / np.float32(127.0))


class _OtherDevice(torch.Tensor):
    """A tensor that reports a device the port runs on neither for real
    (cuda, cpu) nor for a dry run (meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def _other(*shape, **kw):
    return torch.empty(shape, **kw).as_subclass(_OtherDevice)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = _other(4, 8)
    with pytest.raises(ValueError):
        qt.quantize_int8(x)
    with pytest.raises(ValueError):
        qt.dequantize_int8(_other(4, 8, dtype=torch.int8), _other(4, 1))
