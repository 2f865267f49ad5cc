"""The quantize kernel's launch geometry, and the plain version at its regimes' edges.

``geometry.quantize_launch`` picks the regime of ``csrc/quantize.cu`` from a
row's width and dtype.  Every width from 1 to past what a cluster of 8
holds gets one launch that covers the row and fits an H100 (threads, shared
memory, cluster size, two blocks an SM); the main paths' shapes land in the
regime the kernel's header names for them.  The plain version, which the
card holds the kernel to bit for bit, is held here to the JAX package's
Pallas ``quantize_int8`` in interpret mode at each regime's edge widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jqt
from repro.kernels import ref as jref
from repro_torch.kernels import geometry as geo
from repro_torch.kernels import ref

torch.set_num_threads(1)

ESZ = {"float32": 4, "bfloat16": 2}


def _unit_bytes(dtype: str) -> int:
    return geo.QUANT_UNIT * ESZ[dtype]


def _cluster_cap(dtype: str) -> int:
    """The widest row a cluster of ``QUANT_MAX_CLUSTER`` holds, in elements."""
    return geo.QUANT_MAX_CLUSTER * (geo.QUANT_SLICE_BYTES // _unit_bytes(dtype)) * geo.QUANT_UNIT


def _cta_cap(dtype: str) -> int:
    return geo.QUANT_SLICE_BYTES // _unit_bytes(dtype) * geo.QUANT_UNIT


def _expected_regime(cols: int, dtype: str) -> str:
    """By the row's bytes, padded to whole units: the kernel header's table."""
    units = -(-cols // geo.QUANT_UNIT)
    row = units * _unit_bytes(dtype)
    if units <= 16:
        return "narrow"
    if row <= 32 * geo.QUANT_LANE_BYTES:
        return "warp"
    if row <= geo.QUANT_SLICE_BYTES:
        return "cta"
    return "cluster" if cols <= _cluster_cap(dtype) else "two_pass"


def _check_launch(g, rows: int, cols: int, dtype: str) -> None:
    units = -(-cols // geo.QUANT_UNIT)
    assert g.regime in geo.QUANT_REGIMES
    assert 32 <= g.threads <= geo.MAX_BLOCK_THREADS and g.threads % 32 == 0
    assert 0 <= g.smem_bytes <= geo.SMEM_PER_BLOCK
    assert 1 <= g.cluster <= geo.QUANT_MAX_CLUSTER
    if g.regime in ("narrow", "warp"):
        assert g.threads == geo.QUANT_WARP_THREADS and g.smem_bytes == 0 and g.cluster == 1
        assert g.lanes & (g.lanes - 1) == 0 and g.lanes <= 32
        assert g.units_per_lane in geo.QUANT_WARP_UNITS[dtype]
        assert g.lanes * g.units_per_lane >= units  # the row's units, one lane's at most 128 bytes
        assert g.units_per_lane * _unit_bytes(dtype) <= geo.QUANT_LANE_BYTES
        assert (g.regime == "narrow") == (g.lanes < 32)  # several rows share a warp
        assert g.grid * (g.threads // g.lanes) >= rows
    elif g.regime in ("cta", "cluster"):
        assert (g.regime == "cta") == (g.cluster == 1)
        assert g.cluster * g.slice_units >= units and (g.cluster - 1) * g.slice_units < units
        assert g.smem_bytes == geo.QUANT_HEADER_BYTES + g.slice_units * _unit_bytes(dtype)
        assert g.slice_units * _unit_bytes(dtype) <= geo.QUANT_MAX_PIECES * geo.QUANT_PIECE_BYTES
        # two blocks an SM: one block's loads overlap another's writes
        assert 2 * (g.smem_bytes + geo.SMEM_RESERVED_PER_BLOCK) <= geo.SMEM_PER_SM
        assert g.grid == rows * g.cluster
    else:
        assert g.cluster == 1 and g.grid == rows and g.smem_bytes == geo.QUANT_HEADER_BYTES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_width_gets_one_launch_that_fits(dtype):
    launch = geo.quantize_launch.__wrapped__  # no cache: every width is computed
    top = _cluster_cap(dtype) + 4 * geo.QUANT_UNIT * 64
    order = {r: i for i, r in enumerate(geo.QUANT_REGIMES)}
    last = 0
    for cols in range(1, top + 1):
        g = launch(7, cols, dtype)
        _check_launch(g, 7, cols, dtype)
        assert order[g.regime] >= last, f"{cols}: {g.regime} after a wider regime"
        last = order[g.regime]
        # two_pass only beyond what a cluster of 8 holds, and always there
        assert (g.regime == "two_pass") == (cols > _cluster_cap(dtype)), cols
        assert g.regime == _expected_regime(cols, dtype), cols
    for cols in (top * 2, 10 ** 6, 2 ** 24):  # no width is refused
        g = launch(3, cols, dtype)
        _check_launch(g, 3, cols, dtype)
        assert g.regime == "two_pass"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regime_edges(dtype):
    esz, launch = ESZ[dtype], geo.quantize_launch
    assert launch(4, 256, dtype).regime == "narrow" and launch(4, 272, dtype).regime == "warp"
    warp_top = geo.QUANT_LANE_BYTES * 32 // esz
    assert launch(4, warp_top, dtype).regime == "warp"
    assert launch(4, warp_top + 16, dtype).regime == "cta"
    assert launch(4, _cta_cap(dtype), dtype).regime == "cta"
    assert launch(4, _cta_cap(dtype) + 16, dtype).regime == "cluster"
    assert launch(4, _cluster_cap(dtype), dtype).cluster == geo.QUANT_MAX_CLUSTER
    assert launch(4, _cluster_cap(dtype) + 1, dtype).regime == "two_pass"
    with pytest.raises(ValueError):
        launch(4, 16, "float16")
    with pytest.raises(ValueError):
        launch(0, 16, dtype)


# the main paths' rows: (shape, dtype, regime, role)
MAIN_PATH_ROWS = [
    ((128, 64), "bfloat16", "narrow", "int8 KV decode write, 16 slots x 8 kv heads"),
    ((4 * 8, 64), "bfloat16", "narrow", "int8 KV decode write, 4 slots x 8 kv heads"),
    ((24576, 32), "float32", "narrow", "granite-moe router moments"),
    ((32768, 128), "float32", "narrow", "int8 ring"),
    ((786432, 512), "float32", "warp", "granite-moe w_up moments"),
    ((49155, 1024), "float32", "warp", "granite-moe tied embedding moments"),
    ((92160, 13824), "float32", "cta", "stablelm-12b w_up moments"),
    ((5120, 100352), "float32", "cluster", "stablelm-12b untied head moments"),
    ((5120, 100352), "bfloat16", "cluster", "stablelm-12b untied head, bf16"),
]


@pytest.mark.parametrize("shape,dtype,regime,role", MAIN_PATH_ROWS, ids=[r[3] for r in MAIN_PATH_ROWS])
def test_main_path_rows_land_in_their_regime(shape, dtype, regime, role):
    g = geo.quantize_launch(*shape, dtype)
    _check_launch(g, *shape, dtype)
    assert g.regime == regime, role
    if regime == "narrow":
        assert g.lanes == max(1, shape[1] // geo.QUANT_UNIT)  # a unit a lane
    if regime == "cluster":
        assert 2 <= g.cluster <= geo.QUANT_MAX_CLUSTER


def _edge_widths():
    out = []
    for dtype in ("float32", "bfloat16"):
        warp_top = geo.QUANT_LANE_BYTES * 32 // ESZ[dtype]
        for cols in (1, 17, 256, 272, warp_top, warp_top + 16, _cta_cap(dtype), _cta_cap(dtype) + 16,
                     100352, _cluster_cap(dtype), _cluster_cap(dtype) + 16):
            out.append((cols, dtype))
        out.append((_cta_cap(dtype) + 33, dtype))  # a ragged cluster width
    return out


@pytest.mark.parametrize("cols,dtype", _edge_widths())
def test_plain_quantize_matches_pallas_at_regime_edges(cols, dtype):
    """Codes bit-equal to the Pallas kernel's.  Its scale is bit-equal to the
    plain version's true division ``amax / 127`` or, where XLA rewrote that
    division inside ``jit`` as ``amax * (1/127)``, bit-equal to that product;
    the Pallas codes are then ``rint(x / scale)`` at its own scale, bit for
    bit.  The plain version is also bit-equal to the JAX package's eager
    ``ref.quantize_int8`` on the same rows."""
    R = 4
    rng = np.random.default_rng(cols)
    x = (rng.standard_normal((R, cols)) * rng.choice([1e-3, 1.0, 1e3], (R, 1))).astype(np.float32)
    x[1] = 0.0  # a zero row
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xf = np.array(jx, np.float32)  # the values both sides see
    jq, js = (np.asarray(a) for a in jqt.quantize_int8(jx, block_rows=R, interpret=True))
    q, s = ref.quantize_int8(torch.from_numpy(xf).to(getattr(torch, dtype)))
    q, s = q.numpy(), s.numpy()
    amax = np.abs(xf).max(axis=1, keepdims=True)
    xla = np.where(amax > 0, amax * np.float32(1.0 / 127.0), np.float32(1.0)).astype(np.float32)
    assert ((js == s) | (js == xla)).all()
    same = (js == s)[:, 0]
    np.testing.assert_array_equal(q[same], jq[same])
    own = np.clip(np.rint(xf / js), -127, 127).astype(np.int8)  # f32 true division, half to even
    np.testing.assert_array_equal(jq, own)
    rq, rs = jref.quantize_int8(jx)
    np.testing.assert_array_equal(q, np.asarray(rq))
    np.testing.assert_array_equal(s, np.asarray(rs))
    assert (s[1] == 1.0).all() and (q[1] == 0).all()
