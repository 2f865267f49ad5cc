"""The backward kernels' plain versions and autograd Functions on the CPU
against ``jax.vjp`` of the JAX package's oracles, their launch geometry, and
training steps through them against the JAX package's.

The flash backward (``ref.attention_backward`` from the forward's ``lse``,
``ref.attention_lse``) and the scan backward (``ref.selective_scan_backward``
and the chunked ``ref.selective_scan_chunked_backward``, the CUDA kernel's
passes) are held to ``jax.vjp`` of ``repro.kernels.ref.attention`` and
``repro.kernels.ref.selective_scan``; ``FlashAttentionFn`` and ``ScanFn``
are run with the plain versions in place of the kernels (on the card the
same Functions wrap the launches).  Tolerances: f32 1e-5 absolute and
relative (the formulas are exact; only the order of f32 sums differs), bf16
5e-2 (the kernel tests' bf16 tolerance: one bf16 rounding of inputs,
outputs and gradients).  The train steps are falcon-mamba (the scan's
backward) and jamba (attention, Mamba and MoE in one model) at
``reduced()``, f32, against the jitted JAX step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxShape
from repro.core.space import SchedulePlan as JaxPlan
from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro.training import optimizer as joptim
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.space import SchedulePlan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import geometry, ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import make_train_step

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
DTYPES = {"float32": (torch.float32, jnp.float32, F32), "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, exp, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(exp, np.float32), err_msg=what,
                               **tol)


# ---------------------------------------------------------------------------
# flash attention
def _attn_inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, do


ATTN_CASES = [  # (B, Hq, Hkv, Sq, Skv, D): GQA groups 1, 2 and 4; Sq < Skv
    (2, 4, 4, 24, 24, 16),
    (1, 4, 2, 32, 32, 32),
    (2, 8, 2, 16, 16, 16),
    (1, 4, 2, 10, 30, 16),
    (1, 4, 1, 7, 40, 32),
    (1, 4, 2, 16, 24, 160),  # stablelm-12b's head_dim, Sq < Skv
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_attention_backward_plain_matches_jax_vjp(shape, causal, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, do = _attn_inputs(*shape, seed=sum(shape))
    exp_o, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal),
                         *(jnp.asarray(x, jdt) for x in (q, k, v)))
    exp = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (_t(x).to(tdt) for x in (q, k, v, do))
    o, lse = ref.attention_lse(tq, tk, tv, causal=causal)
    assert o.dtype == tdt and lse.dtype == torch.float32 and lse.shape == shape[:2] + (shape[3],)
    _close(o, exp_o, tol, "o")
    got = ref.attention_backward(tq, tk, tv, lse, tdo, causal=causal)
    for name, g, e, t in zip(("dq", "dk", "dv"), got, exp, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
        _close(g, e, tol, name)


@pytest.mark.parametrize("shape", ATTN_CASES[1:4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_with_plain_launchers_matches_jax_vjp(shape, causal):
    q, k, v, do = _attn_inputs(*shape, seed=7)
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(
        *ts, causal, lambda *t: ref.attention_lse(*t, causal=causal),
        lambda *t: ref.attention_backward(*t, causal=causal))
    got = torch.autograd.grad(out, ts, _t(do))
    exp_o, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal), *map(jnp.asarray, (q, k, v)))
    _close(out, exp_o, F32)
    for g, e in zip(got, vjp(jnp.asarray(do))):
        _close(g, e, F32)


def test_attention_row_that_sees_no_key_gives_zero_output_and_gradient():
    # causal with Sq > Skv: the first Sq - Skv rows see no key (lse = -inf)
    q, k, v, do = (_t(x) for x in _attn_inputs(1, 2, 1, 12, 8, 16, seed=3))
    o, lse = ref.attention_lse(q, k, v, causal=True)
    assert torch.isneginf(lse[:, :, :4]).all() and lse[:, :, 4:].isfinite().all()
    assert (o[:, :, :4] == 0).all()
    dq, dk, dv = ref.attention_backward(q, k, v, lse, do, causal=True)
    assert all(bool(g.isfinite().all()) for g in (dq, dk, dv))
    assert (dq[:, :, :4] == 0).all()
    # the rows that see keys get jax.vjp's gradients over those rows alone
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=True),
                     *(jnp.asarray(x.numpy()) for x in (q[:, :, 4:], k, v)))
    exp = vjp(jnp.asarray(do[:, :, 4:].numpy()))
    for g, e in zip((dq[:, :, 4:], dk, dv), exp):
        _close(g, e, F32)


def test_flash_wrapper_on_the_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v, do = _attn_inputs(1, 4, 2, 16, 16, 16, seed=4)
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    fa.LAUNCHES.reset()
    fa.BWD_LAUNCHES.reset()
    out = ops.attention(*ts, causal=True)
    got = torch.autograd.grad(out, ts, _t(do))
    assert fa.LAUNCHES.count == 0 and fa.BWD_LAUNCHES.count == 0
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=True), *map(jnp.asarray, (q, k, v)))
    for g, e in zip(got, vjp(jnp.asarray(do))):
        _close(g, e, F32)


@pytest.mark.parametrize("head_dim", geometry.FLASH_BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_backward_launch_matches_the_kernel_layout(head_dim, dtype):
    launch = geometry.flash_backward_launch(2, 16, 8, 4096, 4000, head_dim, dtype)
    (kc, kr), (qr, qc) = launch.dkdv_tile, launch.dq_tile
    if dtype == "bfloat16":
        # a producer and consumer warpgroups of 64 rows: two for dQ (128
        # query rows a block), two for dK/dV (128 keys) but one at head_dim
        # 160 (64 keys); the dK/dV ring stages 64 q rows (16 at head_dim 128
        # and 160), the dQ ring 64 keys (32 at 160), four stages each;
        # 1,024 bytes of alignment slack, the block's own rows once (bf16),
        # the ring (dK/dV also the stage's lse and Delta in f32), 8-byte
        # mbarriers (one for the own rows, two a stage)
        kv_consumers = 1 if head_dim == 160 else 2
        assert launch.dkdv_threads == 128 * (kv_consumers + 1) and launch.dq_threads == 384
        assert kc == 64 * kv_consumers and qr == 128
        assert kr == (64 if head_dim <= 64 else 16) and qc == (32 if head_dim == 160 else 64)
        bars = 8 * (1 + 2 * 4)
        assert launch.dkdv_smem == 1024 + 2 * kc * head_dim * 2 + 4 * (2 * kr * head_dim * 2 + 2 * kr * 4) + bars
        assert launch.dq_smem == 1024 + 2 * qr * head_dim * 2 + 4 * 2 * qc * head_dim * 2 + bars
        # lse (log2 units) and Delta, each of 4096 rows padded to a multiple of 64
        assert launch.scratch_floats == 2 * 2 * 16 * 4096
    else:
        # a thread a row (two at head_dim 160, 80 columns each), 64 rows a
        # block: its own rows padded to D + 1 floats, 16 of the other side
        # staged, and (dK/dV) their lse and Delta
        lanes = 2 if head_dim == 160 else 1
        assert launch.dkdv_threads == launch.dq_threads == 64 * lanes
        assert (kc, kr, qr, qc) == (64, 16, 64, 16)
        own = 2 * 64 * (head_dim + 1) * 4
        assert launch.dkdv_smem == own + 2 * 16 * head_dim * 4 + 2 * 16 * 4
        assert launch.dq_smem == own + 2 * 16 * head_dim * 4
        assert launch.scratch_floats == 2 * 16 * 4096  # Delta
    assert max(launch.dkdv_smem, launch.dq_smem) <= geometry.SMEM_PER_BLOCK
    # the tile index is the grid's slowest axis: the causally heavy tiles launch first
    assert launch.dkdv_grid == (8, 2, -(-4000 // kc)) and launch.dq_grid == (16, 2, -(-4096 // qr))


@pytest.mark.parametrize("head_dim", geometry.FLASH_BWD_HEAD_DIMS)
def test_flash_backward_bf16_tiles_threads_ring_and_smem_fit_a_hopper_block(head_dim):
    launch = geometry.flash_backward_launch(1, 32, 8, 4096, 4096, head_dim, "bfloat16")
    (kc, kr), (qr, qc) = launch.dkdv_tile, launch.dq_tile
    # each consumer's rows are one wgmma M of 64; a stage's rows are a wgmma N
    # (a multiple of 8 up to 256) and whole 16-row k-steps of the products over rows
    assert kc % 64 == 0 and qr == 2 * 64 and all(r % 16 == 0 and 16 <= r <= 256 for r in (kr, qc))
    assert geometry.FLASH_BWD_STAGES >= 2 and max(launch.dkdv_smem, launch.dq_smem) <= geometry.SMEM_PER_BLOCK
    share = {}
    for name, threads in (("dkdv", launch.dkdv_threads), ("dq", launch.dq_threads)):
        assert threads <= geometry.MAX_BLOCK_THREADS
        # the launch bound's share of the register file (at most 255 a thread)
        share[name] = min(255, geometry.REGISTERS_PER_SM // threads // 8 * 8)
        if threads > 256:
            # what the kernel's setmaxnreg hands out (one producer warpgroup
            # at 40, the consumers at 232) within it
            consumers = threads // 128 - 1
            assert 40 * 128 + 232 * 128 * consumers <= share[name] * threads
        else:
            assert threads == 256  # one consumer: no setmaxnreg, each warpgroup keeps its share
    # the accumulators a consumer thread holds within the registers its kernel
    # is compiled for (the launch share), with room to address: dK/dV holds dK
    # and dV (D/2 floats each) and S^T, dP^T (kr/2 each); dQ holds dQ (D/2)
    # and S, dP (qc/2 each)
    assert 2 * head_dim // 2 + 2 * kr // 2 <= share["dkdv"] - 8
    assert head_dim // 2 + 2 * qc // 2 <= share["dq"] - 8


@pytest.mark.parametrize("bad", [
    dict(head_dim=96), dict(dtype="float16"), dict(q_heads=12, kv_heads=8)])
def test_flash_backward_launch_refuses_what_the_kernel_is_not_built_for(bad):
    kw = dict(batch=1, q_heads=16, kv_heads=8, seq_q=64, seq_kv=64, head_dim=64, dtype="bfloat16")
    with pytest.raises(ValueError):
        geometry.flash_backward_launch(**{**kw, **bad})


# ---------------------------------------------------------------------------
# selective scan
def _scan_inputs(B, L, Di, N, seed, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, L, Di)).astype(np.float32)
    # softplus; dt_shift -4 gives dt ~ 0.02, a state that lives across chunks,
    # and +3 gives dt ~ 3, where exp(dt A) underflows toward 0
    dt = np.logaddexp(rng.standard_normal((B, L, Di)) + dt_shift, 0).astype(np.float32)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    D = np.linspace(0.1, 1.0, Di).astype(np.float32)
    gy = rng.standard_normal((B, L, Di)).astype(np.float32)
    return (u, dt, A, Bm, Cm, D), gy


SCAN_CASES = [  # (B, L, Di, N, chunk, dt_shift)
    (2, 32, 8, 4, 32, 0.0),    # one chunk: the output pass alone
    (1, 64, 16, 16, 16, 0.0),  # 4 chunks
    (2, 48, 8, 8, 16, -4.0),   # 3 chunks, slow decay: adjoints carried across chunks
    (1, 40, 8, 4, 8, 0.0),     # 5 chunks
    (1, 64, 8, 16, 4, -4.0),   # 16 chunks, slow decay
    (2, 24, 8, 8, 8, 3.0),     # large dt: a_t underflows
]


def _jax_scan_vjp(args, gy, jdt=jnp.float32):
    j = [jnp.asarray(a, jnp.float32 if i in (2, 5) else jdt) for i, a in enumerate(args)]
    out, vjp = jax.vjp(jref.selective_scan, *j)
    return out, vjp(jnp.asarray(gy, jdt))


@pytest.mark.parametrize("B,L,Di,N,chunk,dt_shift", SCAN_CASES)
def test_selective_scan_backward_plain_and_chunked_match_jax_vjp(B, L, Di, N, chunk, dt_shift):
    args, gy = _scan_inputs(B, L, Di, N, seed=L + N, dt_shift=dt_shift)
    _, exp = _jax_scan_vjp(args, gy)
    ts = [_t(a) for a in args]
    plain = ref.selective_scan_backward(*ts, _t(gy))
    chunked = ref.selective_scan_chunked_backward(*ts, _t(gy), chunk)
    names = ("du", "ddt", "dA", "dBm", "dCm", "dD")
    for name, p, c, e, t in zip(names, plain, chunked, exp, ts):
        assert p.shape == c.shape == t.shape and p.dtype == c.dtype == t.dtype, name
        _close(p, e, F32, name)
        _close(c, e, F32, name + " chunked")


@pytest.mark.parametrize("chunk", [8, 32])
def test_selective_scan_backward_bf16_returns_the_inputs_dtypes(chunk):
    args, gy = _scan_inputs(1, 32, 16, 8, seed=11)
    _, exp = _jax_scan_vjp(args, gy, jnp.bfloat16)
    ts = [_t(a).to(torch.bfloat16) if i not in (2, 5) else _t(a) for i, a in enumerate(args)]
    got = ref.selective_scan_chunked_backward(*ts, _t(gy).to(torch.bfloat16), chunk)
    for g, e, t in zip(got, exp, ts):
        assert g.dtype == t.dtype
        _close(g, e, BF16)


def test_selective_scan_chunked_backward_refuses_a_chunk_that_does_not_divide_L():
    args, gy = _scan_inputs(1, 24, 8, 4, seed=1)
    with pytest.raises(ValueError, match="does not divide"):
        ref.selective_scan_chunked_backward(*(_t(a) for a in args), _t(gy), 16)


@pytest.mark.parametrize("B,L,Di,N,chunk,dt_shift", SCAN_CASES[1:4])
def test_scan_function_with_plain_launchers_matches_jax_vjp(B, L, Di, N, chunk, dt_shift):
    args, gy = _scan_inputs(B, L, Di, N, seed=5, dt_shift=dt_shift)
    ts = [_t(a).requires_grad_() for a in args]
    saved = []

    def launch(*t):
        return ref.selective_scan_chunked(*t, chunk), None

    def launch_backward(*t):
        saved.append(t[6])
        return ref.selective_scan_chunked_backward(*t[:6], t[7], chunk)

    y = ss.ScanFn.apply(*ts, launch, launch_backward)
    got = torch.autograd.grad(y, ts, _t(gy))
    exp_y, exp = _jax_scan_vjp(args, gy)
    _close(y, exp_y, F32)
    for g, e in zip(got, exp):
        _close(g, e, F32)
    assert saved == [None]  # the plain forward keeps no scratch


def test_scan_function_returns_only_the_gradients_asked_for():
    args, gy = _scan_inputs(1, 16, 8, 4, seed=6)
    ts = [_t(a).requires_grad_(i in (0, 2)) for i, a in enumerate(args)]
    y = ss.ScanFn.apply(*ts, lambda *t: (ref.selective_scan(*t), None),
                        lambda *t: ref.selective_scan_backward(*t[:6], t[7]))
    du, dA = torch.autograd.grad(y, (ts[0], ts[2]), _t(gy))
    _, exp = _jax_scan_vjp(args, gy)
    _close(du, exp[0], F32)
    _close(dA, exp[2], F32)


def test_scan_wrapper_on_the_cpu_takes_the_plain_version_and_counts_nothing():
    args, gy = _scan_inputs(2, 16, 8, 4, seed=8)
    ts = [_t(a).requires_grad_() for a in args]
    ss.LAUNCHES.reset()
    ss.BWD_LAUNCHES.reset()
    y = ops.selective_scan(*ts, tiles=ops.KernelTiles(scan_chunk=8, scan_d_block=8))
    got = torch.autograd.grad(y, ts, _t(gy))
    assert ss.LAUNCHES.count == 0 and ss.BWD_LAUNCHES.count == 0
    _, exp = _jax_scan_vjp(args, gy)
    for g, e in zip(got, exp):
        _close(g, e, F32)


@pytest.mark.parametrize("chunk,smem", [(64, 91136), (128, 95232), (256, 103424)])
def test_scan_backward_smem_formula_matches_kernel_layout(chunk, smem):
    # B and C of a segment of at most 64 steps (2 x 64 x 16 f32), its
    # checkpoints (64 / 4 of 256 threads x 4 states f32) and the chunk's other
    # segments' start states (likewise, chunk / 64 - 1 of them), the warps'
    # per-step dB, dC sums over a span (2 buffers x 8 warps x 4 steps x 32)
    # and a span's dt, u and gy (3 buffers x 3 x 4 steps x 64 channels)
    assert geometry.scan_backward_smem_bytes(chunk) == smem
    per_thread = 256 * 4
    assert smem == 4 * (2 * 64 * 16 + (16 + chunk // 64 - 1) * per_thread + 2 * 8 * 4 * 32 + 3 * 3 * 4 * 64)


@pytest.mark.parametrize("chunk", geometry.SCAN_CHUNK_OPTIONS)
def test_scan_backward_output_pass_holds_two_blocks_an_sm(chunk):
    launch = geometry.scan_backward_launch(1, 4096, 8192, 16, "bfloat16", chunk, 256)
    # at most half of an SM's 228 KB with the runtime's reserve: two blocks an SM
    assert launch.smem_bytes + geometry.SMEM_RESERVED_PER_BLOCK <= geometry.SMEM_PER_SM // 2
    assert geometry.SMEM_PER_SM == 228 * 1024 and launch.blocks_per_sm == 2
    # 256 threads of 4 states: 64 channels in flight, the tile's 256 in four groups
    assert launch.threads == 256 and geometry.SCAN_BWD_CHANNELS == 64


def test_scan_backward_launch_at_falcon_mamba_training():
    launch = geometry.scan_backward_launch(1, 4096, 8192, 16, "bfloat16", 128, 256)
    assert (launch.chunk, launch.d_block, launch.threads) == (128, 256, 256)
    assert launch.grid == (1, 32, 32) and launch.kernels == 4 and launch.blocks_per_sm == 2
    # adjoint carries and sums of dt, partial dB/dC rows of 32 channel
    # blocks, partial dA/dD of 32 chunks: 52.4 MB of f32
    per_chunk = 32 * 8192 * 17
    assert launch.scratch_floats == per_chunk + 2 * 4096 * 32 * 16 + per_chunk
    one = geometry.scan_backward_launch(2, 64, 32, 8, "float32", 128, 16)
    assert one.chunk == 64 and one.kernels == 2  # chunk == L: no adjoint carries
    assert one.scratch_floats == 2 * 2 * 64 * 2 * 8 + 2 * 32 * 9


def test_scan_backward_launch_refuses_a_chunk_whose_backward_does_not_fit():
    # the output pass holds a segment of 64 steps at a time, so its shared
    # memory grows by one start state (4 KB) a segment: it launches at every
    # chunk the forward takes, up to the forward's largest (1,816 steps)
    for chunk in (512, 1024, 1816):
        geometry.scan_launch(1, chunk, 256, 16, "bfloat16", chunk, 256)
        bwd = geometry.scan_backward_launch(1, chunk, 256, 16, "bfloat16", chunk, 256)
        assert bwd.smem_bytes == geometry.scan_backward_smem_bytes(chunk) <= geometry.SMEM_PER_BLOCK
    # a chunk no block holds is refused, for the backward as for the forward
    with pytest.raises(ValueError, match="shared memory"):
        geometry.scan_backward_launch(1, 4096, 256, 16, "bfloat16", 4096, 256)


def test_launch_counters_name_the_backward_kernels():
    assert ops.COUNTERS["flash_attention_backward"] is fa.BWD_LAUNCHES
    assert ops.COUNTERS["selective_scan_backward"] is ss.BWD_LAUNCHES
    fa.BWD_LAUNCHES.add(tile=((64, 64), (64, 64)))
    ss.BWD_LAUNCHES.add()
    assert ops.launch_counts()["flash_attention_backward"] == 1
    ops.reset_counters()
    assert set(ops.launch_counts().values()) == {0} and fa.BWD_LAUNCHES.tiles == set()


# ---------------------------------------------------------------------------
# train steps through the backward formulas, against the JAX package's
B, S = 4, 16


def _batch(toks):
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    return {"inputs": _t(toks).long(), "labels": _t(toks).long(), "positions": _t(pos).long()}


def _jax_batch(toks):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return {"inputs": jnp.asarray(toks), "labels": jnp.asarray(toks), "positions": jnp.asarray(pos)}


def _jax_leaves(tree) -> dict:
    return {".".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _model(arch, seed):
    """Reduced ``arch`` with JAX weights; a router scaled up so the top-k
    routing has no near-ties that rounding could flip."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 50 if "router" in jax.tree_util.keystr(path) else x, jp)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, B, S)).astype(np.int32)
    return jcfg, cfg, jp, toks


def _steps_match(jcfg, cfg, jp, toks, plan_kw, tol=1e-4):
    oc_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxShape("t", S, B, "train"), JaxPlan(**plan_kw),
                                        joptim.OptimizerConfig(**oc_kw)))
    step = make_train_step(cfg, None, SchedulePlan(**plan_kw), optim.OptimizerConfig(**oc_kw),
                           device="cpu")
    jstate = joptim.init_opt_state(jp, joptim.OptimizerConfig(**oc_kw))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state = optim.init_opt_state(params, optim.OptimizerConfig(**oc_kw))
    before = {k: v.clone() for k, v in optim.leaves(params)}
    for i in range(2):
        jp, jstate, jm = jstep(jp, jstate, _jax_batch(toks[i]))
        params, state, m = step(params, state, _batch(toks[i]))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=tol, atol=tol)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=tol)
    jl = _jax_leaves(jp)
    for path, p in optim.leaves(params):
        assert not torch.equal(p, before[path]), path  # every leaf moved (A_log and Dp too)
        np.testing.assert_allclose(p.detach().numpy(), jl[path], rtol=tol, atol=tol, err_msg=path)
    return params


@pytest.fixture(scope="module")
def mamba_model():
    return _model("falcon-mamba-7b", 5)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_falcon_mamba_train_step_matches_jax(mamba_model, microbatches, remat):
    params = _steps_match(*mamba_model, dict(microbatches=microbatches, remat=remat, scan_chunk=8))
    assert {"A_log", "Dp"} <= {p.split(".")[-1] for p, _ in optim.leaves(params)}


def test_jamba_train_step_matches_jax():
    # attention (flash backward), Mamba (scan backward) and MoE (moe_gemm
    # backward) in one reduced model of 8 layers
    jcfg, cfg, jp, toks = _model("jamba-1.5-large-398b", 6)
    assert {s.mixer for s in cfg.layer_plan()} == {"attn", "mamba"}
    assert any(s.mlp == "moe" for s in cfg.layer_plan())
    _steps_match(jcfg, cfg, jp, toks, dict(microbatches=2, remat="none", scan_chunk=8))


def test_stablelm_train_step_matches_jax():
    # layernorm, 25 % partial rotary and the flash backward at head_dim 160
    # in one reduced model (its reduced() shrinks the head to 16)
    arch = "stablelm-12b"
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), head_dim=160)
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=160)
    assert cfg.norm == "layernorm" and cfg.rotary_pct == 0.25 and cfg.resolved_head_dim == 160
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(7))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, B, S)).astype(np.int32)
    _steps_match(jcfg, cfg, jp, toks, dict(microbatches=2, remat="full"))


def test_train_cli_trains_falcon_mamba_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                       "--plan-json", '{"remat": "full", "opt_dtype": "int8", "scan_chunk": 8}']) == 0
    assert "done at step 2" in capsys.readouterr().out
