"""Decode attention over the KV cache (``kernels/decode_attention.py``).

On the CPU: the plain version is the decode step's attention as it stood
before the kernel, bit for bit; its ``lse`` is the log-sum-exp of the
masked logits; ``softmax_combine`` from each rank's ``lse`` equals the
combine from the logits on a gloo mesh split by position; the chunking
depends on the cache's length and ``B * Hk`` alone; the dry run records
the kernel.  On a card (skipped here, run there by ``python -m pytest -q
tests/test_torch_decode_attention.py``): the kernel against the plain
version at head_dim 64, 128 and 160, int8 and bf16 caches, 1 to 8 query
heads a KV head, and a serve step at the benchmark cell's shapes.  This
file imports no JAX.
"""
import numpy as np
import pytest
import torch

import torch_dist_cases as dc
from repro_torch.configs import get_config
from repro_torch.core.space import MeshSpec, SchedulePlan
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, work
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import transformer

torch.set_num_threads(1)


def _cache(rng, B, Hq, Hk, L, hd, kv: str):
    """q, K, V (and an int8 cache's scales) drawn with numpy: N(0, 1) q and
    N(0, 3^2) K/V rows, int8 as rowwise codes and scales."""
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd)).astype(np.float32))
    k, v = (torch.from_numpy(3 * rng.standard_normal((B, Hk, L, hd)).astype(np.float32)) for _ in range(2))
    if kv != "int8":
        return q, k.to(getattr(torch, kv)), v.to(getattr(torch, kv)), None, None
    out = [q]
    for x in (k, v):
        codes, scale = ops.quantize_int8(x.reshape(-1, hd))
        out.append((codes.view(B, Hk, L, hd), scale.view(B, Hk, L, 1)))
    return out[0], out[1][0], out[2][0], out[1][1], out[2][1]


def _attend_as_before(q, k, v, k_s, v_s, cur, o):
    """The decode step's attention over its cache as the port ran it before
    the kernel (``models/attention.decode_step``), on one device."""
    B, Hq, hd = q.shape
    L = k.shape[2]
    int8_kv = k_s is not None
    if int8_kv:
        k_scale = k_s[..., 0][:, :, None, None, :]
        v_scale = v_s[..., 0][:, :, None, None, :]
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    Hk = k.shape[1]
    qg = q[:, :, None].reshape(B, Hk, Hq // Hk, 1, hd)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg.float(), k.float()) * (hd ** -0.5)
    if int8_kv:
        logits = logits * k_scale
    t = torch.arange(o, o + L)
    lim = cur[:, None, None, None, None] if cur.ndim == 1 else cur
    logits = logits.masked_fill(~(t <= lim), -1e30)
    probs = torch.softmax(logits, dim=-1)
    if int8_kv:
        probs = probs * v_scale
    att = torch.einsum("bkgqt,bktd->bkgqd", probs, v.float())
    return att.reshape(B, -1, 1, hd), logits


CPU_CASES = [("int8", 2, 7), ("bfloat16", 2, 7), ("float32", 1, 0), ("int8", 8, 0)]


@pytest.mark.parametrize("kv,g,o", CPU_CASES, ids=[f"{kv}-g{g}-o{o}" for kv, g, o in CPU_CASES])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-cur", "per-row-cur"])
def test_plain_version_is_the_decode_attention_as_before(kv, g, o, per_row):
    rng = np.random.default_rng(1)
    B, Hk, L, hd = 3, 2, 37, 16
    q, k, v, k_s, v_s = _cache(rng, B, g * Hk, Hk, L, hd, kv)
    cur = torch.tensor([o, o + 20, o + L - 1]) if per_row else torch.tensor(o + 30)
    ops.reset_counters()
    att, lse = ops.decode_attention(q, k, v, k_s, v_s, cur, o, hd ** -0.5)
    assert ops.launch_counts()["decode_attention"] == 0  # a CPU tensor: the plain version
    exp, _ = _attend_as_before(q, k, v, k_s, v_s, cur, o)
    assert att.dtype == lse.dtype == torch.float32
    assert torch.equal(att.reshape(B, -1, 1, hd), exp)


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_plain_lse_is_the_logsumexp_of_the_masked_logits(kv):
    rng = np.random.default_rng(2)
    B, Hq, Hk, L, hd, o = 4, 4, 2, 29, 16, 10
    q, k, v, k_s, v_s = _cache(rng, B, Hq, Hk, L, hd, kv)
    cur = torch.tensor([5, 10, 22, 40])  # row 0 sees none of [10, 39)
    _, lse = da.decode_attention_plain(q, k, v, k_s, v_s, cur, o, hd ** -0.5)
    _, logits = _attend_as_before(q, k, v, k_s, v_s, cur, o)
    assert torch.equal(lse, torch.logsumexp(logits, dim=-1).reshape(B, Hq))
    assert bool((lse[0] < -1e29).all()) and bool(lse[1:].isfinite().all())
    # a row's weight in the combine, exp(lse - max), is 0 where it sees nothing
    assert bool((torch.exp(lse[0] - lse[1:].max()) == 0).all())


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_softmax_combine_from_lse_equals_the_combine_from_logits_on_gloo(kv):
    """Four ranks of 8 positions each; row 0 at cur 3, so ranks 1-3 hold no
    position it sees; rows 1 and 2 cross shard boundaries."""
    rng = np.random.default_rng(3)
    B, Hq, Hk, L, hd = 3, 4, 2, 32, 16
    q, k, v, k_s, v_s = _cache(rng, B, Hq, Hk, L, hd, kv)
    cur = np.array([3, 17, 31])
    to_np = lambda x: None if x is None else (x.float() if x.dtype == torch.bfloat16 else x).numpy()  # noqa: E731
    arrays = [to_np(x) for x in (q, k, v, k_s, v_s)]
    if kv == "bfloat16":  # bf16 values carried as f32 numpy, exactly
        arrays[1:3] = [a.astype(np.float32) for a in arrays[1:3]]
    ranks = run_on_mesh(MeshSpec(("data", "model"), (1, 4)), dc.combine_case, *arrays, cur, "model",
                        device="cpu")
    kk, vv = (torch.from_numpy(a).to(k.dtype) for a in arrays[1:3])
    whole, _ = da.decode_attention_plain(q, kk, vv, k_s, v_s, torch.from_numpy(cur), 0, hd ** -0.5)
    # the two rules round apart: exp(lse - m) against a sum of exp(l - m)
    for new, old, lse in ranks:
        np.testing.assert_allclose(new, old, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(new, whole.numpy(), rtol=1e-5, atol=1e-5)
    assert all(bool((r[2][0] < -1e29).all()) for r in ranks[1:])  # nothing of row 0 past rank 0


def test_splits_depend_on_the_length_and_rows_times_heads_alone(monkeypatch):
    """The wrapper asks ``splits`` with the cache's length and ``B * Hk``
    only, whatever the dtype, head_dim, group or cur; every position lies in
    exactly one chunk."""
    seen = []
    real = da.splits
    monkeypatch.setattr(da, "splits", lambda L, bh: seen.append((L, bh)) or real(L, bh))
    for B, Hk, g, hd, kv, cur in [(16, 8, 2, 64, torch.int8, [16384] * 16), (8, 16, 1, 128, torch.bfloat16, 5),
                                  (32, 4, 8, 160, torch.int8, 0), (128, 1, 4, 64, torch.float32, [7] * 128)]:
        q = torch.empty((B, Hk * g, hd), dtype=torch.bfloat16, device="meta")
        k = torch.empty((B, Hk, 32768, hd), dtype=kv, device="meta")
        s = torch.empty((B, Hk, 32768, 1), device="meta") if kv == torch.int8 else None
        da.decode_attention(q, k, k, s, s, torch.tensor(cur, device="meta"), 0, hd ** -0.5)
    assert seen == [(32768, 128)] * 4
    for L in (1, 255, 256, 1001, 4097, 32768, 131072):
        for bh in (1, 8, 128, 512, 8192):
            n, chunk = da.splits(L, bh)
            assert n >= 1 and (n - 1) * chunk < L <= n * chunk
            assert n == 1 or chunk >= da.MIN_CHUNK // 2
    assert da.splits(32768, 128) == (17, 1928)  # the benchmark cell: 16 rows x 8 KV heads


def test_the_dry_run_records_a_launch_over_the_whole_cache():
    work.DRY.reset()
    B, Hq, Hk, L, hd = 16, 16, 8, 32768, 64
    q = torch.empty((B, Hq, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Hk, L, hd), dtype=torch.int8, device="meta")
    s = torch.empty((B, Hk, L, 1), device="meta")
    att, lse = ops.decode_attention(q, k, k, s, s, torch.zeros((B,), dtype=torch.long, device="meta"),
                                    0, 0.125)
    assert (att.shape, lse.shape, att.dtype) == ((B, Hq, hd), (B, Hq), torch.float32)
    assert work.DRY.launches["decode_attention"] == 1
    assert work.DRY.bytes["decode_attention"] == B * L * Hk * (2 * hd + 8) + B * Hq * hd * 2 + B * Hq * (hd + 1) * 4
    assert work.DRY.flops["decode_attention"] == 4 * hd * Hq * B * L
    assert work.DRY.plain_flops["decode_attention"] == 2 * 2 * B * Hq * L * hd  # the two einsums


def test_wrapper_refuses_what_the_kernel_cannot_read():
    meta = dict(device="meta")
    q = torch.empty((2, 4, 64), dtype=torch.bfloat16, **meta)
    k = torch.empty((2, 2, 100, 64), dtype=torch.int8, **meta)
    s = torch.empty((2, 2, 100, 1), **meta)
    cur = torch.zeros((), dtype=torch.long, **meta)
    for bad in [dict(q=torch.empty((2, 4, 96), dtype=torch.bfloat16, **meta),
                     k=torch.empty((2, 2, 100, 96), dtype=torch.int8, **meta)),  # head_dim 96
                dict(k_s=None, v_s=None),  # int8 without scales
                dict(q=torch.empty((2, 18, 64), dtype=torch.bfloat16, **meta)),  # 9 heads a group
                dict(k=torch.empty((2, 100, 2, 64), dtype=torch.int8, **meta).transpose(1, 2)),
                dict(cur=torch.zeros((3,), dtype=torch.long, **meta))]:
        args = {**dict(q=q, k=k, k_s=s, v_s=s, cur=cur), **bad}
        with pytest.raises(ValueError):
            da.decode_attention(args["q"], args["k"], args["k"], args["k_s"], args["v_s"], args["cur"],
                                0, 0.125)


# ---------------------------------------------------------------------------
# on the card
CARD_HEAD_DIMS = (64, 128, 160)
CARD_GROUPS = (1, 2, 6, 8)
# kernel against plain: both sum in f32, in other orders (the kernel over
# chunks of positions, lane groups and shuffles; the plain version in cuBLAS
# gemv), over up to ~1,000 positions here: they agree to f32 rounding
CARD_TOL = dict(rtol=1e-4, atol=1e-4)
CARD_LSE_ATOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(args):
    return tuple(None if x is None else x.cuda() for x in args)


def _check_kernel(q, k, v, k_s, v_s, cur, o):
    hd = q.shape[-1]
    da.LAUNCHES.reset()
    att, lse = da.decode_attention(q, k, v, k_s, v_s, cur, o, hd ** -0.5)
    torch.cuda.synchronize()
    assert da.LAUNCHES.count == 1
    att_p, lse_p = da.decode_attention_plain(q, k, v, k_s, v_s, cur, o, hd ** -0.5)
    seen = lse_p > -1e29
    torch.testing.assert_close(att[seen], att_p[seen], **CARD_TOL)
    torch.testing.assert_close(lse[seen], lse_p[seen], rtol=0.0, atol=CARD_LSE_ATOL)
    assert bool((lse[~seen] == -float("inf")).all()) and bool((att[~seen] == 0).all())


@pytest.mark.parametrize("g", CARD_GROUPS)
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("hd", CARD_HEAD_DIMS)
def test_kernel_matches_the_plain_version_on_the_card(hd, kv, g):
    """L = 1001 is no multiple of a chunk or of a tile; cur 0 and L - 1 among
    the rows; scalar and per-row cur."""
    _card()
    rng = np.random.default_rng(hd + g)
    L = 1001
    q, k, v, k_s, v_s = _on_card(_cache(rng, 3, 2 * g, 2, L, hd, kv))
    q = q.to(torch.bfloat16)
    for cur in (torch.tensor(L - 1), torch.tensor([0, L - 1, 517])):
        _check_kernel(q, k, v, k_s, v_s, cur.cuda(), 0)


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "float32"])
def test_kernel_reads_a_view_of_some_kv_heads_and_a_shard_of_positions_on_the_card(kv):
    """Two of four KV heads through their strides (the mesh's group slice,
    never copied), and a rank that holds positions [600, 1601), two of
    whose rows see none of them."""
    _card()
    rng = np.random.default_rng(5)
    q, k, v, k_s, v_s = _on_card(_cache(rng, 3, 4, 4, 1001, 64, kv))
    if kv == "float32":
        q = q.float()
    else:
        q = q.to(torch.bfloat16)
    part = (q, k[:, 1:3], v[:, 1:3], None if k_s is None else k_s[:, 1:3], None if v_s is None else v_s[:, 1:3])
    assert part[1].data_ptr() != k.data_ptr() and not part[1].is_contiguous()
    _check_kernel(*part, torch.tensor([7, 400, 1000]).cuda(), 0)
    _check_kernel(*part, torch.tensor([100, 599, 1700]).cuda(), 600)


def test_a_serve_step_at_the_cell_shapes_launches_24_and_holds_no_cache_sized_temporary():
    """granite-moe-1b-a400m, 16 rows over a 32k int8 cache at the cell's
    history lengths: one kernel a layer, and the step's memory over what it
    held before stays under a quarter of one layer's K codes (the plain
    version cast each layer's K and V to bf16 and f32, ~6x those codes)."""
    _card()
    from repro_torch.training.train_step import make_serve_step

    cfg = get_config("granite-moe-1b-a400m")
    B, L = 16, 32768
    params = transformer.init_params(cfg, 0, device="cuda")
    cache = transformer.init_cache(cfg, B, L, kv_dtype="int8", device="cuda")
    step = make_serve_step(cfg, None, SchedulePlan(kv_dtype="int8"), device="cuda")
    cur = torch.tensor([16384 + round(i * 12288 / 15) for i in range(B)], device="cuda")
    tok = torch.arange(B, device="cuda")[:, None]
    step(params, cache, tok, cur)  # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    logits, _ = step(params, cache, tok, cur)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers == 24
    assert bool(logits.isfinite().all())
    layer_k_codes = B * cfg.n_kv_heads * L * cfg.resolved_head_dim
    assert transient < layer_k_codes / 4, (transient, layer_k_codes)


def test_decode_step_on_the_card_attends_through_the_kernel():
    """A 2-layer f32 granite-3-2b decode step with an f32 cache (the kernel
    reads f32 caches too) on the card against the same step on the CPU,
    per-row cur: one launch a layer."""
    _card()
    import dataclasses

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2, dtype="float32")
    params = transformer.init_params(cfg, 0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 1)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else {k: v for k, v in _tree_to(params, dev).items()}
        cache = transformer.init_cache(cfg, 2, 64, device=dev)
        ops.reset_counters()
        for t in range(3):
            logits, cache = transformer.decode_step(p, cfg, cache, tok.to(dev), torch.tensor([t, t + 40], device=dev))
        out[dev] = (logits.cpu(), ops.launch_counts()["decode_attention"])
    assert out["cuda"][1] == 3 * 2 and out["cpu"][1] == 0
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}
