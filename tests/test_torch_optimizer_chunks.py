"""The optimizer's chunks and the forward's one unbind per stacked leaf.

``optimizer.apply_updates`` reads, updates and writes each leaf in runs of
its leading axis of at most ``CHUNK_ELEMS`` elements (``optimizer.chunks``),
and ``global_norm`` sums each chunk's sum of squares.  At a clip scale of
exactly 1 the chunked update must equal the whole-leaf update bit for bit
(``torch_dist_cases.whole_leaf_apply_updates``, the update as it was), on
one device and over a (1, 2) gloo mesh whose shards split a leaf's last
axis (one amax exchange a chunk) and its first; the norm must stay within
1e-6 relative of the whole-leaf one.  ``transformer.forward`` hands each
period the views of one ``unbind`` of every stacked leaf: its gradients
must equal those of a loop over ``period_params`` (a select a period) under
each remat policy.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_cases as dc
from repro_torch.configs import get_config
from repro_torch.core.space import MeshSpec
from repro_torch.kernels.ops import DEFAULT_TILES
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import losses
from repro_torch.models import transformer as ttf
from repro_torch.sharding.parallel import ParallelContext
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import make_positions

torch.set_num_threads(1)

# clip_norm so large that the clip scale is exactly 1: the chunked norm's
# other order of sums then cannot reach the update
OC_KW = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1e30)


def _tree(seed: int = 0) -> dict:
    """Every kind of leaf: a stacked norm (2-D: decayed and int8-quantized,
    as in the JAX package), a stacked matrix, a last axis below 16, a plain
    matrix and a 1-D vector."""
    rng = np.random.default_rng(seed)
    return {
        "blocks": {"b0": {
            "norm1": (1 + 0.1 * rng.standard_normal((8, 64))).astype(np.float32),
            "w": (0.05 * rng.standard_normal((4, 32, 48))).astype(np.float32),
            "narrow": (0.05 * rng.standard_normal((4, 32, 8))).astype(np.float32),
        }},
        "embed": (0.05 * rng.standard_normal((100, 64))).astype(np.float32),
        "final_norm": (1 + 0.1 * rng.standard_normal((64,))).astype(np.float32),
    }


# a (1, 2) mesh: the stacked norm and matrix split on their last axis (an
# int8 row's amax over both ranks), the embedding on its first (plain
# tuples, made PartitionSpecs in the ranks)
SPECS = {
    "blocks": {"b0": {"norm1": (None, "model"), "w": (None, None, "model"),
                      "narrow": (None, None, None)}},
    "embed": ("model", None),
    "final_norm": (None,),
}


@pytest.mark.parametrize("shape, want", [
    ((64, 4096, 16384), [1] * 64),  # falcon-mamba-7b's in_proj: a period a chunk
    ((40, 5120, 13824), [1] * 40),  # stablelm-12b's w_up: one period is over the budget
    ((100352, 5120), [13107] * 7 + [8603]),  # stablelm-12b's embedding
    ((64, 4096), [64]),  # a stacked norm: one chunk
    ((24, 32, 1024, 512), [4] * 6),  # granite-moe's experts
    ((3,), [3]),
    ((0, 16), [0]),
])
def test_chunks_split_the_leading_axis_within_the_budget(shape, want):
    got = optim.chunks(shape)
    assert [c.stop - c.start for c in got] == want
    assert got[0].start == 0 and got[-1].stop == shape[0]
    assert all(a.stop == b.start for a, b in zip(got, got[1:]))
    row = int(np.prod(shape[1:]))
    assert all((c.stop - c.start) * row <= max(optim.CHUNK_ELEMS, row) for c in got)
    assert optim.chunks(()) == [...]


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_chunked_update_equals_the_whole_leaf_update_on_one_device(moment_dtype, monkeypatch):
    monkeypatch.setattr(optim, "CHUNK_ELEMS", 256)
    res = dc.chunked_update_case(None, _tree(), SPECS, 256, dict(OC_KW, moment_dtype=moment_dtype))
    _check(res, moment_dtype, {"blocks.b0.norm1": 2, "blocks.b0.w": 4, "blocks.b0.narrow": 4,
                               "embed": 25, "final_norm": 1})


@pytest.fixture(scope="module")
def mesh12_runs():
    """One spawn of a (1, 2) gloo mesh: f32 and int8 moments."""
    cases = [dict(tree=_tree(), specs=SPECS, chunk_elems=128, oc_kw=dict(OC_KW, moment_dtype=d))
             for d in ("float32", "int8")]
    ranks = run_on_mesh(MeshSpec(("data", "model"), (1, 2)), dc.chunked_update_cases, cases,
                        device="cpu")
    return dict(zip(("float32", "int8"), zip(*ranks)))


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_chunked_update_equals_the_whole_leaf_update_on_a_1x2_mesh(mesh12_runs, moment_dtype):
    for res in mesh12_runs[moment_dtype]:  # each rank's shards
        _check(res, moment_dtype, {"blocks.b0.norm1": 2, "blocks.b0.w": 4, "blocks.b0.narrow": 4,
                                   "embed": 25, "final_norm": 1})


def _check(res: dict, moment_dtype: str, chunks: dict) -> None:
    assert res["differ"] == []
    assert res["chunks"] == chunks  # every leaf but the vector splits
    want_int8 = ["blocks.b0.norm1", "blocks.b0.w", "embed"] if moment_dtype == "int8" else []
    assert res["int8"] == want_int8
    for c, w in zip(res["metrics"]["chunked"], res["metrics"]["whole"], strict=True):
        assert c["lr"] == w["lr"]
        assert abs(c["grad_norm"] - w["grad_norm"]) <= 1e-6 * w["grad_norm"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_global_norm_within_1e6_of_the_whole_leaf_norm(dtype, monkeypatch):
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(rng.standard_normal((64, 128, 96)).astype(np.float32)).to(dtype),
            "b": torch.from_numpy((1e3 * rng.standard_normal((5000, 40))).astype(np.float32)).to(dtype),
            "c": torch.from_numpy(rng.standard_normal((7,)).astype(np.float32)).to(dtype)}
    whole = dc.whole_leaf_global_norm(tree).item()
    monkeypatch.setattr(optim, "CHUNK_ELEMS", 4096)
    assert len(optim.chunks(tree["a"].shape)) == 64 and len(optim.chunks(tree["b"].shape)) == 50
    got = optim.global_norm(tree).item()
    assert abs(got - whole) <= 1e-6 * whole, (got, whole)


# ---------------------------------------------------------------------------
def _select_forward(params, cfg, inputs, positions, remat):
    """``transformer.forward`` as it was: period ``p`` gets
    ``period_params(params["blocks"], p)``, a select of every stacked leaf."""
    plan = cfg.layer_plan()
    par = ParallelContext.local(params).for_seq(inputs.shape[1])
    h = ttf._embed(params, cfg, inputs, positions, par)
    body = ttf._maybe_remat(ttf._period_forward, remat)
    for p in range(cfg.n_periods):
        h = body(ttf.period_params(params["blocks"], p), h, positions, plan, cfg, DEFAULT_TILES, par)
    return ttf._logits(params, cfg, h, par)


def _grads(forward, params, cfg, tokens, positions, remat):
    paths, leaves = zip(*optim.leaves(params))
    logits = forward(params, cfg, tokens, positions, remat)
    loss = losses.cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_unbind_gradient_equals_the_select_loop(arch, remat):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)  # three periods
    params = ttf.init_params(cfg, 0, device="cpu")
    for _, p in optim.leaves(params):
        p.requires_grad_(True)
    B, S = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)))
    positions = make_positions(cfg, B, S, device="cpu")

    def unbind_forward(params, cfg, inputs, positions, remat):
        return ttf.forward(params, cfg, inputs, positions, remat=remat)

    loss_u, got = _grads(unbind_forward, params, cfg, tokens, positions, remat)
    loss_s, want = _grads(_select_forward, params, cfg, tokens, positions, remat)
    assert torch.equal(loss_u, loss_s)
    assert list(got) == list(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path
    assert params["blocks"]["b0"]["norm1"].shape[0] == cfg.n_periods == 3
