"""AI21-Jamba2-Mini in the port, on the CPU at its ``reduced()`` size in
float32, against the benchmark's plain reference (``cardbench/reference/
hybrid.py``), on weights drawn from a seed by the configuration file's
rules (norm weights near one, not at one, so that every norm weighs in).

Tolerances.  The port's CPU path and the reference compute the same
float32 equations in other orders: the port's matmuls over the batch as one
product, its conv and scan in its own loops, its decode over a cache; the
reference walks the scan step by step.  Logits of a few layers agree to a
few ULPs of their size, so ``TOL`` (1e-4 relative and absolute, logits of
size ~1) holds them with room; it is the port's JAX-parity tests' float32
tolerance.  The decode's SSM state is a running sum over the steps, held
to the same ``TOL``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench import draw
from cardbench.reference import hybrid as H
from cardbench.reference import model as M
from repro_torch.configs import PORT_ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig, PortConfig
from repro_torch.core.space import SchedulePlan
from repro_torch.models import mamba, moe, transformer
from repro_torch.runtime import tracing
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.train_step import make_prefill_step, make_serve_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
INIT = json.loads((REPO / "cardbench/configs/jamba2-mini.json").read_text())["init"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 12
SEED = 2**31 + 17


def _model(cfg) -> M.Model:
    """The reference's sizes of a program config."""
    return M.Model(d_model=cfg.d_model, n_layers=cfg.n_layers, vocab_size=cfg.vocab_size,
                   period=tuple((s.mixer, s.mlp) for s in cfg.layer_plan()), norm_eps=1e-6,
                   tie_embeddings=cfg.tie_embeddings, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
                   experts_per_token=cfg.experts_per_token, d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                   dt_rank=cfg.resolved_dt_rank, conv_width=cfg.conv_width)


@pytest.fixture(scope="module")
def jamba():
    cfg = get_config("jamba2-mini").reduced()
    params = draw.weights(transformer.meta_params(cfg), INIT, cfg.n_layers, SEED, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(5))
    ref = H.forward(params, _model(cfg), tokens, "float32")
    return cfg, params, tokens, ref


def test_jamba2_mini_is_registered_with_the_published_sizes():
    cfg = get_config("jamba2-mini")
    assert "jamba2-mini" in PORT_ARCH_IDS and isinstance(cfg, PortConfig)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (32, 4096, 32, 8)
    assert cfg.resolved_head_dim == 128
    assert (cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank, cfg.conv_width) == (8192, 16, 256, 4)
    assert (cfg.n_experts, cfg.experts_per_token, cfg.d_ff, cfg.vocab_size) == (16, 2, 14336, 65536)
    assert cfg.pos_kind == "none" and not cfg.tie_embeddings
    assert (cfg.attn_offset, cfg.mamba_inner_norms, cfg.moe_renormalize) == (4, True, False)
    # the cost model's count is the leaves' (the inner norms included): ~52 B total, ~12 B active
    meta = transformer.meta_params(cfg)
    assert cfg.param_count() == sum(t.numel() for _, t in draw.flat(meta))
    assert round(cfg.param_count() / 1e9) == 52 and round(cfg.active_param_count() / 1e9) == 12


def test_jamba2_mini_layer_plan_is_hf_offset_and_period_rule():
    """HF's ``JambaConfig.layers_block_type`` / ``layers_num_experts``:
    layer i is attention where ``i % attn_layer_period == attn_layer_offset``
    (8, 4), and MoE where ``i % expert_layer_period == expert_layer_offset``
    (2, 1); Mamba and a dense MLP elsewhere."""
    cfg = get_config("jamba2-mini")
    plan = cfg.layer_plan() * cfg.n_periods
    assert len(plan) == 32
    for i, spec in enumerate(plan):
        assert spec.mixer == ("attn" if i % 8 == 4 else "mamba"), i
        assert spec.mlp == ("moe" if i % 2 == 1 else "dense"), i
    # the JAX package's jamba keeps its attention at index 0
    assert [s.mixer for s in get_config("jamba-1.5-large-398b").layer_plan()] == ["attn"] + ["mamba"] * 7


def test_jamba2_mini_top2_weights_are_the_softmax_unnormalised():
    cfg = get_config("jamba2-mini").reduced()
    g = torch.Generator().manual_seed(3)
    p = {"router": 0.1 * torch.randn(cfg.d_model, cfg.n_experts, generator=g)}
    xt = torch.randn(10, cfg.d_model, generator=g)
    probs, topw, topi = moe.route(p, cfg, xt)
    want = torch.softmax(xt @ p["router"], dim=-1).topk(2, dim=-1)
    assert torch.equal(topi, want.indices) and torch.equal(topw, want.values)
    assert bool((topw.sum(-1) < 1).all())
    _, renormed, _ = moe.route(p, dataclasses.replace(cfg, moe_renormalize=True), xt)
    torch.testing.assert_close(renormed, want.values / want.values.sum(-1, keepdim=True))
    ref_w, ref_i = H.route(p, _model(cfg), xt)
    assert torch.equal(ref_i, topi) and torch.equal(ref_w, topw)


def test_jamba2_mini_prefill_logits_match_the_reference(jamba):
    cfg, params, tokens, ref = jamba
    step = make_prefill_step(cfg, None, SchedulePlan(), device="cpu")
    got = step(params, {"inputs": tokens, "positions": torch.arange(S)[None].expand(B, S)})
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_jamba2_mini_prompt_then_decode_through_the_cache_matches_the_full_forward(jamba):
    """The serving path's prefill (the prompt fed a token a step, as
    ``ServingEngine`` feeds it) and then greedy decode through the cache:
    every step's logits against the reference's full forward over the same
    tokens, its MoE routing each position's rows together as a step does."""
    cfg, params, tokens, _ = jamba
    prompt = S // 2
    step = make_serve_step(cfg, None, SchedulePlan(), device="cpu")
    cache = transformer.init_cache(cfg, B, 32, device="cpu")
    fed, steps = tokens[:, :prompt], []
    for t in range(S):
        logits, cache = step(params, cache, fed[:, t:t + 1], t)
        steps.append(logits)
        if t + 1 >= prompt:
            fed = torch.cat([fed, logits.argmax(-1, keepdim=True)], dim=1)
    ref = H.forward(params, _model(cfg), fed[:, :S], "float32", by_step=True)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), ref.numpy(), **TOL)


def test_jamba2_mini_decode_from_a_drawn_state_matches_the_reference(jamba):
    """One Mamba layer's decode steps from a drawn conv window and SSM state
    against the reference's mixer run from that state over the same rows:
    the outputs, and the window and state the steps leave."""
    cfg, params, _, _ = jamba
    p = transformer.period_params(params["blocks"], 0)["b0"]["mamba"]
    g = torch.Generator().manual_seed(11)
    n = 6
    conv = torch.randn(B, cfg.conv_width - 1, cfg.d_inner, generator=g) * 1.28
    ssm = torch.randn(B, cfg.d_inner, cfg.ssm_state, generator=g) * 0.02
    x = torch.randn(B, n, cfg.d_model, generator=g)
    cache = {"conv": conv.clone(), "ssm": ssm.clone()}
    outs = [mamba.decode_step(p, cfg, cache, x[:, t:t + 1])[0] for t in range(n)]
    ref, ref_conv, ref_ssm = H.mamba(p, _model(cfg), x, "float32", conv, ssm)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(cache["conv"].numpy(), ref_conv.numpy(), **TOL)
    np.testing.assert_allclose(cache["ssm"].numpy(), ref_ssm.numpy(), **TOL)


def test_jamba2_mini_cache_holds_both_kinds_of_state():
    cfg = get_config("jamba2-mini").reduced()
    cache = transformer.init_cache(cfg, 3, 40, kv_dtype="int8", device="cpu")
    n = cfg.n_periods
    for i, spec in enumerate(cfg.layer_plan()):
        c = cache[f"b{i}"]
        if spec.mixer == "attn":
            assert {k: (tuple(v.shape), v.dtype) for k, v in c.items()} == {
                "k": ((n, 3, 2, 40, 16), torch.int8), "v": ((n, 3, 2, 40, 16), torch.int8),
                "k_s": ((n, 3, 2, 40, 1), torch.float32), "v_s": ((n, 3, 2, 40, 1), torch.float32)}
        else:
            assert c["conv"].shape == (n, 3, cfg.conv_width - 1, cfg.d_inner)
            assert c["ssm"].shape == (n, 3, cfg.d_inner, cfg.ssm_state) and c["ssm"].dtype == torch.float32


def test_jamba2_mini_serves_through_the_engine(jamba):
    cfg, params, tokens, _ = jamba
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32, device="cpu")
    for r in range(3):
        eng.submit(tokens[r % B, :4 + r].numpy(), max_new_tokens=3)
    done = eng.run(max_steps=200)
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)


def _jamba_large(**fields):
    base = get_config("jamba-1.5-large-398b").reduced()
    return PortConfig(**dataclasses.asdict(base), **fields) if fields else base


@pytest.mark.parametrize("field, default, other", [("attn_offset", 0, 4), ("mamba_inner_norms", False, True),
                                                   ("moe_renormalize", True, False)])
def test_jamba2_mini_fields_at_their_defaults_leave_jamba_large_unchanged(field, default, other):
    """Each field at its default computes as the JAX package's config (a
    ``ModelConfig``, which holds the default as a class attribute): the same
    plan, leaves, prefill and decode logits, bit for bit; at the other value
    it computes something else."""
    base = _jamba_large()
    assert type(base) is ModelConfig and getattr(base, field) == default
    same, changed = _jamba_large(**{field: default}), _jamba_large(**{field: other})
    assert same.layer_plan() == base.layer_plan() and same.param_count() == base.param_count()

    def run(cfg):
        params = transformer.init_params(cfg, 3, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (B, 8), generator=torch.Generator().manual_seed(1))
        fwd = transformer.forward(params, cfg, toks, torch.arange(8)[None].expand(B, 8))
        cache = transformer.init_cache(cfg, B, 16, kv_dtype="int8", device="cpu")
        step = make_serve_step(cfg, None, SchedulePlan(), device="cpu")
        dec = [step(params, cache, toks[:, t:t + 1], t)[0] for t in range(3)]
        return fwd, torch.stack(dec)

    got, want = run(same), run(base)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(run(changed)[0], want[0])


def test_jamba2_mini_mamba_spans_once_a_layer_a_step(jamba):
    cfg, params, tokens, _ = jamba
    step = make_serve_step(cfg, None, SchedulePlan(), device="cpu")
    cache = transformer.init_cache(cfg, B, 16, device="cpu")
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_plan()) * cfg.n_periods
    names = ("mamba.project", "mamba.conv", "mamba.ssm", "mamba.out", "mamba.state_write")
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for t in range(2):
            step(params, cache, tokens[:, t:t + 1], t)
        transformer.forward(params, cfg, tokens, torch.arange(S)[None].expand(B, S))
    spans = tracing.spans()
    tracing.reset()
    for step_no in (0, 1):
        mine = [s for s in spans if s.step == step_no]
        for name in names:
            assert sum(s.name == name for s in mine) == n_mamba, (step_no, name)
    # the forward's spans lie outside any serve step, and it writes no state
    outside = [s.name for s in spans if s.step is None]
    assert all(outside.count(name) == n_mamba for name in names[:-1])
    assert "mamba.state_write" not in outside
