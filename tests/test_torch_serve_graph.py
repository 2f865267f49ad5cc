"""The one-card serve step through CUDA graphs (``runtime.graphs``).

On the card: N calls of ``make_serve_step``'s step (the first as it is, the
second captured and replayed, the rest replayed) against N calls of
``transformer.decode_step`` run as it is, from the same state, for reduced
granite-moe and jamba2-mini in bf16 with an int8 and a bf16 cache: the
tokens, the logits and every cache leaf (K/V, scales, conv window, SSM
state) bit for bit, and the launch counters alike.  A replaced cache leaf
captures again; ``ServingEngine``'s commit masks give the completions of
the eager step.  On the CPU: a graph's key, and that a CPU step never
reaches the graphs.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.space import SchedulePlan
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.runtime import graphs
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.train_step import make_serve_step, tiles_from_plan

ARCHS = ("granite-moe-1b-a400m", "jamba2-mini")
ROWS, MAX_LEN, STEPS = 16, 64, 5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")


def _state(cfg, kv_dtype, device):
    """Weights, and a cache whose every leaf holds random content (the
    visible K/V rows, their scales, the Mamba window and state)."""
    gen = torch.Generator(device=device).manual_seed(5)
    params = transformer.init_params(cfg, 0, device=device)
    cache = transformer.init_cache(cfg, ROWS, MAX_LEN, kv_dtype=kv_dtype, device=device)
    for leaves in cache.values():
        for name, t in leaves.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=device))
            elif name.endswith("_s"):
                t.copy_(torch.rand(t.shape, generator=gen, device=device) * 0.05 + 0.01)
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device=device) * 0.5)
    return params, cache


def _clone(cache):
    return {b: {k: t.clone() for k, t in c.items()} for b, c in cache.items()}


def _start(cfg, device):
    tok = torch.randint(0, cfg.vocab_size, (ROWS, 1), generator=torch.Generator().manual_seed(6))
    cur = torch.arange(20, 20 + ROWS)  # each row at its own position
    return tok.to(device), cur.to(device)


def _run(call, tok, cur, steps=STEPS):
    """``steps`` greedy steps: each step's logits (f32, host) and launch counts."""
    logits = []
    ops.reset_counters()
    for _ in range(steps):
        out = call(tok, cur)
        logits.append(out.float().cpu())
        tok, cur = out.argmax(-1)[:, None], cur + 1
    torch.cuda.synchronize()
    return logits, ops.launch_counts()


def _eager(params, cfg, cache, plan):
    tiles = tiles_from_plan(plan)
    return lambda tok, cur: transformer.decode_step(params, cfg, cache, tok, cur, tiles=tiles)[0]


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_steps_equal_eager_steps_bit_for_bit(arch, kv_dtype):
    dev = _card()
    cfg, plan = _cfg(arch), SchedulePlan(kv_dtype=kv_dtype)
    params, cache = _state(cfg, kv_dtype, dev)
    mine = _clone(cache)
    tok, cur = _start(cfg, dev)
    want, _ = _run(_eager(params, cfg, cache, plan), tok, cur)
    step = make_serve_step(cfg, None, plan, device=dev)
    got, _ = _run(lambda t, c: step(params, mine, t, c)[0], tok, cur)
    assert len(step.graphs.graphs) == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"step {i}: logits differ by {(g - w).abs().max().item()}"
        assert torch.equal(g.argmax(-1), w.argmax(-1))
    for b, leaves in cache.items():
        for name, t in leaves.items():
            assert torch.equal(mine[b][name], t), f"{b}.{name} differs after {STEPS} steps"


@pytest.mark.parametrize("arch", ARCHS)
def test_replayed_launch_counts_equal_eager_counts(arch):
    dev = _card()
    cfg, plan = _cfg(arch), SchedulePlan(kv_dtype="int8")
    params, cache = _state(cfg, "int8", dev)
    tok, cur = _start(cfg, dev)
    _, want = _run(_eager(params, cfg, _clone(cache), plan), tok, cur)
    step = make_serve_step(cfg, None, plan, device=dev)
    _, got = _run(lambda t, c: step(params, cache, t, c)[0], tok, cur)
    n_attn = cfg.n_periods * sum(s.mixer == "attn" for s in cfg.layer_plan())
    assert got == want and want["decode_attention"] == STEPS * n_attn


def test_replacing_a_cache_leaf_captures_again():
    dev = _card()
    cfg, plan = _cfg("granite-moe-1b-a400m"), SchedulePlan(kv_dtype="int8")
    params, cache = _state(cfg, "int8", dev)
    mine = _clone(cache)
    tok, cur = _start(cfg, dev)
    eager = _eager(params, cfg, cache, plan)
    step = make_serve_step(cfg, None, plan, device=dev)
    for i in range(6):
        if i == 3:  # a new tensor of the same content: another address
            cache["b0"]["k"] = cache["b0"]["k"].clone()
            mine["b0"]["k"] = mine["b0"]["k"].clone()
        want = eager(tok, cur)
        got = step(params, mine, tok, cur)[0]
        assert torch.equal(got, want), f"step {i}"
        tok, cur = want.argmax(-1)[:, None], cur + 1
    # captured at calls 1 and 4 (call 3 ran as it is under its new key)
    assert len(step.graphs.graphs) == 2 and not step.graphs.seen
    for b, leaves in cache.items():
        for name, t in leaves.items():
            assert torch.equal(mine[b][name], t)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_completions_graphed_equal_eager(arch):
    dev = _card()
    cfg = _cfg(arch)
    params = transformer.init_params(cfg, 0, device=dev)
    engines = [ServingEngine(cfg, params, batch_slots=4, max_len=MAX_LEN, device=dev) for _ in range(2)]
    tiles = tiles_from_plan(engines[1].plan)
    eager = engines[1]
    eager._step_fn = lambda p, c, x, cur, commit=None: (
        transformer.decode_step(p, cfg, c, x, cur, commit, tiles=tiles)[0], c)
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, cfg.vocab_size, (int(n),), generator=gen).numpy()
               for n in torch.randint(2, 9, (7,), generator=gen)]
    done = []
    for eng in engines:
        for p in prompts:  # more requests than slots: slots are refilled and reset
            eng.submit(p, max_new_tokens=6)
        done.append({r.uid: r.generated for r in eng.run()})
    assert len(done[0]) == len(prompts) and done[0] == done[1]
    assert engines[0]._step_fn.graphs.graphs  # the engine's step was replayed


def test_graph_key_follows_leaves_inputs_and_commit():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = transformer.init_params(cfg, 0, device="cpu")
    cache = transformer.init_cache(cfg, 2, 8, kv_dtype="int8", device="cpu")
    tok, cur = torch.zeros((2, 1), dtype=torch.long), torch.tensor([3, 4])
    base = graphs.key(params, cache, tok, cur, None)
    assert graphs.key(params, cache, tok.clone(), cur + 1, None) == base  # values are not in it
    assert graphs.key(params, cache, tok, cur, torch.ones(2, dtype=torch.bool)) != base
    assert graphs.key(params, cache, tok[:1], cur[:1], None) != base
    assert graphs.key(params, cache, tok, cur[0], None) != base
    cache["b0"]["k_s"] = cache["b0"]["k_s"].clone()
    assert graphs.key(params, cache, tok, cur, None) != base
    n_leaves = sum(1 for tree in (params, cache) for _ in graphs._tensors(tree))
    assert len(base[-1]) == n_leaves


def test_a_cpu_serve_step_never_reaches_the_graphs(monkeypatch):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = transformer.init_params(cfg, 0, device="cpu")
    cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    step = make_serve_step(cfg, None, SchedulePlan(), device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU step reached the graphs")

    monkeypatch.setattr(graphs.StepGraphs, "__call__", refuse)
    tok, cur = torch.zeros((2, 1), dtype=torch.long), torch.tensor([3, 4])
    for _ in range(3):
        logits, _ = step(params, cache, tok, cur)
        cur = cur + 1
    assert logits.shape == (2, cfg.vocab_size) and not step.graphs.graphs and not step.graphs.seen
