"""The port's training path on the CPU against the JAX package's.

``cross_entropy``; ``apply_updates`` from JAX state carried across with
``convert.opt_state_from_numpy``; ``make_train_step`` on reduced granite-moe
against the jitted JAX step; the three remat policies against each other;
the backward formulas of the kernels' autograd Functions (run with the plain
versions in place of the kernels) against ``jax.vjp`` of the JAX oracles
(the flash and scan Functions' own tests are in ``test_torch_backward.py``);
the trainer, its checkpoints, the data pipeline and the CLI.
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
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.kernels import ref as jref
from repro.models import losses as jlosses
from repro.models import transformer as jtf
from repro.training import optimizer as joptim
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.space import SchedulePlan
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import losses
from repro_torch.models import transformer as ttf
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import make_train_step

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
B, S = 4, 16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jax_leaves(tree) -> dict:
    """JAX pytree leaves by the port's dotted path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(p.key) for p in path)] = np.asarray(leaf)
    return out


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 11, 97)) * 4).astype(np.float32)
    labels = rng.integers(0, 97, (3, 11)).astype(np.int32)
    exp = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    got = losses.cross_entropy(_t(logits), _t(labels), z_loss=z_loss)
    np.testing.assert_allclose(got.item(), float(exp), rtol=1e-6)
    exp = jlosses.next_token_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(losses.next_token_loss(_t(logits), _t(labels)).item(), float(exp),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
def _opt_tree(rng):
    """A parameter tree with every kind of leaf: stacked 3-D and 2-D (the
    norms), plain 2-D, a 1-D vector, and a last axis below 16."""
    return {
        "blocks": {"b0": {
            "norm1": (1 + 0.1 * rng.standard_normal((2, 64))).astype(np.float32),
            "w": (0.05 * rng.standard_normal((2, 64, 48))).astype(np.float32),
            "narrow": (0.05 * rng.standard_normal((2, 64, 8))).astype(np.float32),
        }},
        "embed": (0.05 * rng.standard_normal((100, 64))).astype(np.float32),
        "final_norm": np.ones((64,), np.float32),
    }


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_apply_updates_matches_jax_over_three_steps(moment_dtype):
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=2)  # n_periods = 2
    oc_kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, _opt_tree(rng))
    jstate = joptim.init_opt_state(jp, joptim.OptimizerConfig(**oc_kw))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    jstep = jax.jit(lambda p, g, s: joptim.apply_updates(p, g, s, joptim.OptimizerConfig(**oc_kw)))
    oc = optim.OptimizerConfig(**oc_kw)
    for i in range(3):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), jp)
        jp, jstate, jm = jstep(jp, grads, jstate)
        params, state, m = optim.apply_updates(
            params, jax.tree.map(_t, grads), state, oc)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
    assert state["step"] == int(jstate["step"]) == 3
    jl = _jax_leaves(jp)
    for path, p in optim.leaves(params):
        np.testing.assert_allclose(p.numpy(), jl[path], rtol=1e-5, atol=1e-5, err_msg=path)
    n_q = n_q_diff = 0
    for mom in ("mu", "nu"):
        jm_leaves = _jax_leaves(jstate[mom])
        for path, leaf in optim.leaves(state[mom]):
            if isinstance(leaf, dict):
                # the jitted JAX step scales by amax * (1/127) (XLA's rewrite),
                # the port by amax / 127: one ulp apart on some rows, which
                # moves a code by one where x / scale sits on a .5 boundary
                d = leaf["q"].numpy().astype(int) - jm_leaves[path + ".q"].astype(int)
                assert np.abs(d).max() <= 1, path
                n_q += d.size
                n_q_diff += np.count_nonzero(d)
                np.testing.assert_allclose(leaf["s"].numpy(), jm_leaves[path + ".s"], rtol=1e-5)
            else:
                assert moment_dtype == "float32" or leaf.ndim < 2 or leaf.shape[-1] < 16, path
                np.testing.assert_allclose(leaf.numpy(), jm_leaves[path], rtol=1e-6, atol=1e-6,
                                           err_msg=path)
    assert n_q_diff <= max(1, n_q // 1000), (n_q_diff, n_q)  # at most 0.1 % of the codes
    if moment_dtype == "int8":
        assert n_q > 0


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_model():
    """Reduced granite-moe with JAX weights; the router scaled up so the
    top-2 routing has no near-ties that rounding could flip."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 50 if "router" in jax.tree_util.keystr(path) else x, jp)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, B, S)).astype(np.int32)
    return jcfg, cfg, jp, toks


def _batch(toks):
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    return {"inputs": _t(toks).long(), "labels": _t(toks).long(), "positions": _t(pos).long()}


def _jax_batch(toks):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return {"inputs": jnp.asarray(toks), "labels": jnp.asarray(toks), "positions": jnp.asarray(pos)}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("grad_comm", ["fp32", "int8"])
def test_train_step_matches_jax(moe_model, microbatches, grad_comm):
    jcfg, cfg, jp, toks = moe_model
    oc_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jplan = JaxPlan(microbatches=microbatches, grad_comm=grad_comm, remat="none")
    plan = SchedulePlan(microbatches=microbatches, grad_comm=grad_comm, remat="none")
    jstep = jax.jit(jax_make_train_step(jcfg, JaxShape("t", S, B, "train"), jplan,
                                        joptim.OptimizerConfig(**oc_kw)))
    step = make_train_step(cfg, None, plan, optim.OptimizerConfig(**oc_kw), device="cpu")
    jstate = joptim.init_opt_state(jp, joptim.OptimizerConfig(**oc_kw))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state = optim.init_opt_state(params, optim.OptimizerConfig(**oc_kw))
    before = {k: v.clone() for k, v in optim.leaves(params)}
    for i in range(2):
        jp, jstate, jm = jstep(jp, jstate, _jax_batch(toks[i]))
        params, state, m = step(params, state, _batch(toks[i]))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    jl = _jax_leaves(jp)
    for path, p in optim.leaves(params):
        assert not torch.equal(p, before[path]), path  # every leaf moved
        np.testing.assert_allclose(p.detach().numpy(), jl[path], rtol=1e-4, atol=1e-4, err_msg=path)


def _loss_and_grads(cfg, params, toks, remat):
    leaves = [p.detach().clone().requires_grad_() for _, p in optim.leaves(params)]
    tree = optim.tree_from_leaves(params, dict(zip((k for k, _ in optim.leaves(params)), leaves)))
    b = _batch(toks)
    logits = ttf.forward(tree, cfg, b["inputs"], b["positions"], remat=remat)
    loss = losses.cross_entropy(logits[:, :-1], b["labels"][:, 1:])
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_remat_policies_give_the_same_loss_and_grads(moe_model):
    _, cfg, jp, toks = moe_model
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    loss0, grads0 = _loss_and_grads(cfg, params, toks[0], "none")
    for remat in ("dots", "full"):
        loss, grads = _loss_and_grads(cfg, params, toks[0], remat)
        np.testing.assert_allclose(loss, loss0, rtol=1e-6)
        for g, g0 in zip(grads, grads0):
            np.testing.assert_allclose(g, g0, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads(cfg, params, toks[0], "everything")


def test_dots_policy_saves_the_products_without_batch_dims_only():
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    assert ttf._dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert ttf._dots_policy(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert ttf._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# The autograd Functions' backward formulas, with the plain versions standing
# in for the kernels (on the card the same Functions wrap the launches)
def _vjp_check(fn_port, fn_jax, inputs, seed):
    rng = np.random.default_rng(seed)
    ts = [_t(a).requires_grad_() for a in inputs]
    out = fn_port(*ts)
    gy = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad(out, ts, _t(gy))
    exp_out, vjp = jax.vjp(fn_jax, *map(jnp.asarray, inputs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp_out), rtol=1e-5, atol=1e-5)
    for g, e in zip(got, vjp(jnp.asarray(gy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5, atol=1e-5)


def _rmsnorm_fn(a, b):
    # the Function with the plain forward and the plain closed-form backward
    # standing in for the two kernels
    return rn.RMSNormFn.apply(a, b, lambda u, v: ref.rmsnorm(u, v),
                              lambda u, v, g: ref.rmsnorm_backward(u, v, g, eps=1e-6))


def test_rmsnorm_function_backward_matches_jax_vjp():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    _vjp_check(_rmsnorm_fn, lambda a, b: jref.rmsnorm(a, b), [x, w], 5)


@pytest.mark.parametrize("d", [96, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_function_with_plain_launchers_matches_jax_vjp(d, dtype):
    # f32 to 1e-5; bf16 (inputs, output and both gradients) at 5e-2, the
    # kernel tests' bf16 tolerance
    rng = np.random.default_rng(40)
    x = rng.standard_normal((4, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    gy = rng.standard_normal((4, d)).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    xt, wt = (_t(a).to(tdt).requires_grad_() for a in (x, w))
    out = _rmsnorm_fn(xt, wt)
    got = torch.autograd.grad(out, (xt, wt), _t(gy).to(tdt))
    exp_out, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b), jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(exp_out, np.float32), **tol)
    for g, e in zip(got, vjp(jnp.asarray(gy, jdt))):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e, np.float32), **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_backward_matches_jax_vjp(causal):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    _vjp_check(
        lambda a, b, c: fa.FlashAttentionFn.apply(
            a, b, c, causal, lambda *t: ref.attention_lse(*t, causal=causal),
            lambda *t: ref.attention_backward(*t, causal=causal)),
        lambda a, b, c: jref.attention(a, b, c, causal=causal), [q, k, v], 7)


def test_moe_gemm_function_backward_matches_jax_vjp():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32, 24)).astype(np.float32)
    calls = []

    def gemm(a, b, a_t, b_t):
        calls.append((tuple(a.shape), tuple(b.shape), a_t, b_t, a.is_contiguous() and b.is_contiguous()))
        return ref.moe_gemm(a, b, x_t=a_t, w_t=b_t)

    _vjp_check(lambda a, b: mg.MoeGemmFn.apply(a, b, False, False, gemm), jref.moe_gemm, [x, w], 9)
    # forward, then dx = dy . w^T and dw = x^T . dy through the same GEMM, on
    # w and x as stored (read transposed), never on a transposed copy
    assert calls == [((4, 16, 32), (4, 32, 24), False, False, True),
                     ((4, 16, 24), (4, 32, 24), False, True, True),
                     ((4, 16, 32), (4, 16, 24), True, False, True)]


class _OtherDevice(torch.Tensor):
    """A tensor that reports a device the port runs on neither for real
    (cuda, cpu) nor for a dry run (meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def _other(*shape, **kw):
    return torch.empty(shape, **kw).as_subclass(_OtherDevice)


def test_scan_wrapper_refuses_a_device_other_than_cpu_or_cuda():
    u = _other(1, 8, 16).requires_grad_()
    a = _other(16, 4)
    b = _other(1, 8, 4)
    d = _other(16)
    with torch.no_grad(), pytest.raises(ValueError):  # no gradient asked: the usual checks
        ss.selective_scan(u, u, a, b, b, d)
    with pytest.raises(ValueError):  # a gradient asked: the same checks, before ScanFn
        ss.selective_scan(u, u, a, b, b, d)


# ---------------------------------------------------------------------------
def test_pipeline_batches_match_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    for host_count, host_index in ((1, 0), (4, 2)):
        p = Pipeline(cfg, InputShape("t", 16, 8, "train"), DataConfig(host_count=host_count,
                                                                     host_index=host_index))
        jpipe = JaxPipeline(jcfg, JaxShape("t", 16, 8, "train"),
                            JaxDataConfig(host_count=host_count, host_index=host_index))
        for step in (0, 7):
            got, exp = p.batch_at(step), jpipe.batch_at(step)
            assert got.keys() == exp.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], exp[k])


def test_trainer_loss_decreases_quickly(tmp_path):
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config("granite-3-2b").reduced()
    oc = optim.OptimizerConfig(peak_lr=1e-2, warmup_steps=5, total_steps=40)
    tc = TrainerConfig(total_steps=12, ckpt_every=100, ckpt_dir=str(tmp_path), log_every=1)
    tr = Trainer(cfg, InputShape("t", 64, 8, "train"), SchedulePlan(microbatches=1, remat="none"),
                 tc, opt_cfg=oc, device="cpu")
    tr.run()
    losses_ = [r["loss"] for r in tr.metrics_log]
    assert len(losses_) == 12 and all(np.isfinite(losses_))
    assert losses_[-1] < losses_[0] - 0.5, losses_


def test_trainer_resume_continues_exactly(tmp_path):
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(ARCH).reduced()
    shape = InputShape("t", 16, 4, "train")
    plan = SchedulePlan(microbatches=2, remat="none", opt_dtype="int8")
    straight = Trainer(cfg, shape, plan, TrainerConfig(
        total_steps=8, ckpt_every=100, ckpt_dir=str(tmp_path / "a"), log_every=1), device="cpu")
    p_straight, _, _ = straight.run()

    tc = TrainerConfig(total_steps=6, ckpt_every=2, ckpt_dir=str(tmp_path / "b"), log_every=1,
                       ckpt_async=True)
    first = Trainer(cfg, shape, plan, tc, device="cpu")
    first.run()
    assert first.ckpt.list_steps() == [2, 4, 6]  # keep-3 garbage collection
    tc2 = dataclasses.replace(tc, total_steps=8, ckpt_every=4)
    second = Trainer(cfg, shape, plan, tc2, device="cpu")
    p_resumed, state, end = second.run()
    assert end == 8 and state["step"] == 8
    assert min(r["step"] for r in second.metrics_log) >= 7  # continued, not restarted
    assert second.ckpt.list_steps() == [4, 6, 8]
    for (path, a), (_, b) in zip(optim.leaves(p_resumed), optim.leaves(p_straight)):
        assert torch.equal(a, b), path  # the resumed run is the straight run, bit for bit
    assert second.handle_failure(["h0", "h1"], 4, 2).restart_step == 8


def test_checkpoint_restores_int8_moments_and_step(tmp_path):
    from repro_torch.checkpoint.ckpt import Checkpointer

    params = {"a": {"w": torch.randn(3, 32)}, "v": torch.randn(5)}
    state = optim.init_opt_state(params, optim.OptimizerConfig(moment_dtype="int8"))
    state["mu"]["a"]["w"]["q"].fill_(7)
    state["step"] = 5
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(5, params, state, extra={"data_step": 5}, blocking=False)
    params["a"]["w"].add_(1.0)  # an in-place update after save does not reach the file
    ck.wait()
    zero_p = {"a": {"w": torch.zeros(3, 32)}, "v": torch.zeros(5)}
    zero_s = optim.init_opt_state(zero_p, optim.OptimizerConfig(moment_dtype="int8"))
    p, s, step, extra = ck.restore(zero_p, zero_s)
    assert step == 5 and extra == {"data_step": 5} and s["step"] == 5
    assert torch.equal(p["a"]["w"] + 1.0, params["a"]["w"]) and torch.equal(p["v"], params["v"])
    assert s["mu"]["a"]["w"]["q"].dtype == torch.int8 and (s["mu"]["a"]["w"]["q"] == 7).all()
    with pytest.raises(ValueError):
        ck.restore({"a": {"w": torch.zeros(4, 32)}, "v": torch.zeros(5)})


def test_train_cli_smoke_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                       "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
                       "--plan-json", '{"microbatches": 2, "opt_dtype": "int8"}']) == 0
    out = capsys.readouterr().out
    assert "done at step 3" in out
    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                       "--ckpt-dir", str(tmp_path / "tuned"), "--autotune", "mcts_1s"]) == 0
    out = capsys.readouterr().out
    assert "[train] autotuned plan (mcts_1s, h100 card): SchedulePlan(" in out
    assert "done at step 2" in out
