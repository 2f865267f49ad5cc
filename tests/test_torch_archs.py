"""The five archs of model coverage on the CPU against the JAX package.

nemotron-4-15b (squared-ReLU, layernorm), stablelm-12b (partial rotary,
head_dim 160 at full width), musicgen-large (embeddings input, sinusoidal
positions), deepseek-67b (95 layers at full width) and qwen2-vl-72b
(embeddings input, M-RoPE).  Reduced configs (f32) with JAX-initialised
weights carried across by ``convert.params_from_numpy``; inputs drawn with
numpy: tokens, or ``(B, S, d)`` embeddings, and for qwen2-vl ``(B, 3, S)``
M-RoPE ids whose three rows differ (a patch grid, then text).  The position
functions are also held at their own full-size widths, where ``reduced()``'s
head_dim of 16 would not reach them.
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
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.training import optimizer as joptim
from repro.training.train_step import make_positions as jax_make_positions
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.space import SchedulePlan
from repro_torch.data.pipeline import Pipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import transformer as ttf
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import make_positions, make_prefill_step, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCHS = ["nemotron-4-15b", "stablelm-12b", "musicgen-large", "deepseek-67b", "qwen2-vl-72b"]
B, S = 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_models.py's
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
POS_TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(cfg, rng, batch=B, seq=S) -> np.ndarray:
    if cfg.input_kind == "tokens":
        return rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)


def _torch_inputs(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.long() if x.dtype.kind == "i" else t


def _mrope_ids(batch: int, seq: int, grid: int = 2) -> np.ndarray:
    """(batch, 3, seq): a ``grid x grid`` patch block (t constant, h and w its
    coordinates) starting at row b, then text positions that continue after
    the block's largest id, the same in all three rows."""
    out = np.zeros((batch, 3, seq), np.int32)
    for b in range(batch):
        n = grid * grid
        pos = np.arange(seq)
        t = np.where(pos < b, pos, b)
        h = np.where(pos < b, pos, b)
        w = np.where(pos < b, pos, b)
        patch = (pos >= b) & (pos < b + n)
        h = np.where(patch, b + (pos - b) // grid, h)
        w = np.where(patch, b + (pos - b) % grid, w)
        text = pos >= b + n
        nxt = b + grid + (pos - b - n)
        t, h, w = (np.where(text, nxt, a) for a in (t, h, w))
        out[b] = np.stack([t, h, w])
    assert all((out[b, 0] != out[b, 1]).any() or (out[b, 1] != out[b, 2]).any() for b in range(batch))
    return out


def _positions(cfg, batch=B, seq=S) -> np.ndarray:
    if cfg.pos_kind == "mrope":
        return _mrope_ids(batch, seq)
    return np.broadcast_to(np.arange(seq, dtype=np.int32)[None], (batch, seq)).copy()


@pytest.fixture(scope="module", params=ARCHS)
def arch_model(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(5))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    x = _inputs(cfg, np.random.default_rng(5))
    return jcfg, cfg, jparams, params, x


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_jax_config_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(
        jax_get_config(arch).reduced())


def test_every_jax_arch_id_resolves_in_the_port():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    for arch in JAX_ARCH_IDS:
        assert get_config(arch).name == arch


def test_prefill_logits_match_jax(arch_model):
    jcfg, cfg, jparams, params, x = arch_model
    pos = _positions(cfg)
    exp = jtf.forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(pos))
    step = make_prefill_step(cfg, None, SchedulePlan(attn_block=(8, 16)), device="cpu")
    ops.reset_counters()
    got = step(params, {"inputs": _torch_inputs(x), "positions": torch.from_numpy(pos).long()})
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors launch nothing
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_decode_step_by_step_matches_jax(arch_model):
    """One token (or embedding row) at a time from an empty cache: the
    sinusoid at ``cur``, M-RoPE's three equal ids of a decoded token, and the
    cache writes, against the JAX decode."""
    jcfg, cfg, jparams, params, x = arch_model
    L, T = 8, 6
    jcache = jtf.init_cache(jcfg, B, L)
    cache = ttf.init_cache(cfg, B, L, device="cpu")
    for t in range(T):
        jl, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(x[:, t:t + 1]), jnp.int32(t))
        tl, cache = ttf.decode_step(params, cfg, cache, _torch_inputs(x[:, t:t + 1]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
    # rows at their own lengths: the sinusoid of each row's own position
    cur = np.array([T, 2], np.int32)
    jl, _ = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(x[:, T:T + 1]), jnp.asarray(cur))
    tl, _ = ttf.decode_step(params, cfg, cache, _torch_inputs(x[:, T:T + 1]), torch.from_numpy(cur))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)


def test_decode_matches_the_forward_on_text_positions(arch_model):
    _, cfg, _, params, x = arch_model
    T = 8
    xt = _torch_inputs(x[:, :T])
    full = ttf.forward(params, cfg, xt, make_positions(cfg, B, T, device="cpu"))
    cache = ttf.init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        last, cache = ttf.decode_step(params, cfg, cache, xt[:, t:t + 1], t)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), **DECODE_TOL)


def test_embeddings_archs_have_no_embedding_table():
    for arch in ("musicgen-large", "qwen2-vl-72b"):
        cfg = get_config(arch).reduced()
        params = ttf.init_params(cfg, 0, device="cpu")
        jparams = jtf.init_params(jax_get_config(arch).reduced(), jax.random.PRNGKey(0))
        assert "embed" not in params and "embed" not in jparams
        assert set(params) == set(jparams)
    cfg = get_config("nemotron-4-15b").reduced()
    tree = jax.tree.map(np.asarray, jtf.init_params(jax_get_config("nemotron-4-15b").reduced(),
                                                    jax.random.PRNGKey(0)))
    del tree["embed"]
    with pytest.raises(KeyError, match="embed"):  # a token arch still needs its table
        convert.params_from_numpy(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the position functions at their own widths
def test_mrope_at_head_dim_128_with_the_published_split():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 64, 128)).astype(np.float32)
    pos = _mrope_ids(2, 64, grid=6) * 37  # ids into the thousands
    assert layers.mrope_sections(128) == jlayers._mrope_sections(128) == (16, 24, 24)
    exp = jlayers.mrope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0, (16, 24, 24))
    got = layers.mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1_000_000.0, (16, 24, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **POS_TOL)
    # the sections are not interchangeable: swapping two moves the output
    swapped = layers.mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1_000_000.0,
                           (24, 16, 24))
    assert not np.allclose(swapped.numpy(), np.asarray(exp), **POS_TOL)
    with pytest.raises(ValueError, match="sections"):
        layers.mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1e6, (16, 24, 16))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_mrope_sections_match_jax(head_dim):
    assert layers.mrope_sections(head_dim) == jlayers._mrope_sections(head_dim)


def test_partial_rope_at_head_dim_160():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 4, 96, 160)).astype(np.float32)
    pos = (np.arange(96, dtype=np.int32) * 41)[None]
    exp = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, 0.25)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 10000.0, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **POS_TOL)
    np.testing.assert_array_equal(got.numpy()[..., 40:], x[..., 40:])  # rot_dim 40 of 160


def test_sinusoidal_pe_at_musicgen_width():
    """d = 2048 over musicgen's 4096 prefill positions.  Both sides compute
    the same f32 exponent, but XLA's f32 ``exp`` and PyTorch's round 102 of
    the 1,024 frequencies one ulp apart (neither is correctly rounded
    everywhere), and an angle ``p * f`` carries that ulp times ``p``, plus
    the f32 rounding of the product: the bound is 1e-6 plus ``p * 2**-21``
    (``f <= 1``).  At position 0..7 that is the plain 1e-6."""
    pos = np.stack([np.arange(4096), np.arange(4095, -1, -1)]).astype(np.int32)
    exp = np.asarray(jlayers.sinusoidal_pe(jnp.asarray(pos), 2048))
    got = layers.sinusoidal_pe(torch.from_numpy(pos).long(), 2048)
    assert got.shape == (2, 4096, 2048) and got.dtype == torch.float32
    half = 1024
    arg = -np.float32(np.log(10000.0)) * np.arange(half, dtype=np.float32) / np.float32(half)
    np.testing.assert_array_max_ulp(np.asarray(jnp.exp(jnp.asarray(arg))),
                                    torch.exp(torch.from_numpy(arg)).numpy(), maxulp=1)
    bound = 1e-6 + pos[..., None].astype(np.float64) * 2.0**-21
    assert (np.abs(got.numpy().astype(np.float64) - exp) <= bound).all()
    np.testing.assert_allclose(got.numpy()[0, :8], exp[0, :8], **POS_TOL)


def test_make_positions_for_mrope_is_three_equal_rows():
    cfg = get_config("qwen2-vl-72b").reduced()
    got = make_positions(cfg, B, S, device="cpu")
    assert got.shape == (B, 3, S) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_make_positions(cfg, B, S)))


# ---------------------------------------------------------------------------
def test_musicgen_train_step_matches_jax():
    """One train step of reduced musicgen-large: embeddings and the sinusoid
    on the gradient path, every leaf against the jitted JAX step."""
    arch = "musicgen-large"
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(9))
    rng = np.random.default_rng(9)
    x = _inputs(cfg, rng, batch=4)
    labels = rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)
    pos = _positions(cfg, batch=4)
    oc_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxShape("t", S, 4, "train"), JaxPlan(remat="none"),
                                        joptim.OptimizerConfig(**oc_kw)))
    step = make_train_step(cfg, None, SchedulePlan(remat="none"), optim.OptimizerConfig(**oc_kw),
                           device="cpu")
    jstate = joptim.init_opt_state(jp, joptim.OptimizerConfig(**oc_kw))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state = optim.init_opt_state(params, optim.OptimizerConfig(**oc_kw))
    before = {k: v.clone() for k, v in optim.leaves(params)}
    jp, jstate, jm = jstep(jp, jstate, {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels),
                                        "positions": jnp.asarray(pos)})
    params, state, m = step(params, state, {"inputs": torch.from_numpy(x),
                                            "labels": torch.from_numpy(labels).long(),
                                            "positions": torch.from_numpy(pos).long()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    jl = {".".join(str(p.key) for p in path): np.asarray(leaf)
          for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, p in optim.leaves(params):
        assert not torch.equal(p, before[path]), path  # every leaf moved
        np.testing.assert_allclose(p.detach().numpy(), jl[path], rtol=1e-4, atol=1e-4, err_msg=path)


def test_pipeline_batch_of_an_embeddings_arch_reaches_the_step_as_floats(tmp_path):
    """The pipeline's stub-frontend vectors stay f32 on the way to the step
    (ids and positions go to int64), and equal the JAX pipeline's batch."""
    cfg = get_config("qwen2-vl-72b").reduced()
    shape = InputShape("t", S, B, "train")
    np_batch = Pipeline(cfg, shape).batch_at(0)
    jax_batch = JaxPipeline(jax_get_config("qwen2-vl-72b").reduced(), JaxShape("t", S, B, "train")).batch_at(0)
    for k in np_batch:
        np.testing.assert_array_equal(np_batch[k], jax_batch[k])
    tc = TrainerConfig(total_steps=1, ckpt_every=10**9, ckpt_async=False, ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, shape, SchedulePlan(remat="none"), tc, device="cpu")
    batch = tr.batch_at(0)
    assert batch["inputs"].dtype == torch.float32 and batch["inputs"].shape == (B, S, cfg.d_model)
    assert batch["positions"].dtype == torch.long and batch["positions"].shape == (B, 3, S)
    assert batch["labels"].dtype == torch.long


def test_serve_cli_declines_an_embeddings_arch(capsys):
    assert serve.main(["--arch", "musicgen-large", "--smoke", "--device", "cpu"]) == 0
    assert "stub modality frontend" in capsys.readouterr().out
