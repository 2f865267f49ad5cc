"""The reference against the program's CPU path at the ``reduced()`` sizes,
through the harness's own run (the look for a card skipped), and its pieces
against plain versions."""
import pytest
import torch

from cardbench.reference import model as M
from cardbench.tests import tiny

import cardbench.run as R


@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.DECODE])
def test_cardbench_tiny_cell_is_correct_on_the_cpu(tmp_path, name):
    out = R.execute(tiny.run(tiny.cell(tmp_path, name)))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {m for m in out["metrics"]} >= {"setup_s"}


@pytest.mark.card
@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.DECODE])
def test_cardbench_tiny_cell_is_correct_on_the_card(tmp_path, name, card):
    run = tiny.run(tiny.cell(tmp_path, name))
    run.device = card
    out = R.execute(run)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0


def _scan_loop(u, dt, A, Bm, Cm, D):
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=u.dtype)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1) + u * D


def test_cardbench_scan_and_its_backward():
    g = torch.Generator().manual_seed(0)
    B, L, Di, N = 2, 7, 3, 4
    args = [torch.randn(B, L, Di, generator=g, dtype=torch.float64),
            torch.rand(B, L, Di, generator=g, dtype=torch.float64) * 0.5,
            -torch.rand(Di, N, generator=g, dtype=torch.float64) - 0.1,
            torch.randn(B, L, N, generator=g, dtype=torch.float64),
            torch.randn(B, L, N, generator=g, dtype=torch.float64),
            torch.randn(Di, generator=g, dtype=torch.float64)]
    assert torch.allclose(M.Scan.apply(*args), _scan_loop(*args))
    ins = [a.clone().requires_grad_() for a in args]
    torch.autograd.gradcheck(M.Scan.apply, ins)


def test_cardbench_moe_drops_pairs_as_the_program_does():
    """A router that sends every token to expert 0: the pairs past its
    capacity are dropped alike."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import DEFAULT_TILES
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = M.Model.from_file(bench_config(cfg))
    g = torch.Generator().manual_seed(1)
    p = {"router": torch.randn(cfg.d_model, cfg.n_experts, generator=g),
         "w_up": torch.randn(cfg.n_experts, cfg.d_model, cfg.d_ff, generator=g) * 0.05,
         "w_gate": torch.randn(cfg.n_experts, cfg.d_model, cfg.d_ff, generator=g) * 0.05,
         "w_down": torch.randn(cfg.n_experts, cfg.d_ff, cfg.d_model, generator=g) * 0.05}
    p["router"][:, 0] += 50.0
    x = torch.randn(2, 256, cfg.d_model, generator=g)
    got = moe.forward(p, cfg, x, tiles=DEFAULT_TILES)
    want = M.moe(p, m, x.reshape(1, 512, -1), "float32").reshape(x.shape)
    assert M.capacity(512, m) < 512  # expert 0 drops pairs
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-4)


def bench_config(cfg):
    return {"sizes": {"d_model": cfg.d_model, "n_layers": cfg.n_layers, "vocab_size": cfg.vocab_size,
                      "period": [["attn", "moe"]], "norm_eps": 1e-6, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
                      "d_ff": cfg.d_ff, "n_experts": cfg.n_experts,
                      "experts_per_token": cfg.experts_per_token}}


def test_cardbench_attention_against_the_program():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import DEFAULT_TILES
    from repro_torch.models import attention

    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = M.Model.from_file(bench_config(cfg))
    g = torch.Generator().manual_seed(2)
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {"wq": torch.randn(d, H * hd, generator=g) * 0.1, "wk": torch.randn(d, Hk * hd, generator=g) * 0.1,
         "wv": torch.randn(d, Hk * hd, generator=g) * 0.1, "wo": torch.randn(H * hd, d, generator=g) * 0.1}
    x = torch.randn(2, 24, d, generator=g)
    pos = torch.arange(24)[None].expand(2, 24)
    got = attention.forward(p, cfg, x, pos, tiles=DEFAULT_TILES)
    assert torch.allclose(got, M.attention(p, m, x, pos, "float32"), atol=1e-5, rtol=1e-4)
