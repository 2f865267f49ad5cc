"""The inputs drawn from a seed repeat for that seed, and every seed serves
the same set of sizes."""
import torch

from cardbench import bench, draw


def test_cardbench_token_rows_repeat_for_a_seed():
    a = draw.token_rows(4, 16, 1000, 2**31 + 7, "cpu")
    assert torch.equal(a, draw.token_rows(4, 16, 1000, 2**31 + 7, "cpu"))
    assert not torch.equal(a, draw.token_rows(4, 16, 1000, 2**31 + 8, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 1000


def test_cardbench_weights_repeat_and_redraw_a_leaf_alone():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("falcon-mamba-7b").reduced()
    init = bench.load_json(bench.HERE / "configs" / "falcon-mamba-7b.json")["init"]
    meta = transformer.meta_params(cfg)
    w1 = dict(draw.flat(draw.weights(meta, init, cfg.n_layers, 3, "cpu")))
    w2 = dict(draw.flat(draw.weights(meta, init, cfg.n_layers, 3, "cpu")))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    one = draw.weights(meta, init, cfg.n_layers, 3, "cpu", only={"blocks.b0.mamba.in_proj"})
    assert torch.equal(one["blocks.b0.mamba.in_proj"], w1["blocks.b0.mamba.in_proj"])
    assert torch.allclose(w1["blocks.b0.mamba.A_log"][0, 0],
                          torch.log(torch.arange(1.0, cfg.ssm_state + 1)))
    assert {str(t.dtype) for t in w1.values()} == {"torch.float32"}


def test_cardbench_history_repeats_for_a_seed():
    a = draw.history((2, 2, 8, 4), 3.0, 9, "b0.0", "k", "cpu")
    assert torch.equal(a, draw.history((2, 2, 8, 4), 3.0, 9, "b0.0", "k", "cpu"))
    assert not torch.equal(a, draw.history((2, 2, 8, 4), 3.0, 9, "b0.0", "v", "cpu"))


def test_cardbench_every_seed_serves_the_same_histories():
    traffic = bench.load_json(bench.HERE / "traffic" / "decode-32k-16slots.json")
    kind = bench.load_module(bench.HERE / "kinds" / "decode.py")
    sets = [sorted(kind.history_lengths(traffic, s)) for s in (1, 2**31 + 5, 77)]
    assert sets[0] == sets[1] == sets[2]
    assert sets[0][0] == traffic["history_lengths"][0] and sets[0][-1] == traffic["history_lengths"][1]
    assert kind.history_lengths(traffic, 1) != kind.history_lengths(traffic, 77)
    most = traffic["history_lengths"][1] + traffic["warmup_steps"] + traffic["most_steps"]
    assert most <= traffic["max_len"]


def test_cardbench_sub_seeds_fit_a_generator():
    for seed in (0, 2**31 + 11, 2**40):
        s = draw.sub_seed(seed, "weights", "embed")
        assert 0 <= s < 2**63
        torch.Generator().manual_seed(s)
