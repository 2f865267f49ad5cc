"""End to end on the CPU, as ``tests/test_system.py`` walks the JAX package:
autotune -> train -> checkpoint -> failure -> elastic restart plan -> serve,
and the port's quickstart and training CLI with ``--autotune``."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.autotuner import autotune
from repro_torch.core.space import SchedulePlan

torch.set_num_threads(1)


def test_autotune_then_train_then_serve(tmp_path):
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.trainer import Trainer, TrainerConfig

    # 1. autotune the real cell (full config, analytic model, the H100's
    #    spec and the one card) -- the plan's remat/optimizer knobs transfer
    res = autotune("granite-3-2b", "train_4k", algo="mcts_1s", seed=0, mesh="card",
                   n_standard=2, n_greedy=1)
    assert res.plan is not None and res.n_evals > 0

    # 2. train a reduced model with (the JAX test's projection of) that plan
    cfg = get_config("granite-3-2b").reduced()
    shape = InputShape("t", 32, 4, "train")
    plan = SchedulePlan(microbatches=2, remat=res.plan.remat, opt_dtype=res.plan.opt_dtype)
    tc = TrainerConfig(total_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path), log_every=2,
                       ckpt_async=False)
    trainer = Trainer(cfg, shape, plan, tc, device="cpu")
    params, _, step = trainer.run()
    assert step == 8

    # 3. simulated node failure -> elastic restart plan from the checkpoint
    plan2 = trainer.handle_failure(["h0", "h1", "h2"], chips_per_host=4, model_parallel=4)
    assert plan2.restart_step == 8
    assert plan2.data_parallel >= 1

    # 4. serve with the trained weights
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32, device="cpu")
    eng.submit(np.array([1, 2, 3]), max_new_tokens=4)
    eng.submit(np.array([9]), max_new_tokens=4)
    done = eng.run()
    assert len(done) == 2
    assert all(len(r.generated) == 4 for r in done)


def test_quickstart_tunes_trains_and_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import quickstart

    assert quickstart.main(["--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "not a measurement" in out and "h100-sxm" in out
    assert "trained to step 3" in out
    assert f"completed {quickstart.REQUESTS}/{quickstart.REQUESTS} requests" in out


def test_quickstart_measure_tunes_on_measured_step_times_on_the_cpu(tmp_path, capsys):
    """``--measure``: ``mcts_cost+real_1s`` with one fleet worker timing the
    reduced config's steps on the CPU (the card's target on ``--device
    cpu``), no measurement failing; a second run measures nothing anew."""
    from repro_torch.launch import quickstart

    cache = str(tmp_path / "measure_cache")
    argv = ["--device", "cpu", "--smoke", "--measure", "--measure-cache", cache]
    assert quickstart.main(argv) == 0
    out = capsys.readouterr().out
    assert "mcts_cost+real_1s" in out and ", 0 failures" in out
    assert f"completed {quickstart.REQUESTS}/{quickstart.REQUESTS} requests" in out
    records = [json.load(open(os.path.join(cache, f))) for f in os.listdir(cache)]
    assert records and all(r["source"] == "cpu" and r["cut"]["reduced"] for r in records)
    res, stats = quickstart.tune_measured("cpu", smoke=True, cache_dir=cache)
    assert stats["n_measured"] == 0 and res.n_measure_failures == 0
    assert res.n_measurements == stats["n_cache_hits"] + stats["n_deduped"] > 0


def test_quickstart_projects_only_microbatches_and_refuses_full_width_on_the_cpu():
    from repro_torch.launch import quickstart

    plan = SchedulePlan(microbatches=16, remat="none", opt_dtype="int8", grad_comm="int8",
                        attn_block=(256, 512))
    got = quickstart.project(plan)
    assert got == dataclasses.replace(plan, microbatches=quickstart.BATCH)
    assert quickstart.project(dataclasses.replace(plan, microbatches=1)).microbatches == 1
    with pytest.raises(SystemExit):
        quickstart.main(["--device", "cpu"])
