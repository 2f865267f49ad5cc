"""Quickstart of the port: tune a schedule with ProTuner, train with it, serve
with the trained weights, on the card.

    python -m repro_torch.launch.quickstart                       # on the H100
    python -m repro_torch.launch.quickstart --device cpu --smoke  # reduced config, CPU
    python -m repro_torch.launch.quickstart --measure             # tune on card step times

1. **Tune** granite-moe-1b-a400m x ``train_4k`` with ``mcts_1s`` (the
   ProTuner ensemble, 15 standard + 1 greedy MCTS) for the H100's spec and
   the one card the port runs on (``hw="h100"``, mesh ``card``).  The search
   runs on the host; it prints the plan and the cost model's estimated
   roofline terms, which are the model's arithmetic on datasheet constants,
   not a measurement.
2. **Train** 3 steps at full width at B = 2 x S = 4096 (``train_4k``'s global
   batch of 256 cut to 2, to fit one card's time) under the tuned plan.  The
   plan keeps its ``remat``, ``opt_dtype``, ``grad_comm`` and kernel tiles;
   ``microbatches`` is capped by the cut batch's rows, as the JAX quickstart
   projects its plan.
3. **Serve** 4 requests with the trained weights through ``ServingEngine``,
   its grouped GEMMs at the plan's tiles.

With ``--measure``, step 1 is the paper's measured-cost hybrid
``mcts_cost+real_1s``: each root synchronization's candidates are re-ranked
by step times measured on the card (``launch/measure.py``) through a
one-worker measurement fleet (``core/measure_fleet.py``), at full width and
``MEASURE_LAYERS`` of the 24 layers (``--smoke``: the ``reduced()`` config
at S = 64, on the CPU with ``--device cpu``).  Records are cached on disk by
program, so a second run measures nothing it has measured before.

Runs on the CUDA device unless ``--device cpu`` is given; the full-width
config runs only on the card (``--smoke`` is the reduced config).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import numpy as np

ARCH = "granite-moe-1b-a400m"
SHAPE = "train_4k"
ALGO = "mcts_1s"
BATCH, SEQ = 2, 4096  # the full-width cut of train_4k
SMOKE_SEQ = 64
STEPS = 3
SLOTS, REQUESTS, MAX_NEW = 4, 4, 8
SEED = 0
MEASURE_ALGO = "mcts_cost+real_1s"
MEASURE_LAYERS = 6  # the depth cut of a measurement on the card: full width, 6 of 24 layers


def tune():
    """(``TuneResult``, the cost model's ``RooflineTerms`` of its plan)."""
    from repro_torch.core.autotuner import autotune

    res = autotune(ARCH, SHAPE, algo=ALGO, hw="h100", mesh="card", seed=SEED)
    return res, tune_terms(res.plan)


def tune_terms(plan):
    """The cost model's ``RooflineTerms`` of ``plan`` in the tuned cell."""
    from repro_torch.core.autotuner import make_mdp

    return make_mdp(ARCH, SHAPE, "card", hw="h100").cost_model.terms(plan)


def measure_cut(smoke: bool = False) -> dict:
    return {"reduced": True, "seq": SMOKE_SEQ} if smoke else {"layers": MEASURE_LAYERS}


def tune_measured(device="cuda", smoke: bool = False, cache_dir=None, timeout: float = 600.0):
    """(``TuneResult``, the fleet's counters): ``mcts_cost+real_1s`` for the
    H100 spec and mesh ``card``, its candidates measured on ``device`` by one
    persistent worker (the card's one timing process)."""
    import torch

    from repro_torch.core.autotuner import autotune
    from repro_torch.core.measure_fleet import MeasurementFleet
    from repro_torch.launch.measure import CardTarget

    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()  # what this process cached is the worker's to use
    with MeasurementFleet(1, cache_dir=cache_dir, target=CardTarget(), timeout=timeout,
                          grace_s=120.0) as fleet:
        backend = fleet.bind(ARCH, SHAPE, "card", hw="h100", device=device,
                             cut=measure_cut(smoke))
        res = autotune(ARCH, SHAPE, algo=MEASURE_ALGO, hw="h100", mesh="card", seed=SEED,
                       measure_backend=backend)
        return res, fleet.stats()


def project(plan, batch: int = BATCH):
    """The tuned plan at the cut batch: every field kept but ``microbatches``,
    which cannot exceed the batch's rows."""
    return dataclasses.replace(plan, microbatches=min(plan.microbatches, batch))


def make_trainer(plan, *, smoke: bool = False, device="cuda", steps: int = STEPS):
    """A ``Trainer`` of granite-moe-1b-a400m (full width, or ``reduced()``) at
    B = 2 x S under ``plan``; AdamW peak lr 1e-3 after 2 warm-up steps, as
    ``chip_smoke.py``'s ``train`` phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.training import optimizer as optim
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(ARCH)
    if smoke:
        cfg = cfg.reduced()
    shape = InputShape("quickstart", SMOKE_SEQ if smoke else SEQ, BATCH, "train")
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, moment_dtype=plan.opt_dtype)
    tc = TrainerConfig(total_steps=steps, ckpt_every=10**9, log_every=1, ckpt_async=False,
                       seed=SEED)
    return Trainer(cfg, shape, plan, tc, opt_cfg=oc, device=device)


def train(trainer) -> Tuple[dict, int]:
    """Fresh weights (never a checkpoint), trained ``total_steps`` steps."""
    params, opt_state, _ = trainer.init_state()
    params, _, step = trainer.run(params, opt_state, 0)
    return params, step


def make_engine(cfg, params, plan, device="cuda"):
    """A ``ServingEngine`` over ``params`` with ``REQUESTS`` prompts queued."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=64, plan=plan, device=device)
    rng = np.random.default_rng(SEED)
    for _ in range(REQUESTS):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17))),
                   max_new_tokens=MAX_NEW)
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="the reduced() config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--measure", action="store_true",
                    help=f"tune with {MEASURE_ALGO}: candidates re-ranked by step times "
                         "measured on the device")
    ap.add_argument("--measure-cache", default=None, help="the measurement records' directory")
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.smoke:
        ap.error("the full-width config runs on the card; on the CPU pass --smoke")
    from repro_torch.core.hardware import H100

    algo = MEASURE_ALGO if args.measure else ALGO
    print(f"== 1. tuning {ARCH} x {SHAPE} with {algo} for {H100.name}, mesh card ==")
    if args.measure:
        res, stats = tune_measured(args.device, args.smoke, args.measure_cache)
        measured = "none" if res.measured is None else f"{res.measured:.4g} s"
        print(f"{res.n_measurements} measurements on {args.device} ({stats['n_measured']} "
              f"programs run, {stats['n_cache_hits']} cache hits, {stats['n_deduped']} joined "
              f"in flight), {res.n_measure_failures} failures; the plan's measured step "
              f"{measured} (the time of the cut {measure_cut(args.smoke)}, projected to the cell)")
        if res.n_measure_failures:
            print("a failed measurement re-ranks by the cost model's estimate")
        terms = tune_terms(res.plan)
    else:
        res, terms = tune()
    print(f"plan ({res.n_evals} cost evals, {res.cache_hits} cache hits, "
          f"{res.wall_time_s:.2f} s on the host):")
    for k, v in res.plan.to_dict().items():
        print(f"    {k:16s} = {v}")
    print(f"the cost model's estimate for the {H100.name} spec (datasheet constants; not a "
          f"measurement), global batch 256: step {terms.step_s * 1e3:.1f} ms (compute "
          f"{terms.compute_s * 1e3:.1f} / memory {terms.memory_s * 1e3:.1f} / collective "
          f"{terms.collective_s * 1e3:.1f}), dominant {terms.dominant}, "
          f"{terms.hbm_per_chip / 2**30:.1f} GiB a device, feasible {terms.feasible}")

    plan = project(res.plan)
    print(f"\n== 2. training {STEPS} steps at B={BATCH} x S={SMOKE_SEQ if args.smoke else SEQ} "
          f"({'reduced' if args.smoke else 'full width'}) on {args.device} ==")
    if plan.microbatches != res.plan.microbatches:
        print(f"microbatches {res.plan.microbatches} -> {plan.microbatches}: the cut batch "
              f"has {BATCH} rows")
    trainer = make_trainer(plan, smoke=args.smoke, device=args.device)
    params, step = train(trainer)
    print(f"    trained to step {step}")
    for r in trainer.metrics_log:
        print(f"    step {r['step']}  loss {r['loss']:.4f}  grad_norm {r['grad_norm']:.3f}  "
              f"{r['step_time_s'] * 1e3:.0f} ms")

    print(f"\n== 3. serving {REQUESTS} requests with the trained weights ==")
    eng = make_engine(trainer.cfg, params, plan, device=args.device)
    done = eng.run()
    for r in sorted(done, key=lambda r: r.uid):
        print(f"    req {r.uid}: {len(r.prompt)} prompt tokens -> {r.generated}")
    print(f"completed {len(done)}/{REQUESTS} requests")
    if args.measure and res.n_measure_failures:
        return 1
    return 0 if len(done) == REQUESTS else 1


if __name__ == "__main__":
    raise SystemExit(main())
