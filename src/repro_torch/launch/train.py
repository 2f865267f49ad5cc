"""Training CLI.

    python -m repro_torch.launch.train --arch granite-moe-1b-a400m --smoke --device cpu
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m --smoke --device cpu \
        --autotune mcts_1s                              # tune first, train with the plan
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m --batch 2 --seq 4096 \\
        --plan-json '{"microbatches": 2, "remat": "full"}'     # full width, on the card

``--smoke`` trains the reduced config (``--batch`` x ``--seq``, default 8 x
64).  Without it the config runs at full width on the card, at the shape
``--shape`` names with ``--batch`` / ``--seq`` in place of its batch and
sequence length where given.  Runs on the CUDA device unless ``--device
cpu`` is given; weights are random, drawn on the device from the trainer's
seed.

The plan starts from the schedule space's default for the cell; ``--autotune
ALGO`` replaces it with the plan the port's search finds for ``--arch`` x
``--shape`` priced for what trains it, one H100 (``hw="h100"``, mesh
``card``); ``--plan-json`` overrides fields last.  ``--smoke`` keeps the plan's ``remat`` and ``opt_dtype`` and at most 2
microbatches, as the JAX package's CLI does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true", help="the reduced() config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--plan-json", default=None)
    ap.add_argument("--autotune", default=None,
                    help="run this search algo first (e.g. mcts_1s) and train "
                         "with the found schedule")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # segments that grow in place, unless the caller chose otherwise: the
    # full-depth trainings peak near the card's memory, where fixed segments
    # left a large gradient no block while GiBs sat reserved in pieces (read
    # at the first allocation, so set before it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import InputShape
    from repro_torch.core.space import SchedulePlan, ScheduleSpace, get_mesh
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    space = ScheduleSpace(cfg, get_shape(args.shape), get_mesh("h100", "card"))
    plan = space.plan_from_actions(space.default_actions())
    if args.autotune:
        from repro_torch.core.autotuner import autotune

        res = autotune(args.arch, args.shape, algo=args.autotune, hw="h100", mesh="card")
        plan = res.plan
        print(f"[train] autotuned plan ({args.autotune}, h100 card): {plan}")
    if args.plan_json:
        plan = SchedulePlan.from_dict({**plan.to_dict(), **json.loads(args.plan_json)})
    if args.smoke:
        cfg = cfg.reduced()
        shape = InputShape("smoke", args.seq or 64, args.batch or 8, "train")
        plan = SchedulePlan(
            microbatches=min(plan.microbatches, 2),
            remat=plan.remat,
            grad_comm="fp32",
            opt_dtype=plan.opt_dtype,
        )
    else:
        shape = get_shape(args.shape)
        shape = dataclasses.replace(
            shape, seq_len=args.seq or shape.seq_len, global_batch=args.batch or shape.global_batch
        )
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 2, 1))
    if args.ckpt_dir:
        tc = dataclasses.replace(tc, ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, shape, plan, tc, device=args.device)
    _, _, step = trainer.run()
    for rec in trainer.metrics_log:
        print(f"[train] step={rec['step']:5d} loss={rec['loss']:.4f} "
              f"lr={rec['lr']:.2e} dt={rec['step_time_s'] * 1e3:.0f}ms")
    if trainer.metrics_log:
        print(f"[train] done at step {step}; final loss {trainer.metrics_log[-1]['loss']:.4f}")
    else:
        print(f"[train] done at step {step} (resumed past total_steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
