"""ProTuner CLI of the port: search for the best schedule of one
(arch × shape × mesh) cell on one hardware.

    python -m repro_torch.launch.autotune --arch granite-moe-1b-a400m --shape train_4k \
        --algo mcts_1s --cost hybrid --device cpu          # the MLP on the CPU
    python -m repro_torch.launch.autotune --arch granite-moe-1b-a400m --shape train_4k \
        --algo mcts_1s --cost hybrid --device cuda --hw h100 --mesh card
    python -m repro_torch.launch.autotune --arch granite-moe-1b-a400m --shape train_4k \
        --algo mcts_cost+real_1s --mesh card --measure --measure-layers 6   # on the card

The JAX CLI's flags, plus ``--hw`` (the hardware the cell is priced for) and
``--device`` (where a learned cost model, ``--pricing jit`` and ``--measure``
run; the analytic default never touches torch).  ``--measure`` times each
root synchronization's candidates on ``--device`` through a measurement
fleet (``launch/measure.CardTarget``; one worker, the only width the card
takes), at ``--measure-layers`` of the arch's layers when given.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--algo", default="mcts_30s")
    ap.add_argument("--hw", default="h100", choices=["h100", "tpu-v5e"],
                    help="the hardware the cell is priced for")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "card"],
                    help="a mesh of --hw (card: one H100)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the learned cost model, --pricing jit and --measure run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--measure", action="store_true",
                    help="time candidates on --device at root syncs")
    ap.add_argument("--measure-workers", type=int, default=1,
                    help="with --measure: fleet workers (one on the card: two processes "
                         "timing on one GPU spoil each other's times)")
    ap.add_argument("--measure-layers", type=int, default=None,
                    help="with --measure: cut the depth to this many layers (full width)")
    ap.add_argument("--budget-s", type=float, default=None)
    ap.add_argument("--engine", default="array",
                    choices=["reference", "array"],
                    help="MCTS tree engine (array = vectorized + shared "
                         "transposition cache; identical results)")
    ap.add_argument("--cost", default="analytic",
                    choices=["analytic", "learned", "hybrid"],
                    help="cost serving mode: analytic (exact), learned "
                         "(online-trained MLP prices cache misses), hybrid "
                         "(learned only while confident; analytic fallback)")
    ap.add_argument("--pricing", default=None,
                    choices=["scalar", "columnar", "jit"],
                    help="analytic pricing kernel: columnar (exact, "
                         "default), scalar (exact oracle replay), jit "
                         "(float64 torch program on --device, within "
                         "JIT_RTOL of columnar, versioned tag)")
    ap.add_argument("--store", default=None,
                    help="PlanStore root directory: answer repeats from "
                         "disk, record this run, and (evolve/portfolio) "
                         "seed the population from stored plans")
    ap.add_argument("--parallel", action="store_true",
                    help="run ensemble trees on persistent pinned worker "
                         "processes (per-round deltas both directions; "
                         "identical results)")
    ap.add_argument("--workers", type=int, default=None,
                    help="cap the pinned worker pool (default: one per "
                         "core, up to the tree count)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.core.autotuner import autotune, make_mdp

    plan_store = None
    if args.store:
        from repro_torch.service.store import PlanStore

        plan_store = PlanStore(args.store)
    measure_backend = fleet = None
    if args.measure:
        from repro_torch.core.measure_fleet import MeasurementFleet
        from repro_torch.launch.measure import CardTarget

        fleet = MeasurementFleet(args.measure_workers, target=CardTarget())
        cut = {"layers": args.measure_layers} if args.measure_layers else None
        measure_backend = fleet.bind(args.arch, args.shape, args.mesh, hw=args.hw,
                                     device=args.device, cut=cut)
    try:
        res = autotune(
            args.arch,
            args.shape,
            algo=args.algo,
            mesh=args.mesh,
            seed=args.seed,
            measure_backend=measure_backend,
            time_budget_s=args.budget_s,
            engine=args.engine,
            parallel=args.parallel,
            cost=args.cost,
            n_workers=args.workers,
            pricing=args.pricing,
            plan_store=plan_store,
            hw=args.hw,
            device=args.device,
        )
    finally:
        if fleet is not None:
            fleet.shutdown()
    mdp = make_mdp(args.arch, args.shape, args.mesh, hw=args.hw)
    terms = mdp.cost_model.terms(res.plan)
    print(f"[autotune] {args.arch}×{args.shape} hw={res.hw} mesh={args.mesh} "
          f"algo={res.algo}{' (from store)' if res.from_store else ''}")
    if res.cost_mode != "analytic":
        print(f"[autotune] cost serving: {res.cost_mode} on {args.device} "
              f"(model v{res.model_version}, {res.n_fits} fits, "
              f"{res.learned_evals} learned-priced plans)")
    if res.submit_bytes:
        print(f"[autotune] pinned pool: {res.submit_bytes:,}B submitted / "
              f"{res.return_bytes:,}B returned over "
              f"{len(res.submit_bytes_rounds)} rounds, "
              f"{res.snapshot_bytes:,}B snapshot, "
              f"{res.n_worker_restarts} worker restarts")
    if fleet is not None:
        print(f"[autotune] measurement fleet: {fleet.stats()}")
    if res.n_measure_failures:
        print(f"[autotune] WARNING: {res.n_measure_failures} candidate(s) "
              f"degraded to analytic cost after measurement failure")
    print(f"[autotune] best cost {res.cost*1e3:.2f} ms "
          f"(measured: {res.measured and f'{res.measured*1e3:.2f} ms'}) "
          f"evals={res.n_evals} measurements={res.n_measurements} "
          f"wall={res.wall_time_s:.1f}s")
    print(f"[autotune] plan: {json.dumps(res.plan.to_dict())}")
    print(f"[autotune] terms (the cost model's estimate): "
          f"compute={terms.compute_s*1e3:.2f}ms "
          f"memory={terms.memory_s*1e3:.2f}ms "
          f"collective={terms.collective_s*1e3:.2f}ms "
          f"dominant={terms.dominant} feasible={terms.feasible} "
          f"MFU={terms.details['mfu']:.3f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res.to_dict(), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
