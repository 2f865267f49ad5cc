"""The card's measurement: run a plan's step on one H100 at a stated cut and time it.

The counterpart of the JAX package's ``launch/dryrun.py`` (the CLI: the same
flags and ``--json-out`` contract, plus ``--device``, ``--hw`` and the cut)
and ``launch/dryrun_impl.py`` (``evaluate_cell``).  Where the reference
compiles the step for a 512-device TPU mesh and reads roofline terms out of
XLA's HLO, this builds the port's step for the plan's cell kind and runs it:

* train: ``make_train_step`` with the optimizer state for ``plan.opt_dtype``;
* prefill: ``make_prefill_step``;
* decode: ``make_serve_step`` over ``init_cache(..., kv_dtype=plan.kv_dtype)``.

It runs at full width at a cut of the cell (``CUT_ROWS`` in
``core/measure.py``): train B = 2 x S (``microbatches`` capped at 2), prefill
1 x S, decode 16 rows over a cache of ``max_len`` = S with ``cur`` = S - 1,
so every step attends the full cache.  ``--layers`` cuts the depth (full
width, fewer layers), ``--seq`` the sequence, and
``--reduced`` takes the ``reduced()`` config (the CPU tests).  Every cut is
listed in the record's ``cut``.  Timing: the host clock around steps that
end in ``torch.cuda.synchronize()``, ``WARMUP`` steps first, then the median
of ``TIMED`` steps with their spread.  The training step runs at learning
rate 0, so the weights stay the seed's and every program of a tune sees the
same weights and data; the step's work is the same at any learning rate.

The record has the reference's fields, so that ``mcts_cost+real_*`` and the
fleet work unchanged:

* ``step_s``: the card's time of the cut projected to the cell's work a
  device, linearly in rows, in layers under a depth cut, and in the
  sequence under a sequence cut (``projection`` states the factors; linear
  in layers counts the embedding and logits with every layer, and linear in
  the sequence leaves out attention's quadratic term), so that it is in the
  cell's seconds, as the analytic ``step_s`` a failed measurement falls back
  to is; ``measured_s``: the raw time of the cut;
* ``compute_s``, ``memory_s``, ``collective_s``, ``dominant``, ``feasible``
  and ``model_step_s``: the analytic cost model's, for the plan
  (``terms_source`` says so);
* ``mfu``: model FLOPs / (``step_s`` x chips x the spec's peak), measured;
* ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over the program at
  the cut (weights, state, cache and the step's work), and ``fits_hbm``;
* ``device``: the card's name and power limit; ``source``: ``"card"``, or
  ``"cpu"`` on a CPU run.

Only mesh ``card`` is timed.  Meshes ``single`` and ``multi`` take the
production-mesh dry run (``launch/dryrun_impl.evaluate_cell``), as the
reference's measurement does: one rank's step counted on the meta device, a
record with ``source: "dryrun"`` whose ``step_s`` is its roofline, never a
time (one card is never timed and called a mesh); it runs the full config,
so it takes no cut, and needs no device.  Without a card mesh ``card``
raises unless ``--device cpu`` is given.  A measurement that fails raises;
nothing computed on the CPU ever stands in for a card time.

``CardTarget`` is the fleet's target (``core/measure_fleet.py``): in its one
persistent worker process it keeps the CUDA context and the model's weights
(which do not depend on the plan) resident across requests and rebuilds
only the step and its state.

    python -m repro_torch.launch.measure --arch granite-moe-1b-a400m --shape train_4k --mesh card
    python -m repro_torch.launch.measure --arch granite-moe-1b-a400m --shape decode_32k \\
        --mesh card --layers 6 --plan-json '{"kv_dtype": "int8"}' --json-out rec.json
    python -m repro_torch.launch.measure --arch granite-moe-1b-a400m --shape train_4k \\
        --mesh card --device cpu --reduced --seq 64
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
import traceback
from typing import Optional

SEED = 0
WARMUP = 1
TIMED = 3


def default_plan(cfg, shape, mspec, hw):
    from repro_torch.core.space import ScheduleSpace

    space = ScheduleSpace(cfg, shape, mspec, hw)
    return space.plan_from_actions(space.default_actions())


def _device_info(dev) -> dict:
    import torch

    if dev.type == "cpu":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    _, _, limit = out.stdout.strip().splitlines()[0].partition(",")
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit.strip()}


class ResidentWeights:
    """The seed's weights of one model, kept while requests name the same
    (arch, cut, device): one model at a time."""

    def __init__(self):
        self.key, self.params = None, None

    def get(self, cfg, key, dev) -> dict:
        import torch

        from repro_torch.models import transformer

        if self.key != key:
            self.key, self.params = None, None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            self.key, self.params = key, transformer.init_params(cfg, SEED, device=dev)
        return self.params


def _cut_config(arch: str, cut: dict):
    """(the config the record projects to, the config that runs at the cut)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cut.get("reduced"):
        cfg = cfg.reduced()
    layers = int(cut.get("layers") or cfg.n_layers)
    period = len(cfg.layer_plan())
    if not 0 < layers <= cfg.n_layers or layers % period:
        raise ValueError(f"{cfg.name}: a depth cut of {layers} layers must be a multiple of its "
                         f"period ({period}) up to {cfg.n_layers}")
    run_cfg = dataclasses.replace(cfg, n_layers=layers) if layers != cfg.n_layers else cfg
    return cfg, run_cfg


def _model_inputs(cfg, tokens, rng):
    """The step's ``inputs``: the token ids, or for an embeddings arch (a stub
    frontend, as the JAX dry run's input specs have it) ``(rows, seq, d)``
    standard normal vectors drawn from ``rng``, in the model dtype."""
    import torch

    if cfg.input_kind == "tokens":
        return tokens
    x = rng.standard_normal(tuple(tokens.shape) + (cfg.d_model,)).astype("float32")
    return torch.from_numpy(x).to(tokens.device, getattr(torch, cfg.dtype))


def _time_steps(run, dev) -> list:
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        run()
    sync()
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        run()
        sync()
        times.append(time.perf_counter() - t0)
    return times


def evaluate_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str = "card",
    plan=None,
    *,
    hw: str = "h100",
    device="cuda",
    cut: Optional[dict] = None,
    devices: Optional[int] = None,
    weights: Optional[ResidentWeights] = None,
    verbose: bool = True,
) -> dict:
    """Build the port's step for ``plan`` on ``device``, run it at the cut,
    and return the measurement record (module docstring).  ``weights``
    keeps the model across calls; without it the weights are built anew.
    Meshes ``single`` and ``multi``: the dry run's record."""
    if mesh_kind != "card":
        return _dry_run(arch, shape_name, mesh_kind, plan, hw=hw, cut=cut, devices=devices,
                        verbose=verbose)
    if devices not in (None, 1):
        raise ValueError(f"mesh 'card' is one device, not {devices}")
    import numpy as np
    import torch

    from repro_torch.configs import get_shape
    from repro_torch.configs.base import InputShape
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.measure import CUT_ROWS, program_of
    from repro_torch.core.space import get_mesh
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as optim
    from repro_torch.training.train_step import (
        make_positions, make_prefill_step, make_serve_step, make_train_step,
    )

    dev = resolve_device(device)
    cut = dict(cut or {})
    spec = get_hardware(hw)
    mspec = get_mesh(spec, mesh_kind)
    shape = get_shape(shape_name)
    kind = shape.kind
    cfg, run_cfg = _cut_config(arch, cut)
    if plan is None:
        plan = default_plan(cfg, shape, mspec, spec)
    rows = CUT_ROWS[kind]
    seq = int(cut.get("seq") or shape.seq_len)
    program = program_of(plan, kind)
    run_plan = dataclasses.replace(plan, microbatches=min(plan.microbatches, rows))
    run_shape = InputShape(f"{shape_name}-cut", seq, rows, kind)
    params = (weights or ResidentWeights()).get(
        run_cfg, (arch, bool(cut.get("reduced")), run_cfg.n_layers, str(dev)), dev)
    rng = np.random.default_rng(SEED)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if kind == "train":
        oc = optim.OptimizerConfig(peak_lr=0.0, moment_dtype=plan.opt_dtype)
        state = {"opt": optim.init_opt_state(params, oc)}
        tokens = torch.from_numpy(rng.integers(0, run_cfg.vocab_size, (rows, seq))).to(dev)
        batch = {"inputs": _model_inputs(run_cfg, tokens, rng), "labels": tokens,
                 "positions": make_positions(run_cfg, rows, seq, device=dev)}
        step = make_train_step(run_cfg, run_shape, run_plan, oc, device=dev)

        def run():
            _, state["opt"], _ = step(params, state["opt"], batch)
    elif kind == "prefill":
        tokens = torch.from_numpy(rng.integers(0, run_cfg.vocab_size, (rows, seq))).to(dev)
        batch = {"inputs": _model_inputs(run_cfg, tokens, rng),
                 "positions": make_positions(run_cfg, rows, seq, device=dev)}
        step = make_prefill_step(run_cfg, run_shape, run_plan, device=dev)

        def run():
            step(params, batch)
    else:
        cache = transformer.init_cache(run_cfg, rows, seq, kv_dtype=plan.kv_dtype, device=dev)
        tokens = torch.from_numpy(rng.integers(0, run_cfg.vocab_size, (rows, 1))).to(dev)
        tokens = _model_inputs(run_cfg, tokens, rng)
        step = make_serve_step(run_cfg, run_shape, run_plan, device=dev)

        def run():
            step(params, cache, tokens, seq - 1)
    times = _time_steps(run, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del run, step
    gc.collect()

    measured = statistics.median(times)
    chips = mspec.size
    per_device_rows = shape.global_batch / chips
    factors = {"rows": per_device_rows / rows, "layers": cfg.n_layers / run_cfg.n_layers,
               "seq": shape.seq_len / seq}
    factor = factors["rows"] * factors["layers"] * factors["seq"]
    step_s = measured * factor
    terms = AnalyticCostModel(cfg, shape, mspec, spec).terms(plan)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if kind == "train" else 2.0) * n_active * shape.tokens
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "devices": devices,
        "hw": spec.name, "plan": plan.to_dict(), "program": program,
        "cut": {"kind": kind, "rows": rows, "seq": seq, "layers": run_cfg.n_layers,
                "n_layers": cfg.n_layers, "reduced": bool(cut.get("reduced")),
                "microbatches": run_plan.microbatches if kind == "train" else None,
                "warmup": WARMUP, "timed": TIMED,
                "learning_rate": 0.0 if kind == "train" else None},
        "projection": {**factors, "factor": factor,
                       "rule": "step_s = measured_s x (cell rows a device / cut rows) x "
                               "(layers / cut layers) x (cell seq / cut seq)"},
        "measured_s": measured, "measured_runs_s": times, "spread_s": max(times) - min(times),
        "step_s": step_s,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "model_step_s": terms.step_s,
        "dominant": terms.dominant, "feasible": terms.feasible,
        "terms_source": f"analytic cost model ({spec.name} spec), not measured",
        "model_flops": model_flops, "chips": chips,
        "mfu": model_flops / (step_s * chips * spec.peak_flops),
        "peak_bytes": peak,
        "fits_hbm": None if peak is None else bool(peak <= spec.hbm_bytes),
        "device": _device_info(dev),
        "source": "card" if dev.type == "cuda" else "cpu",
    }
    if verbose:
        print(f"[measure] {arch} x {shape_name} x {mesh_kind} on {record['device']['name']}: "
              f"{measured * 1e3:.2f} ms at the cut ({kind}, {rows} x {seq}, "
              f"{run_cfg.n_layers}/{cfg.n_layers} layers) -> step_s {step_s:.4g} s "
              f"(x{factor:g}); the model's {terms.step_s:.4g} s", flush=True)
    return record


def _dry_run(arch, shape_name, mesh_kind, plan, *, hw, cut, devices, verbose) -> dict:
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.space import get_mesh
    from repro_torch.launch import dryrun_impl

    if any((cut or {}).values()):
        raise ValueError(f"mesh {mesh_kind!r} takes the dry run, which runs the full config: "
                         f"no cut ({cut})")
    size = get_mesh(get_hardware(hw), mesh_kind).size
    if devices not in (None, size):
        raise ValueError(f"mesh {mesh_kind!r} on {hw} has {size} ranks, not {devices}")
    record = dryrun_impl.evaluate_cell(arch, shape_name, mesh_kind, plan, hw=hw, verbose=verbose)
    record["devices"] = devices
    return record


class CardTarget:
    """The fleet's target: a request dict (``core.measure.make_request`` with
    ``device`` set) -> its record.  The fleet sends it to its worker process
    once; there it keeps the weights across requests."""

    def __init__(self):
        self.weights = ResidentWeights()

    def __call__(self, req: dict) -> dict:
        from repro_torch.core.space import SchedulePlan

        if req["mesh"] == "card" and req.get("device") is None:
            raise ValueError("a card measurement names its device ('cuda' or 'cpu')")
        plan = req.get("plan")
        return evaluate_cell(
            req["arch"], req["shape"], req["mesh"],
            SchedulePlan.from_dict(plan) if plan is not None else None,
            hw=req.get("hw") or "h100", device=req.get("device") or "cuda", cut=req.get("cut"),
            devices=req.get("devices"), weights=self.weights, verbose=False,
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--shape", help="input shape id (train_4k/prefill_32k/decode_32k/long_500k)")
    ap.add_argument("--mesh", default="card", choices=["single", "multi", "card"])
    ap.add_argument("--all", action="store_true", help="run every (arch x shape) cell")
    ap.add_argument("--plan-json", default=None, help="SchedulePlan overrides as JSON")
    ap.add_argument("--json-out", default=None, help="write record(s) to this JSON file")
    ap.add_argument("--devices", type=int, default=None, help="device count (mesh card: 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hw", default="h100", help="the hardware spec the model prices for")
    ap.add_argument("--layers", type=int, default=None, help="depth cut: layers that run")
    ap.add_argument("--seq", type=int, default=None, help="sequence cut")
    ap.add_argument("--reduced", action="store_true", help="the reduced() config")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.space import SchedulePlan, get_mesh

    cut = {k: getattr(args, k) for k in ("layers", "seq", "reduced") if getattr(args, k)}
    if args.all:
        todo = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        todo = [(args.arch, args.shape)]
    records, failures = [], []
    for arch, shape in todo:
        try:
            plan = None
            if args.plan_json:
                cfg = get_config(arch)
                cfg = cfg.reduced() if args.reduced else cfg
                spec = get_hardware(args.hw)
                d = default_plan(cfg, get_shape(shape), get_mesh(spec, args.mesh), spec).to_dict()
                d.update(json.loads(args.plan_json))
                plan = SchedulePlan.from_dict(d)
            records.append(evaluate_cell(arch, shape, args.mesh, plan, hw=args.hw,
                                         device=args.device, cut=cut, devices=args.devices))
        except Exception as e:  # noqa: BLE001 - report all failures at the end
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if args.json_out:
        out = records[0] if (not args.all and records) else records
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    if failures:
        print(f"[measure] {len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        return 1
    where = "the meta device (dry run)" if args.mesh != "card" else args.device
    print(f"[measure] all {len(records)} cell(s) measured on {where}, mesh={args.mesh}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
