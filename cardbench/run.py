"""Run one cell of the benchmark of the PyTorch and CUDA port, on this machine's card.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  One run: tune the cell's plan with the port's
own search (``repro_torch.core.autotuner.autotune``, the tuner's seed fixed
by the traffic file), draw the weights and inputs from ``--seed``, warm up
(the kind's set-up), measure for ``--seconds``, then decide ``correct`` by
the reference and print one JSON line last on standard output.  With
``--trace 0`` the line's metrics are the cell's end-to-end metrics; with
``--trace 1`` the window runs under the profiler and the metrics are the
cell's per-layer ones, with the device's busy seconds and a ``breakdown``.

The run exits with a code other than 0, and prints no result, where the
card is missing, where the program cannot be imported, or where a module of
JAX or of the JAX package (``repro``) is loaded once the window has closed.
The numbers ``correct`` compares are printed beside their limits, as the
last lines of standard error and under ``checks``, the result's last key.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """When this process started, on the ``time.time`` clock."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def prepare_environment() -> None:
    """Settings that must precede the first CUDA call, and the build and
    kernel caches at fixed folders of the checkout."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    cache = REPO / "build" / "cardbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)


def card_power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


# the keys of a published config that a configuration file may cut (its
# ``reduced``), and the program's field each one sets; no width is ever cut
CUTS = {"num_hidden_layers": "n_layers"}


def port_config(cell):
    """The program's ``ModelConfig`` of the cell, cut where the configuration
    file's ``reduced`` says, its sizes checked against the file's."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(cell.config["arch"])
    if cell.config.get("variant") == "reduced":  # a test configuration
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, **{CUTS[k]: cell.config["sizes"][CUTS[k]] for k in cell.config["reduced"]})
    port = {"head_dim": cfg.resolved_head_dim, "dt_rank": cfg.resolved_dt_rank,
            "period": [[s.mixer, s.mlp] for s in cfg.layer_plan()]}
    for key, want in cell.config["sizes"].items():
        have = port.get(key, getattr(cfg, key, want))
        if have != want:
            raise ValueError(f"{cell.config['arch']}: the program's {key} is {have}, the "
                             f"configuration file's {want}")
    if cfg.dtype != cell.config["dtype"]:
        raise ValueError(f"the program runs {cfg.dtype}, the configuration file states "
                         f"{cell.config['dtype']}")
    return cfg


def tune(run) -> None:
    """The plan of the port's own search, projected to the cell's rows."""
    import dataclasses

    from repro_torch.core.autotuner import autotune

    import torch

    t = run.cell.traffic["tune"]
    with torch.profiler.record_function("tune"):
        t0 = time.perf_counter()
        res = autotune(run.cell.config["arch"], t["shape"], algo=t["algo"], hw=t["hw"],
                       mesh=t["mesh"], seed=t["seed"])
        run.tune_s = time.perf_counter() - t0
    plan = res.plan
    if "rows" in run.cell.traffic:  # microbatches cannot exceed a step's rows
        plan = dataclasses.replace(plan, microbatches=min(plan.microbatches, run.cell.traffic["rows"]))
    run.plan = plan
    print(f"plan ({t['algo']} on {run.cell.config['arch']} x {t['shape']}, hw {t['hw']}, mesh "
          f"{t['mesh']}, tuner seed {t['seed']}; {run.tune_s:.3f} s): {json.dumps(plan.to_dict())}",
          flush=True)


def execute(run) -> dict:
    """Everything of a run after the look for a card: returns the result."""
    import torch

    from cardbench import bench, trace

    kind = run.cell.kind()
    run.cfg = port_config(run.cell)
    tune(run)
    if run.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    state = kind.setup(run)
    bench.sync(run.device)
    run.setup_s = time.time() - run.process_start
    if run.traced:
        run.trace = trace.profiled(lambda: kind.window(state, run))
    else:
        kind.window(state, run)
    bench.sync(run.device)
    run.peak_bytes = torch.cuda.max_memory_allocated() if run.device != "cpu" else None
    kind.finish(state, run)
    kind.check(state, run)
    found = bench.forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or of the JAX package were loaded: {found}")
    metrics = bench.read_metrics(run, run.cell.per_layer if run.traced else run.cell.end_to_end)
    device = {"platform": "gpu" if run.device != "cpu" else "cpu",
              "kind": torch.cuda.get_device_name() if run.device != "cpu" else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": run.peak_bytes}
    if run.device != "cpu":
        device["power_limit"] = card_power_limit()
    out = {"correct": run.correct and run.failed == 0, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    prepare_environment()
    import torch

    from cardbench import bench

    cell = bench.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    run = bench.Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", process_start=started)
    try:
        out = execute(run)
    except ImportError as e:
        print(f"not run: {e}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
