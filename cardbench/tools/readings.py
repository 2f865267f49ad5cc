"""The readings that a cell's limits on ``correct`` are set from, on the card.

    python3 cardbench/tools/readings.py --workload <cell> --seeds 11,12,13 \\
        [--control 11,12] [--fault half_batch:11,12] [--seconds 40] \\
        [--set traffic.history_std=1.0] [--diagnose]

For each seed of ``--seeds``: the program's numbers against the reference's
(a sound run: the lower reading).  ``--control``: the reference at float8 in
the program's place, against the reference (the upper reading).
``--fault name:seeds``: the program with a fault planted underneath, against
the reference (training cells: ``half_batch``, the loss taken over half of
each row's positions; ``nu_unwritten``, the optimizer's second moment
never stored; the loss gap, which the cell does not compare, is printed
beside).  ``--set part.key=json`` changes a value of the cell's traffic or
of its configuration's ``init`` for this process, to read a variant
before it is written to the files;
``--diagnose`` adds, for a decode cell, each layer's worst and median row
error and how varied the served tokens are.  A decode cell serves for
``--seconds`` before its comparison, as a run does.  One JSON line a
reading on standard output and in ``--out``; the program and the reference
run one after the other in this process, the program's state freed first.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def half_batch():
    """The program's loss over the first half of each row's positions."""
    from repro_torch.training import train_step

    whole = train_step.cross_entropy

    def half(logits, labels, **kw):
        n = logits.shape[1] // 2
        return whole(logits[:, :n], labels[:, :n], **kw)

    train_step.cross_entropy = half
    try:
        yield
    finally:
        train_step.cross_entropy = whole


@contextlib.contextmanager
def nu_unwritten():
    """The program's optimizer computes the second moment but never stores
    it: of each chunk's two moment writes, first ``mu`` then ``nu``, the
    second is dropped."""
    from repro_torch.training import optimizer

    write = optimizer._mom_write_
    calls = [0]

    def first_only(m, val, *a, **kw):
        calls[0] += 1
        if calls[0] % 2:
            write(m, val, *a, **kw)

    optimizer._mom_write_ = first_only
    try:
        yield
    finally:
        optimizer._mom_write_ = write


FAULTS = {"half_batch": half_batch, "nu_unwritten": nu_unwritten}


def new_run(cell, seed, seconds, device):
    from cardbench import bench

    import cardbench.run as R

    run = bench.Run(cell, seed, seconds, False, device, process_start=time.time())
    run.cfg = R.port_config(cell)
    R.tune(run)
    return run


def train_readings(cell, seed, args, out, fault=None):
    import torch

    kind = cell.kind()
    run = new_run(cell, seed, args.seconds, args.device)
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        st = kind.setup(run)
    prog = kind.program_numbers(st)
    kind.finish(st, run)
    t0 = time.perf_counter()
    ref = kind.reference_numbers(run, st.meta, "float32")
    ref_s = time.perf_counter() - t0
    emit(out, cell.name, seed, "fault:" + fault if fault else "program",
         kind.compare(prog, ref), reference_s=ref_s, loss_gap=abs(prog["loss"] - ref["loss"]),
         worst_grad_leaf=kind.worst_leaf(prog["grad_norms"], ref["grad_norms"], ref)[1],
         worst_nu_leaf=kind.worst_leaf(prog["nu_norms"], ref["nu_norms"], ref)[1],
         worst_change_leaf=kind.worst_leaf(prog["changes"], ref["changes"], ref)[1])
    if seed in args.control and fault is None:
        t0 = time.perf_counter()
        ctl = kind.reference_numbers(run, st.meta, "float8")
        emit(out, cell.name, seed, "control:float8", kind.compare(ctl, ref),
             reference_s=time.perf_counter() - t0, loss_gap=abs(ctl["loss"] - ref["loss"]),
             worst_change_leaf=kind.worst_leaf(ctl["changes"], ref["changes"], ref)[1])
    torch.cuda.empty_cache()


def decode_readings(cell, seed, args, out, fault=None):
    import torch

    from cardbench import bench

    kind = cell.kind()
    run = new_run(cell, seed, args.seconds, args.device)
    st = kind.setup(run)
    kind.window(st, run)
    bench.sync(run.device)
    kind.finish(st, run)
    t0 = time.perf_counter()
    logits, rows = kind.reference_outputs(run, st.meta, st.hist, st.served, "float32")
    ref_s = time.perf_counter() - t0
    emit(out, cell.name, seed, "program", kind.compare(logits, rows, st.served, st.written),
         reference_s=ref_s, steps=st.served.shape[1] - 1)
    if args.diagnose:
        emit(out, cell.name, seed, "diagnosis", diagnosis(logits, rows, st.served, st.written))
    if seed in args.control:
        ctl_logits, ctl_rows = kind.reference_outputs(run, st.meta, st.hist, st.served, "float8")
        first = ctl_logits.argmax(dim=-1).cpu()  # the token float8 puts first at each position
        served = torch.cat([st.served[:, :1], first], dim=1)
        emit(out, cell.name, seed, "control:float8", kind.compare(logits, rows, served, ctl_rows))
        if args.diagnose:
            emit(out, cell.name, seed, "control diagnosis", diagnosis(logits, rows, served, ctl_rows))
    torch.cuda.empty_cache()


def diagnosis(logits, rows, served, written) -> dict:
    """Each layer's worst and median K/V row error, the served tokens'
    variety, and the reference's margin between its best two tokens."""
    import torch

    layers = {}
    for (block, p, name), ref in rows.items():
        got = written[(block, p, name)].to(ref.device)
        e = (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)
        layers[f"{block}.{p}.{name}"] = [float(e.max()), float(e.median())]
    top2 = logits.topk(2, dim=-1).values
    nxt = served[:, 1:].to(logits.device)
    gap = logits.max(dim=-1).values - logits.gather(-1, nxt[..., None])[..., 0]  # (slots, steps)
    return {"layers": layers,
            "gap_first_step": float(gap[:, 0].max()),
            "gap_by_step_max": [round(float(g), 4) for g in gap.max(dim=0).values[:12]],
            "gap_quantiles": [float(q) for q in gap.flatten().quantile(torch.tensor(
                [0.5, 0.9, 0.99], device=gap.device))],
            "distinct_tokens_per_slot": [len(set(r.tolist())) for r in served],
            "repeats_input": float((served[:, 1:] == served[:, :-1]).float().mean()),
            "margin_median": float((top2[..., 0] - top2[..., 1]).median()),
            "logit_std": float(logits.std())}


def override(cell, specs) -> None:
    for spec in specs:
        key, _, value = spec.partition("=")
        part, _, name = key.partition(".")
        parts = {"traffic": cell.traffic, "init": cell.config["init"]}
        target = parts[part]
        target[name] = json.loads(value)


def emit(out, cell, seed, what, numbers, **extra):
    line = json.dumps({"cell": cell, "seed": seed, "what": what, **numbers, **extra})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def seeds(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", action="append", default=[], help="name:seed,seed")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[], help="traffic.key=json or init.key=json")
    ap.add_argument("--diagnose", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO)]
    import cardbench.run as R

    R.prepare_environment()
    from cardbench import bench

    cell = bench.find_cell(args.workload)
    override(cell, args.set)
    one = train_readings if cell.traffic["kind"] == "train" else decode_readings
    for seed in args.seeds:
        one(cell, seed, args, args.out)
    for spec in args.fault:
        name, _, which = spec.partition(":")
        for seed in seeds(which):
            one(cell, seed, args, args.out, fault=name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
