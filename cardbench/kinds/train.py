"""Training traffic: closed-loop steps of the program's train step, back to back.

The traffic file gives ``rows`` x ``seq_len`` tokens a step, drawn uniform
over the vocabulary from the seed (a pool of ``pool_rows`` distinct rows,
taken in turn), the labels the inputs themselves (the program's loss
predicts ``labels[:, 1:]`` from ``logits[:, :-1]``), the optimizer's
settings, and ``warmup_steps``.

Set-up builds one train step (``make_train_step``) with the plan and its
optimizer state, draws the weights, and drives the step through its first
``warmup_steps`` steps on the pool's first rows.  After step 1 it reads the
loss, the gradient norm of every leaf as the optimizer got it, from the
first moment (``|mu| / (1 - b1)``, int8 codes times their scales where the
moments are int8), the norm of every leaf's second moment ``nu``, and how
far every leaf moved from its drawn value.  The window then runs the same
step object on the next rows; a step whose loss is not finite has failed.

The reference (``reference/train.py``) follows step 1 from the same
weights and row in float32, and the numbers compared are each leaf's
gradient norm (``grad_gap``), second moment's norm (``nu_gap``) and change
(``change_gap``), as the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and of
the median leaf, worst leaf.  Leaves whose reference gradient norm is
under a thousandth of the median leaf's are left out of all three.  At
step 1 Adam's bias-corrected update is about ``lr * sign(g)``: the second
moment cancels out of the change, so ``nu_gap`` is what holds the second
moment's rule (its ``1 - b2``, its store).  Step 1 alone: over three steps
the bf16 weights' rounding after each update moves the program's later
steps as far from the reference as a float8 reference moves.  Not the
loss: no control or fault reads far enough from the program's own gap.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from cardbench import bench, draw
from cardbench import work as W

PRECISION = "float32"  # the reference's; the control runs it at float8


def _span(name):
    return torch.profiler.record_function(name)


@torch.no_grad()
def _norm(t: torch.Tensor) -> float:
    """The float32 norm of a leaf, a leading index at a time."""
    parts = t.unbind(0) if t.ndim >= 3 else (t,)
    return math.sqrt(sum(float(torch.linalg.vector_norm(p.float())) ** 2 for p in parts))


@torch.no_grad()
def _moment_norm(mom) -> float:
    """The norm of a moment of the program's optimizer state (an f32 tensor,
    or int8 codes ``q`` and scales ``s``)."""
    if isinstance(mom, dict):
        q, s = mom["q"], mom["s"]
        if q.ndim < 3:
            return float(torch.linalg.vector_norm(q.float() * s))
        return math.sqrt(sum(float(torch.linalg.vector_norm(a.float() * b)) ** 2
                             for a, b in zip(q.unbind(0), s.unbind(0))))
    return _norm(mom)


@torch.no_grad()
def _change_norms(params_flat: dict, meta, run) -> dict:
    """Each leaf's ``|p - p0|``, ``p0`` drawn again from the seed a leaf at a time."""
    out = {}
    for path, p in params_flat.items():
        p0 = draw.weights(meta, run.cell.config["init"], run.cfg.n_layers, run.seed, p.device,
                          only={path})[path]
        if p.ndim >= 3:
            out[path] = math.sqrt(sum(float(torch.linalg.vector_norm(a.float() - b.float())) ** 2
                                      for a, b in zip(p.unbind(0), p0.unbind(0))))
        else:
            out[path] = float(torch.linalg.vector_norm(p.float() - p0.float()))
        del p0
    return out


class State:
    pass


def batch_rows(run, device):
    tr, cfg = run.cell.traffic, run.cfg
    return draw.token_rows(tr["pool_rows"], tr["seq_len"], cfg.vocab_size, run.seed, device)


def setup(run) -> State:
    from repro_torch.configs.base import InputShape
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as optim
    from repro_torch.training.train_step import make_positions, make_train_step

    tr, cfg, dev = run.cell.traffic, run.cfg, run.device
    st = State()
    st.oc = optim.OptimizerConfig(moment_dtype=run.plan.opt_dtype, **tr["optimizer"])
    st.meta = transformer.meta_params(cfg)
    with _span("weights"):
        st.params = draw.weights(st.meta, run.cell.config["init"], cfg.n_layers, run.seed, dev)
        st.opt_state = optim.init_opt_state(st.params, st.oc)
        st.rows = batch_rows(run, dev)
    st.step = make_train_step(cfg, InputShape(run.cell.name, tr["seq_len"], tr["rows"], "train"),
                              run.plan, st.oc, device=dev)
    positions = make_positions(cfg, tr["rows"], tr["seq_len"], dev)
    n_batches = tr["pool_rows"] // tr["rows"]

    def batch(i):
        r = st.rows[(i % n_batches) * tr["rows"]:(i % n_batches + 1) * tr["rows"]]
        return {"inputs": r, "labels": r, "positions": positions}

    st.batch = batch
    with _span("warmup"):
        for i in range(tr["warmup_steps"]):
            st.params, st.opt_state, m = st.step(st.params, st.opt_state, batch(i))
            if i == 0:
                st.loss = float(m["loss"])
                st.grad_norms = {path: _moment_norm(mu) / (1 - st.oc.b1)
                                 for path, mu in optim.leaves(st.opt_state["mu"])}
                st.nu_norms = {path: _moment_norm(nu) for path, nu in optim.leaves(st.opt_state["nu"])}
                st.changes = _change_norms(dict(optim.leaves(st.params)), st.meta, run)
    st.next = tr["warmup_steps"]
    return st


def window(st: State, run) -> None:
    from repro_torch.kernels import ops

    tokens = run.cell.traffic["rows"] * run.cell.traffic["seq_len"]
    losses = []
    ops.reset_counters()
    bench.sync(run.device)
    run.window_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with _span("step"):
            st.params, st.opt_state, m = st.step(st.params, st.opt_state, st.batch(st.next))
            losses.append(m["loss"])
            bench.sync(run.device)
        t1 = time.perf_counter()
        run.step_starts.append(t0)
        run.step_ends.append(t1)
        run.step_tokens.append(tokens)
        st.next += 1
        if t1 - run.window_start >= run.seconds:
            break
    run.launches = ops.launch_counts()
    run.attempted = len(losses)
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    run.work = {"step_flops": W.train_flops(run.cell.config["sizes"], tokens)}


def finish(st: State, run) -> None:
    """Free the program's weights, state and step."""
    for name in ("params", "opt_state", "step", "batch", "rows"):
        setattr(st, name, None)
    gc.collect()
    torch.cuda.empty_cache()


def reference_numbers(run, meta, precision: str) -> dict:
    """The reference's loss, gradient and second-moment norms and changes of
    step 1, from the seed's weights and first row, at ``precision``."""
    from cardbench.reference import model as M
    from cardbench.reference import ops as R
    from cardbench.reference import train as T

    R.strict_float32()
    tr, dev = run.cell.traffic, run.device
    m = M.Model.from_file(run.cell.config)
    params = draw.weights(meta, run.cell.config["init"], m.n_layers, run.seed, dev)
    oc = T.AdamW(moment_dtype=run.plan.opt_dtype, **tr["optimizer"])
    state = T.moment_zeros(params, oc)
    r = batch_rows(run, dev)[:tr["rows"]]
    loss, grads = T.loss_and_grads(params, m, r, r, precision)
    T.adamw_step(params, grads, state, oc, 1)
    del grads
    norms = {name: {path: _moment_norm({"q": mom[0], "s": mom[1]} if isinstance(mom, tuple) else mom)
                    for path, mom in state[name].items()} for name in ("mu", "nu")}
    del state
    return {"loss": float(loss), "grad_norms": {k: v / (1 - oc.b1) for k, v in norms["mu"].items()},
            "nu_norms": norms["nu"], "changes": _change_norms(dict(T.leaves(params)), meta, run)}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` compares (see the module's docstring)."""
    return {"grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"], ref)[0],
            "nu_gap": worst_leaf(prog["nu_norms"], ref["nu_norms"], ref)[0],
            "change_gap": worst_leaf(prog["changes"], ref["changes"], ref)[0]}


def worst_leaf(mine: dict, theirs: dict, ref: dict):
    """``(gap, leaf)`` of the leaf whose norm lies farthest from the
    reference's, over the larger of its own and the median leaf's norm;
    leaves whose reference gradient is nought to rounding left out."""
    med_g = statistics.median(ref["grad_norms"].values())
    kept = [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * med_g]
    med = statistics.median(theirs[k] for k in kept)
    return max((abs(mine[k] - theirs[k]) / max(theirs[k], med), k) for k in kept)


def program_numbers(st: State) -> dict:
    return {"loss": st.loss, "grad_norms": st.grad_norms, "nu_norms": st.nu_norms,
            "changes": st.changes}


def check(st: State, run) -> None:
    for name, value in compare(program_numbers(st), reference_numbers(run, st.meta, PRECISION)).items():
        run.check(name, value)
