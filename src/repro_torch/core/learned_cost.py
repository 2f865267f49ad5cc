"""Learned cost model (paper §3): a small MLP trained on COMPLETE
schedules, in PyTorch — the port of the JAX package's
``core/learned_cost.py``.

Two roles:

* **Reproduction** (Fig. 1/2): a model trained on complete schedules ranks
  complete schedules well but mis-ranks partial ones (their
  default-completion features are off-distribution), which is what poisons
  beam search at every depth.
* **Serving** (engine layer): the same MLP is refit online on
  transposition-cache contents and prices cache-miss batches in one
  batched forward pass — see ``repro_torch.core.engine.serving``.

The features are numpy and the JAX package's, element for element.  The
MLP (``MLP``: ``d_in -> 64 -> 64 -> 1``, ReLU, He-normal weights, zero
biases) runs on the model's ``device``; a ``LearnedCostModel`` keeps its
parameters as numpy arrays under the JAX dict's key names
(``repro_torch.convert.mlp_params_to_numpy``), so a model pickles to a
worker process as numpy and builds its module there, on the device it
names, at its first forward.  Matrix products run in true f32 (TF32 off)
on the card, so card and CPU predictions agree to f32 round-off.  Eager
torch compiles nothing per batch shape, so batches are not padded.
"""
from __future__ import annotations

import contextlib
import random as _random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.convert import mlp_params_from_numpy, mlp_params_to_numpy
from repro_torch.core.cost_model import AnalyticCostModel, PlanColumns
from repro_torch.core.space import SchedulePlan, ScheduleSpace
from repro_torch.device import open_context, resolve_device


def featurize(plan: SchedulePlan, space: ScheduleSpace) -> np.ndarray:
    """One-hot per stage + numeric knobs (log-scaled).

    Width = sum(len(stage.options) for the cell's stages) + 4 log-scaled
    knobs + the overlap scalar; exactly one 1.0 inside each stage's one-hot
    block."""
    feats: List[float] = []
    for stage in space.stages:
        val = getattr(plan, stage.name)
        for opt in stage.options:
            feats.append(1.0 if opt == val else 0.0)
    feats.append(np.log2(plan.microbatches))
    feats.append(np.log2(plan.attn_block[0]))
    feats.append(np.log2(plan.attn_block[1]))
    feats.append(np.log2(plan.scan_chunk))
    feats.append(plan.overlap)
    return np.asarray(feats, np.float32)


def featurize_batch(
    plans: Sequence[SchedulePlan], space: ScheduleSpace
) -> np.ndarray:
    """``stack([featurize(p) for p in plans])`` as one (N, d) f32 matrix."""
    return np.stack([featurize(p, space) for p in plans])


def featurize_columns(cols: PlanColumns, space: ScheduleSpace) -> np.ndarray:
    """``featurize_batch`` from a ``PlanColumns`` encoding — element-for-
    element equal to featurizing the plan objects, built from the same
    structure-of-arrays the analytic columnar kernel prices, so the serving
    layer encodes a miss batch ONCE whichever backend prices it."""
    blocks: List[np.ndarray] = []
    for stage in space.stages:
        for onehot in cols.stage_onehots(stage):
            blocks.append(onehot.astype(np.float32))
    blocks.append(np.log2(cols.microbatches).astype(np.float32))
    blocks.append(np.log2(cols.bq).astype(np.float32))
    blocks.append(np.log2(cols.bkv).astype(np.float32))
    blocks.append(np.log2(cols.scan_chunk).astype(np.float32))
    blocks.append(cols.overlap.astype(np.float32))
    return np.stack(blocks, axis=1)


class MLP(nn.Module):
    """The §3 cost MLP: ``relu(relu(x W1 + b1) W2 + b2) W3 + b3``."""

    def __init__(self, d_in: int, hidden: int = 64, device=None):
        super().__init__()
        # skip_init: the weights are always loaded from a parameter dict
        self.l1 = nn.utils.skip_init(nn.Linear, d_in, hidden, device=device)
        self.l2 = nn.utils.skip_init(nn.Linear, hidden, hidden, device=device)
        self.l3 = nn.utils.skip_init(nn.Linear, hidden, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.l1(x))
        h = torch.relu(self.l2(h))
        return self.l3(h)


@contextlib.contextmanager
def _true_f32():
    """Matrix products in IEEE f32 on the card (no TF32), restoring the
    caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@dataclass
class LearnedCostModel:
    params: dict  # numpy, the JAX package's keys (w1, b1, w2, b2, w3, b3)
    space: ScheduleSpace
    mean: float
    std: float
    n_evals: int = 0
    version: int = 1  # fit generation (bumped by the online trainer)
    n_forward: int = 0  # MLP forward passes; a whole batch counts ONCE
    device: str = "cuda"  # where the MLP prices
    priced_on: Optional[str] = None  # the device of the last forward pass
    _net: Optional[MLP] = field(default=None, repr=False, compare=False)

    def __getstate__(self):
        # the module is rebuilt from ``params`` on the receiving side, on
        # the device this model names: what crosses a process is numpy
        d = self.__dict__.copy()
        d["_net"] = None
        return d

    def net(self) -> MLP:
        if self._net is None:
            dev = resolve_device(self.device)
            open_context(dev)
            self._net = mlp_params_from_numpy(self.params, dev)
        return self._net

    def cost(self, plan: SchedulePlan) -> float:
        return self.cost_batch([plan])[0]

    def cost_batch(self, plans: Sequence[SchedulePlan]) -> List[float]:
        """Price the whole batch in ONE forward pass.

        Contract: ``cost_batch(plans) ≈ [cost(p) for p in plans]`` to
        float32 round-off (a product may sum in another order at another
        batch size, so this seam, unlike the analytic ``cost_batch``, is an
        approximate-parity contract, not a bit-exact one)."""
        if len(plans) == 0:
            return []
        return self._predict(featurize_batch(plans, self.space))

    def cost_columns(self, cols: PlanColumns) -> List[float]:
        """``cost_batch`` from a shared ``PlanColumns`` encoding (the
        serving seam: one encode per miss batch, whichever backend prices
        it); the feature matrix is element-identical."""
        if cols.n == 0:
            return []
        return self._predict(featurize_columns(cols, self.space))

    def _predict(self, X: np.ndarray) -> List[float]:
        """One forward pass over a feature matrix on the model's device."""
        net = self.net()
        dev = net.l1.weight.device
        with torch.no_grad(), _true_f32():
            y = net(torch.from_numpy(X).to(dev))[:, 0].cpu().numpy()
        self.n_evals += X.shape[0]
        self.n_forward += 1
        self.priced_on = str(dev)
        out = np.exp(y.astype(np.float64) * self.std + self.mean)
        return [float(v) for v in out]

    def partial_cost(self, actions, space) -> float:
        defaults = space.default_actions()
        full = list(actions) + defaults[len(actions):]
        return self.cost(space.plan_from_actions(full))


def _mlp_init(d_in: int, hidden: int = 64, seed: int = 0) -> dict:
    """He-normal weights (``N(0, 2 / fan_in)``) and zero biases, drawn on the
    CPU from ``torch.Generator(seed)`` so that the card and the CPU start
    from the same numbers; as numpy under the JAX package's keys."""
    gen = torch.Generator().manual_seed(seed)

    def s(a, b):
        return (torch.randn(a, b, generator=gen) * (2.0 / a) ** 0.5).numpy()

    return {
        "w1": s(d_in, hidden), "b1": np.zeros(hidden, np.float32),
        "w2": s(hidden, hidden), "b2": np.zeros(hidden, np.float32),
        "w3": s(hidden, 1), "b3": np.zeros(1, np.float32),
    }


def _fit_params(net: MLP, X: torch.Tensor, Y: torch.Tensor, steps: int,
                lr: float) -> None:
    """``steps`` of full-batch mean-squared-error gradient descent, in
    place: ``p <- p - lr * grad`` (no optimizer object)."""
    params = list(net.parameters())
    n = X.shape[0]
    with _true_f32():
        for _ in range(steps):
            loss = ((net(X) - Y) ** 2)[:, 0].sum() / n
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.copy_(p - lr * g)


def fit_learned_cost(
    space: ScheduleSpace,
    plans: Sequence[SchedulePlan],
    costs: Sequence[float],
    *,
    params: Optional[dict] = None,
    steps: int = 200,
    lr: float = 3e-3,
    seed: int = 0,
    device="cuda",
) -> LearnedCostModel:
    """Fit (or warm-start refit, via numpy ``params``) the MLP on explicit
    ``(plan, cost)`` pairs, on ``device``.  Normalization (log-cost
    mean/std) is recomputed from THIS dataset — the per-fit
    renormalization the online trainer requires as the cache's cost
    distribution shifts during search."""
    dev = resolve_device(device)
    open_context(dev)
    X = featurize_batch(plans, space)
    logy = np.log(np.maximum(np.asarray(costs, np.float32), 1e-9))
    mean, std = float(logy.mean()), float(logy.std() + 1e-6)
    Y = ((logy - mean) / std).astype(np.float32)
    if params is None:
        params = _mlp_init(X.shape[1], seed=seed)
    net = mlp_params_from_numpy(params, dev)
    _fit_params(net, torch.from_numpy(X).to(dev), torch.from_numpy(Y[:, None]).to(dev),
                steps, lr)
    model = LearnedCostModel(params=mlp_params_to_numpy(net), space=space, mean=mean,
                             std=std, device=str(dev))
    model._net = net
    return model


def train_learned_cost(
    space: ScheduleSpace,
    oracle: AnalyticCostModel,
    *,
    n_samples: int = 512,
    steps: int = 400,
    lr: float = 3e-3,
    seed: int = 0,
    device="cuda",
) -> LearnedCostModel:
    """Train on random complete schedules against the oracle's cost
    (the paper trains against measured runtimes of random programs).
    Labels price through ``cost_batch`` — one columnar-kernel pass."""
    rng = _random.Random(seed)
    plans = [space.random_plan(rng) for _ in range(n_samples)]
    y = oracle.cost_batch(plans)
    return fit_learned_cost(space, plans, y, steps=steps, lr=lr, seed=seed, device=device)


def ranking_correlation(
    model, oracle: AnalyticCostModel, space: ScheduleSpace, *,
    n: int = 128, seed: int = 1, partial_depth: Optional[int] = None,
) -> float:
    """Spearman rank correlation model-vs-oracle on complete schedules, or on
    partial prefixes (default-completed) when ``partial_depth`` is given.
    Both legs price through the batch seam (``cost_batch``); models
    without a batch entry point fall back to a scalar sweep."""
    rng = _random.Random(seed)
    pred_plans, gold_plans = [], []
    for _ in range(n):
        actions = space.random_actions(rng)
        if partial_depth is not None:
            prefix = actions[:partial_depth]
            defaults = space.default_actions()
            full_actions = prefix + defaults[len(prefix):]
            # the model scores its (misleading) default completion; the
            # oracle scores the TRUE eventual schedule (the random one)
            pred_plans.append(space.plan_from_actions(full_actions))
            gold_plans.append(space.plan_from_actions(actions))
        else:
            plan = space.plan_from_actions(actions)
            pred_plans.append(plan)
            gold_plans.append(plan)

    def price(m, plans):
        batch = getattr(m, "cost_batch", None)
        if batch is not None:
            return batch(plans)
        return [m.cost(p) for p in plans]

    preds = price(model, pred_plans)
    golds = price(oracle, gold_plans)
    return _spearman(np.asarray(preds), np.asarray(golds))


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0
