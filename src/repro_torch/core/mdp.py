"""The scheduling MDP (paper §3-4): deterministic transitions over decision
prefixes; only terminal (complete) schedules have a meaningful cost."""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.space import SchedulePlan, ScheduleSpace

State = Tuple[int, ...]


class ScheduleMDP:
    def __init__(self, space: ScheduleSpace, cost_model):
        self.space = space
        self.cost_model = cost_model

    @property
    def initial_state(self) -> State:
        return ()

    def n_actions(self, state: State) -> int:
        return self.space.n_actions(len(state))

    def step(self, state: State, action: int) -> State:
        assert 0 <= action < self.n_actions(state)
        return state + (action,)

    def is_terminal(self, state: State) -> bool:
        return len(state) == self.space.n_stages

    def plan(self, state: State) -> SchedulePlan:
        assert self.is_terminal(state)
        return self.space.plan_from_actions(state)

    def terminal_cost(self, state: State) -> float:
        """Cost of a COMPLETE schedule — the only reliable signal."""
        return self.cost_model.cost(self.plan(state))

    def partial_cost(self, state: State) -> float:
        """Cost of an incomplete schedule via default-completion — the
        unreliable intermediate signal beam/greedy search depends on."""
        if self.is_terminal(state):
            return self.terminal_cost(state)
        return self.cost_model.partial_cost(state, self.space)

    def completed_plans(self, states: Sequence[State]) -> list:
        """Default-complete each prefix into a full ``SchedulePlan`` — the
        features every partial-schedule consumer scores (the analytic
        batch path here and the learned-cost server in
        ``engine/serving.py``); defaults resolved once per batch."""
        defaults = self.space.default_actions()
        return [
            self.space.plan_from_actions(list(s) + defaults[len(s):])
            for s in states
        ]

    # -- batched pricing (values identical to the scalar methods) ----------
    def terminal_cost_batch(self, states: Sequence[State]) -> list:
        """``[terminal_cost(s) for s in states]`` in one cost-model call.
        Routes through ``cost_model.cost_batch`` when available — the
        batch materializes its plans once and (columnar models) encodes
        them once as ``PlanColumns`` for the vectorized roofline kernel;
        duplicate states are priced once.  Falls back to the scalar
        loop for cost models without a batch seam."""
        batch = getattr(self.cost_model, "cost_batch", None)
        if batch is None:
            return [self.terminal_cost(s) for s in states]
        return batch([self.plan(s) for s in states])

    def partial_cost_batch(self, states: Sequence[State]) -> list:
        """``[partial_cost(s) for s in states]`` in one cost-model call
        (terminal states price as terminal, like the scalar method); the
        default completions resolve against the space's memoized default
        actions and the completed batch takes the same one-encode columnar
        path as ``terminal_cost_batch``."""
        batch = getattr(self.cost_model, "cost_batch", None)
        if batch is None:
            return [self.partial_cost(s) for s in states]
        return batch(self.completed_plans(states))
