"""Round-boundary run control: deadlines, cancellation, checkpoints.

``RunController`` is the seam between a *search* (the ProTuner ensemble's
decision-round loop, or the evolutionary backend's generation loop) and
the *runtime* that owns it (the tuner daemon, a test harness, a signal
handler).  The engine consults the controller at round boundaries only —
between boundaries a search is a pure deterministic function of its
inputs, so:

* an **uninterrupted** run with a controller mounted is bit-identical to
  a run without one (the controller reads a clock and an event; it never
  touches search state), and
* every **checkpoint** is taken at a round boundary of a *fully
  completed* round, so a resumed run replays the exact tail of the
  uninterrupted one — plan/cost/decisions bit-identical (certified by
  ``tests/test_run_control.py`` and the SIGKILL daemon test).

Contract (what the engine calls, in order, once per decision round):

1. ``begin_round()`` — reset the per-round truncation flag.
2. mid-round (optional, inside ``engine/batch.py``'s iteration loop):
   ``abort_round()`` — True once ``cancel()`` was called; the engine may
   then cut the round short (fewer simulations).  Deadlines never
   truncate a round: a deadline interrupt always lands on a canonical
   boundary, so its final checkpoint is resumable.
3. ``round_done(snapshot_thunk)`` — count the round, apply the
   fault-injection delay, and take a cadence checkpoint every
   ``checkpoint_every`` rounds (the thunk builds the snapshot lazily, so
   rounds between checkpoints pay nothing).  Skipped by the engine when
   the round was truncated — a truncated round must never be
   checkpointed.
4. ``should_stop()`` — ``"cancelled"`` / ``"deadline"`` / ``None``.  On a
   stop the engine writes a final boundary checkpoint via
   ``checkpoint(thunk)`` (idempotent per round), attaches
   ``TuneResult.stats["interrupted"]`` provenance, and returns
   best-so-far.

``deadline_s`` is relative wall time measured on an injectable monotonic
``clock`` (tests pass a fake).  ``cancel()`` is thread-safe — the daemon's
socket threads call it against an in-flight search.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class RunController:
    """Deadline + cancel flag + checkpoint hook, consulted by the search
    engine at decision-round boundaries (see module doc for the exact
    call protocol)."""

    def __init__(
        self,
        *,
        deadline_s: Optional[float] = None,
        checkpoint_every: int = 0,
        checkpoint_fn: Optional[Callable[[dict], None]] = None,
        round_delay_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._clock = clock
        self.deadline = clock() + deadline_s if deadline_s else None
        self.checkpoint_every = checkpoint_every
        self.checkpoint_fn = checkpoint_fn
        # deterministic fault injection: sleep this long after every round
        # (tests/benchmarks stretch a search so deadlines and SIGKILLs land
        # mid-run at controllable points; production leaves it at 0)
        self.round_delay_s = round_delay_s
        self._cancel = threading.Event()
        self.n_rounds = 0
        self.n_checkpoints = 0
        self.round_truncated = False
        self._ckpt_round = -1  # last round a checkpoint was written for

    # -- cancellation (thread-safe) ------------------------------------
    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def abort_round(self) -> bool:
        """Mid-round poll (engine/batch.py): True once cancelled — the
        engine may cut the round's remaining iterations.  Deadlines are
        deliberately NOT checked here (see module doc)."""
        if self._cancel.is_set():
            self.round_truncated = True
            return True
        return False

    # -- round-boundary protocol ---------------------------------------
    def begin_round(self) -> None:
        self.round_truncated = False

    def should_stop(self) -> Optional[str]:
        if self._cancel.is_set():
            return "cancelled"
        if self.deadline is not None and self._clock() >= self.deadline:
            return "deadline"
        return None

    def round_done(self, snapshot_thunk: Optional[Callable[[], dict]] = None) -> None:
        self.n_rounds += 1
        if self.round_delay_s:
            time.sleep(self.round_delay_s)
        if (
            snapshot_thunk is not None
            and self.checkpoint_every
            and self.n_rounds % self.checkpoint_every == 0
        ):
            self.checkpoint(snapshot_thunk)

    def checkpoint(self, snapshot_thunk: Optional[Callable[[], dict]]) -> bool:
        """Persist a snapshot through ``checkpoint_fn``; idempotent per
        round (a final interrupt checkpoint on a cadence round writes
        once).  Returns whether a checkpoint exists for this round."""
        if self.checkpoint_fn is None or snapshot_thunk is None:
            return False
        if self._ckpt_round == self.n_rounds:
            return True
        self.checkpoint_fn(snapshot_thunk())
        self.n_checkpoints += 1
        self._ckpt_round = self.n_rounds
        return True
