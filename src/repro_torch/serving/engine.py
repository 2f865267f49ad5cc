"""Serving engine: batched decode with continuous-batching slots.

The counterpart of the JAX package's ``serving/engine.py``, with its
semantics kept: a fixed batch of decode slots, each at its own position
(per-slot ``cur``); a prompt fed one token at a time through the decode
step with only its own slot committed; a slot's cache zeroed when a new
request takes it; greedy ``argmax`` (the first index on ties).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.space import SchedulePlan
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.training.train_step import make_serve_step


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch_slots: int = 4,
        max_len: int = 128,
        plan: Optional[SchedulePlan] = None,
        device="cuda",
    ):
        if cfg.input_kind != "tokens":
            raise ValueError("the engine drives token-input archs")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.plan = plan or SchedulePlan()
        self.cache = transformer.init_cache(cfg, batch_slots, max_len, device=self.device)
        self.tokens = np.zeros((batch_slots,), np.int32)
        self.lengths = np.zeros((batch_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._uid = 0
        self._step_fn = make_serve_step(cfg, None, self.plan, device=self.device)

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens))
        return self._uid

    def run(self, max_steps: int = 1000) -> List[Request]:
        """Drive until queue + slots drain (or max_steps).

        Returns THIS call's completions only; requests still in flight when
        ``max_steps`` runs out stay active and finish on the next ``run``
        (``pending()`` counts them)."""
        n0 = len(self.finished)
        for _ in range(max_steps):
            self._fill_slots()
            if all(r is None for r in self.active):
                break
            self._step()
        return self.finished[n0:]

    def pending(self) -> dict:
        """Requests not yet completed: in-slot actives and queued waiters."""
        return {
            "active": sum(r is not None for r in self.active),
            "queued": len(self.queue),
        }

    # -- internals -----------------------------------------------------------------
    @torch.no_grad()
    def _decode(self, mask: np.ndarray) -> torch.Tensor:
        """One decode step of every slot at its own length; commit only the
        slots in ``mask``.  The JAX engine computes a whole new cache and
        keeps old or new state per slot with ``where``; here the step writes
        the new K/V, conv window and SSM state of the slots in ``mask`` into
        the engine's cache in place (one masked write per cache leaf), so no
        second cache exists.  The tokens
        of slots outside ``mask`` are not used."""
        dev = self.device
        tokens = torch.from_numpy(self.tokens).to(dev, torch.long)
        cur = torch.from_numpy(self.lengths).to(dev, torch.long)
        keep = torch.from_numpy(mask).to(dev)
        logits, _ = self._step_fn(self.params, self.cache, tokens[:, None], cur, commit=keep)
        return torch.argmax(logits, dim=-1)

    def _reset_slot(self, slot: int) -> None:
        # zero one slot's cache on (re)assignment: stale KV past the new
        # request's length is masked by position anyway, but the Mamba conv
        # window and SSM state are not position-addressed, and the zeroing is
        # what keeps a new request from inheriting its predecessor's state
        for leaves in self.cache.values():
            for c in leaves.values():
                c[:, slot].zero_()

    def _fill_slots(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                self._reset_slot(i)
                # sequential prompt feed through the decode step, as in JAX
                self.lengths[i] = 0
                for t in req.prompt[:-1]:
                    self.tokens[i] = t
                    self._single_feed(i)
                self.tokens[i] = req.prompt[-1]

    def _single_feed(self, slot: int):
        # prefill one token for ONE slot: per-slot positions plus a one-hot
        # commit mask, so other slots' KV is untouched
        mask = np.zeros((self.slots,), bool)
        mask[slot] = True
        self._decode(mask)
        self.lengths[slot] += 1

    def _step(self):
        # one decode step for every ACTIVE slot at its own position
        mask = np.array([r is not None for r in self.active], bool)
        next_np = self._decode(mask).cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.generated.append(int(next_np[i]))
            self.tokens[i] = next_np[i]
            self.lengths[i] += 1
            if (
                len(req.generated) >= req.max_new_tokens
                or self.lengths[i] >= self.max_len - 1
            ):
                req.done = True
                self.finished.append(req)
                self.active[i] = None
