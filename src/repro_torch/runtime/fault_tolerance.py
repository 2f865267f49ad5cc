"""Fault tolerance for 1000+-node fleets: heartbeats, elastic re-mesh,
straggler mitigation.

A copy of the JAX package's ``runtime/fault_tolerance.py`` (pure Python):
the port keeps its own so that nothing of the JAX package is imported.

All policies are host-side control-plane logic (pure Python, no device
state), so they are unit-testable in this container and identical on a real
fleet where the heartbeat source is the pod coordinator:

* ``HeartbeatMonitor`` — tracks per-host liveness with a deadline; a host
  that misses ``timeout`` is declared dead.
* ``rebalance`` — rendezvous-hashing assignment of data shards to the
  surviving hosts: minimal movement (only the dead host's shards move), and
  with the stateless pipeline index math every host can recompute any shard.
* ``StragglerPolicy`` — EWMA of per-host step times; hosts slower than
  ``threshold ×`` the fleet median get flagged; repeated offenders are
  evicted (treated as failed → re-mesh), which is the standard mitigation
  when synchronous collectives make one slow host gate the fleet.
* ``ElasticPlan`` — given survivors, picks the largest feasible mesh
  (data axis shrinks; model axis preserved) and the checkpoint step to
  restart from.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------
class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], timeout: float = 60.0, clock=time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str, at: Optional[float] = None):
        self.last_seen[host] = self.clock() if at is None else at

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return sorted(h for h, t in self.last_seen.items() if now - t > self.timeout)

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return sorted(h for h in self.last_seen if h not in dead)


# ---------------------------------------------------------------------------
# Rendezvous-hash shard assignment (minimal movement on failure)
# ---------------------------------------------------------------------------
def _score(host: str, shard: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(f"{host}:{shard}".encode(), digest_size=8).digest(), "big"
    )


def rebalance(hosts: Sequence[str], n_shards: int) -> Dict[int, str]:
    """shard -> host via rendezvous hashing."""
    if not hosts:
        raise ValueError("no surviving hosts")
    return {
        s: max(hosts, key=lambda h: _score(h, s)) for s in range(n_shards)
    }


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------
@dataclass
class StragglerPolicy:
    threshold: float = 1.5  # × median EWMA step time
    ewma: float = 0.9
    evict_after: int = 3  # consecutive flags
    _times: Dict[str, float] = field(default_factory=dict)
    _flags: Dict[str, int] = field(default_factory=dict)

    def observe(self, host: str, step_time: float):
        prev = self._times.get(host)
        self._times[host] = (
            step_time if prev is None else self.ewma * prev + (1 - self.ewma) * step_time
        )

    def median(self) -> float:
        ts = sorted(self._times.values())
        if not ts:
            return 0.0
        return ts[len(ts) // 2]

    def stragglers(self) -> List[str]:
        med = self.median()
        if med <= 0:
            return []
        out = []
        for h, t in self._times.items():
            if t > self.threshold * med:
                self._flags[h] = self._flags.get(h, 0) + 1
                out.append(h)
            else:
                self._flags[h] = 0
        return sorted(out)

    def evictions(self) -> List[str]:
        self.stragglers()
        return sorted(h for h, n in self._flags.items() if n >= self.evict_after)


# ---------------------------------------------------------------------------
# Elastic re-mesh plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ElasticPlan:
    hosts: Tuple[str, ...]
    data_parallel: int  # new data-axis size
    restart_step: int
    shard_map: Tuple[Tuple[int, str], ...]  # data shard -> host


def plan_restart(
    alive: Sequence[str],
    chips_per_host: int,
    model_parallel: int,
    latest_ckpt_step: int,
    global_batch: int,
) -> ElasticPlan:
    """Shrink the data axis to the largest size the survivors support.

    The model axis is preserved (weights shard layout unchanged → restore is
    a pure re-placement); the data axis must divide the global batch.
    """
    total_chips = len(alive) * chips_per_host
    if total_chips % model_parallel:
        raise ValueError(f"{total_chips} chips do not split into model axes of {model_parallel}")
    dp = total_chips // model_parallel
    while dp > 1 and global_batch % dp != 0:
        dp -= 1
    assignment = rebalance(list(alive), dp)
    return ElasticPlan(
        hosts=tuple(sorted(alive)),
        data_parallel=dp,
        restart_step=latest_ckpt_step,
        shard_map=tuple(sorted(assignment.items())),
    )
