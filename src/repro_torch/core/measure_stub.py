"""Card-free measurement target for tests and the fleet's checks.

The counterpart of the JAX package's ``core/measure_stub.py``.
``stub_measure`` has the exact signature the fleet dispatches to (request
dict -> record dict) but prices the plan with the port's analytic roofline
model (``AnalyticCostModel``, on the hardware ``req["hw"]`` names, default
``"h100"``, and its mesh from ``core.space.MESHES``) instead of running the
step: deterministic, torch-free, microseconds.  The record carries no
wall-clock fields, so a fleet run and a serial ``measure_cell`` run of the
same request produce byte-identical cache files.  Under ``hw="tpu-v5e"`` it
is the JAX package's stub record, field for field.

Fault injection rides in ``req["extras"]["inject"]`` (transport-only —
never part of the cache key)::

    {"marker": "/tmp/x.marker", "kind": "kill"}            # SIGKILL self
    {"marker": "/tmp/y.marker", "kind": "sleep", "sleep_s": 5}

The injection fires exactly once: the first attempt creates the marker
file and then dies (or stalls past the watchdog deadline); the retry
sees the marker and measures normally.
"""
from __future__ import annotations

import os
import signal
import time

from repro_torch.configs import get_config, get_shape
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.hardware import get_hardware
from repro_torch.core.space import SchedulePlan, get_mesh


def _fire_injection(extras) -> None:
    inject = (extras or {}).get("inject")
    if not inject:
        return
    marker = inject["marker"]
    if os.path.exists(marker):
        return  # already fired — this is the retry; measure normally
    with open(marker, "w") as f:
        f.write(inject["kind"])
    if inject["kind"] == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif inject["kind"] == "sleep":
        time.sleep(float(inject.get("sleep_s", 60.0)))


def failing_measure(req: dict) -> dict:
    """Target that always fails — exercises the retry-exhaustion path."""
    raise RuntimeError("deliberate failure")


def stub_measure(req: dict) -> dict:
    """Deterministic analytic 'measurement' of one request dict."""
    _fire_injection(req.get("extras"))
    cfg = get_config(req["arch"])
    shape = get_shape(req["shape"])
    hw = get_hardware(req.get("hw") or "h100")
    mspec = get_mesh(hw, req["mesh"])
    plan = (
        SchedulePlan.from_dict(req["plan"])
        if req.get("plan") is not None
        else SchedulePlan()
    )
    t = AnalyticCostModel(cfg, shape, mspec, hw).terms(plan)
    return {
        "arch": req["arch"],
        "shape": req["shape"],
        "mesh": req["mesh"],
        "devices": req.get("devices"),
        "plan": plan.to_dict(),
        "compute_s": t.compute_s,
        "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "step_s": t.step_s,
        "dominant": t.dominant,
        "mfu": t.mfu,
        "feasible": t.feasible,
        "source": "stub",
    }
