"""Tuner-as-a-service: persistent daemon + content-addressed plan store
(the port of the JAX package's ``service``; its keys also carry the
hardware a plan was tuned for).

``PlanStore`` (store.py) is the on-disk tier — tuned plans and per-cell
transposition-cache snapshots, atomic-published and quarantine-validated.
``TunerService``/``serve_forever`` (daemon.py) is the long-lived loop
sharing one pinned worker pool and one measurement fleet across runs.
CLI: ``python -m repro_torch.launch.tune_serve``.
"""
from repro_torch.service.daemon import TunerService, serve_forever
from repro_torch.service.store import (
    PlanStore,
    canonical_request,
    cell_key,
    request_key,
)

__all__ = [
    "PlanStore",
    "TunerService",
    "canonical_request",
    "cell_key",
    "request_key",
    "serve_forever",
]
