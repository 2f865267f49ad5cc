"""Persistent content-addressed plan store: the tuner's on-disk tier (the
port of the JAX package's ``service/store.py``).

Two tiers, both under one root directory, both JSON, both published with
the measurement-cache discipline (``core/measure.py``): tmp-sibling +
``os.replace`` atomic writes, validate-and-quarantine on read.

``plans/<request-key>.json`` — complete tuned results.  The key hashes
every *value-affecting* request setting (arch, shape, mesh, algo, seed,
budget, ensemble size, noise, cost mode, pricing tag, and the hardware
``hw`` the cell is priced for) and deliberately EXCLUDES execution knobs
(``engine``, ``parallel``, ``n_workers``) — the engines give identical
results, so a plan tuned by any of them answers the same request.  ``hw``
is omitted from the key when it is ``"tpu-v5e"``, so the port's keys for
a TPU request equal the JAX package's letter for letter; a request that
names no ``hw`` is an ``"h100"`` request, the port's default.  A hit reproduces the full
``TuneResult`` (plan, exact cost, decision trace) with ``from_store=True``
and zero search evals.

``cells/<cell-key>.json`` — per-cell ``TranspositionCache`` snapshots.
The cell key hashes only what cache *values* depend on (arch, shape,
mesh, noise, pricing tag, hardware), so every algo/seed/budget tuning the
same cell shares one warm-start file.  Sync reuses the pinned-worker delta protocol
(``TranspositionCache.watermark``/``export_since``/``apply_export``):
each sync exports the in-memory cache's new entries since the last sync,
merges them into the on-disk state under the exact-wins rule, and
publishes atomically.  Writers are lock-free — concurrent daemons race on
the ``os.replace`` and the loser's delta simply lands on its next sync
(its in-memory cache still holds everything); exact-wins makes the merge
order-independent for exact entries, so the store converges.

Two further tiers back the daemon's crash safety:
``journal/<request-key>.json`` — the write-ahead request log (journaled
before search, released after the result lands; pending entries are what
``TunerService.recover`` replays after a crash) — and
``checkpoints/<request-key>.pkl`` — pickled round-boundary
``ProTuner.snapshot()`` states, published with the same tmp-sibling +
``os.replace`` discipline and quarantined on unreadable load.

Warm starts load only EXACT (untagged) entries by default: a memo of
exact analytic costs changes hit counts but never values, so a warmed
search's plan/cost/decisions stay bit-identical to a cold one.  Learned-
tagged entries (model predictions) are persisted — exact-wins applies
across restarts too — but are only loaded into runs that themselves serve
a learned model (``include_learned=True``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import uuid
from typing import List, Optional

from repro_torch.core.engine.cache import TranspositionCache, Watermark
from repro_torch.core.ensemble import TuneResult
from repro_torch.core.hardware import hardware_key
from repro_torch.core.space import SchedulePlan

STORE_VERSION = 1

# the TuneResult fields a stored plan must round-trip (everything else
# defaults on decode)
_REQUIRED_RESULT = ("plan", "cost", "decisions")

# the JAX package's only hardware: omitted from keys, as the JAX package's
# keys have no hardware field
_KEYLESS_HW = "tpu-v5e"


def request_hw(req: dict) -> str:
    """The hardware a canonical request (or a stored one) is for."""
    return req.get("hw", _KEYLESS_HW)


def canonical_request(
    arch: str,
    shape: str,
    *,
    mesh: str = "single",
    algo: str = "mcts_30s",
    seed: int = 0,
    time_budget_s: Optional[float] = None,
    n_standard: int = 15,
    n_greedy: int = 1,
    noise_sigma: float = 0.0,
    noise_seed: Optional[int] = None,
    cost: str = "analytic",
    pricing: Optional[str] = None,
    hw="h100",
    **_ignored,
) -> dict:
    """Normalize a tuning request to the value-affecting settings only.
    ``noise_seed`` defaults to ``seed`` — exactly ``autotune()``'s own
    ``make_mdp(..., noise_sigma, seed)`` default — and normalizes to 0
    when ``noise_sigma`` is 0 (no noise → the seed is value-inert, and
    every noise-free run of a cell should share one cell file).
    ``pricing`` normalizes to the versioned kernel tag: None/"scalar"/
    "columnar" are all the exact analytic value and collapse to "exact" —
    OMITTED from the dict so every pre-existing request key is unchanged
    — while "jit" records ``cost_model.JIT_PRICING_TAG`` (a tag bump on
    any kernel revision re-keys stored plans and cells, so ULP-level
    value drift never answers a stale request).  ``hw`` (a
    ``core.hardware`` name or spec) is recorded by name, except
    ``"tpu-v5e"``, which is omitted so that a TPU request keys as the JAX
    package's does.  Execution knobs (engine/parallel/n_workers, and the
    ``device`` a learned model runs on) are accepted and dropped."""
    req = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh,
        "algo": algo,
        "seed": seed,
        "time_budget_s": time_budget_s,
        "n_standard": n_standard,
        "n_greedy": n_greedy,
        "noise_sigma": noise_sigma,
        "noise_seed": (
            (seed if noise_seed is None else noise_seed) if noise_sigma else 0
        ),
        "cost": cost,
    }
    if pricing == "jit":
        from repro_torch.core.cost_model import JIT_PRICING_TAG

        req["pricing"] = JIT_PRICING_TAG
    elif pricing not in (None, "scalar", "columnar"):
        raise ValueError(f"unknown pricing {pricing!r}")
    hw_name = hardware_key(hw)
    if hw_name != _KEYLESS_HW:
        req["hw"] = hw_name
    return req


def request_key(req: dict) -> str:
    blob = json.dumps([STORE_VERSION, req], sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def cell_key(req: dict) -> str:
    """Cache-value identity: every request whose cache entries are
    interchangeable (same cost function) maps to one cell file.  A
    non-exact pricing tag (jit kernel, ULP-level drift from the exact
    path) and a hardware other than ``"tpu-v5e"`` are part of that
    identity — each appended only when present, so the exact-path TPU cell
    keys equal the JAX package's."""
    fields = [STORE_VERSION, req["arch"], req["shape"], req["mesh"],
              req["noise_sigma"], req["noise_seed"]]
    if req.get("pricing"):
        fields.append(req["pricing"])
    if req.get("hw"):
        fields.append({"hw": req["hw"]})
    blob = json.dumps(fields, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


# ---------------------------------------------------------------------------
# Atomic file discipline (the measurement-cache pattern)
# ---------------------------------------------------------------------------
def _write_json(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_json(path: str, validate) -> Optional[dict]:
    """Validated read: a corrupt, truncated, or schema-violating file is
    QUARANTINED (deleted) so the next request re-tunes, instead of being
    served forever or crashing every lookup."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        obj = None
    if isinstance(obj, dict) and obj.get("version") == STORE_VERSION:
        try:
            if validate(obj):
                return obj
        except (KeyError, TypeError, ValueError):
            pass
    try:
        os.remove(path)
    except OSError:
        pass
    return None


# ---------------------------------------------------------------------------
# Cache table codec (state tuples <-> JSON lists)
# ---------------------------------------------------------------------------
def _encode_tbl(tbl: dict) -> list:
    return [[list(k), v] for k, v in tbl.items()]


def _decode_tbl(rows: list) -> dict:
    out = {}
    for k, v in rows:
        out[tuple(int(a) for a in k)] = v
    return out


def _result_to_dict(res: TuneResult) -> dict:
    return res.to_dict()


def _result_from_dict(d: dict) -> TuneResult:
    d = dict(d)
    d["plan"] = SchedulePlan.from_dict(d["plan"])
    known = {f.name for f in dataclasses.fields(TuneResult)}
    res = TuneResult(**{k: v for k, v in d.items() if k in known})
    res.from_store = True
    return res


class PlanStore:
    """On-disk tier shared by every daemon (and any one-shot ``autotune``
    pointed at the same root)."""

    def __init__(self, root: str):
        self.root = root
        self.plans_dir = os.path.join(root, "plans")
        self.cells_dir = os.path.join(root, "cells")
        # crash-safety tiers (service/daemon.py): the write-ahead request
        # journal and the round-boundary search checkpoints
        self.journal_dir = os.path.join(root, "journal")
        self.checkpoints_dir = os.path.join(root, "checkpoints")
        os.makedirs(self.plans_dir, exist_ok=True)
        os.makedirs(self.cells_dir, exist_ok=True)
        os.makedirs(self.journal_dir, exist_ok=True)
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0

    # -- plan tier -----------------------------------------------------
    def _plan_path(self, req: dict) -> str:
        return os.path.join(self.plans_dir, request_key(req) + ".json")

    def lookup(self, req: dict) -> Optional[TuneResult]:
        obj = _load_json(
            self._plan_path(req),
            lambda o: all(k in o["result"] for k in _REQUIRED_RESULT),
        )
        if obj is None:
            self.misses += 1
            return None
        self.hits += 1
        res = _result_from_dict(obj["result"])
        if res.hw is None:  # recorded by the JAX package's store: a TPU plan
            res.hw = request_hw(obj.get("request") or req)
        return res

    def seed_plans(
        self,
        arch: Optional[str] = None,
        shape: Optional[str] = None,
        mesh: Optional[str] = None,
        limit: int = 16,
        hw=None,
    ):
        """Every stored plan matching the cell filters (``hw``: a hardware
        name or spec; a stored request without one is a TPU request),
        decoded — the
        evolutionary backend's warm-start population (any algo/seed/budget
        qualifies: a good plan for the cell is a good seed regardless of
        which searcher found it).  Files are scanned in sorted filename
        order through the validating loader, so the result is
        deterministic for a given store state and corrupt entries are
        quarantined rather than crashing the seeding pass."""
        out = []
        for fname in sorted(os.listdir(self.plans_dir)):
            if not fname.endswith(".json"):
                continue
            obj = _load_json(
                os.path.join(self.plans_dir, fname),
                lambda o: all(k in o["result"] for k in _REQUIRED_RESULT),
            )
            if obj is None:
                continue
            req = obj.get("request") or {}
            if arch is not None and req.get("arch") != arch:
                continue
            if shape is not None and req.get("shape") != shape:
                continue
            if mesh is not None and req.get("mesh") != mesh:
                continue
            if hw is not None and request_hw(req) != hardware_key(hw):
                continue
            try:
                out.append(SchedulePlan.from_dict(obj["result"]["plan"]))
            except (KeyError, TypeError, ValueError):
                continue
            if len(out) >= limit:
                break
        return out

    def record(self, req: dict, res: TuneResult) -> None:
        if res.plan is None:
            return  # an aborted run is not knowledge worth persisting
        if (res.stats or {}).get("interrupted"):
            # a deadline/cancel best-so-far is a PARTIAL answer — recording
            # it would serve it to every future request for this key; the
            # round-boundary checkpoint (not the plan tier) carries the
            # interrupted run's progress
            return
        _write_json(self._plan_path(req), {
            "version": STORE_VERSION,
            "request": req,
            "result": _result_to_dict(res),
        })

    # -- cell tier -----------------------------------------------------
    def _cell_path(self, ckey: str) -> str:
        return os.path.join(self.cells_dir, ckey + ".json")

    def _load_cell_tables(self, ckey: str):
        obj = _load_json(
            self._cell_path(ckey),
            lambda o: all(isinstance(o[k], list) for k in
                          ("terminal", "partial",
                           "terminal_version", "partial_version")),
        )
        if obj is None:
            return None
        return (
            _decode_tbl(obj["terminal"]),
            _decode_tbl(obj["partial"]),
            _decode_tbl(obj["terminal_version"]),
            _decode_tbl(obj["partial_version"]),
        )

    def warm_cell(self, ckey: str, cache: TranspositionCache,
                  include_learned: bool = False) -> int:
        """Load the stored cell state into ``cache``; returns the number
        of entries applied.  Exact-only by default (see module doc)."""
        tables = self._load_cell_tables(ckey)
        if tables is None:
            return 0
        t, p, tv, pv = tables
        if not include_learned:
            t = {k: v for k, v in t.items() if k not in tv}
            p = {k: v for k, v in p.items() if k not in pv}
            tv, pv = {}, {}
        cache.apply_export((t, p, tv, pv))
        return len(t) + len(p)

    def sync_cell(self, ckey: str, cache: TranspositionCache,
                  wm: Optional[Watermark]) -> Watermark:
        """Merge ``cache``'s entries since ``wm`` into the stored cell
        state and publish atomically; returns the new watermark.  Merge-
        on-write: the CURRENT disk state is re-read and the delta folded
        into it under exact-wins, so two daemons writing the same cell
        converge (the ``os.replace`` race loser's delta rides its next
        sync)."""
        new_wm = cache.watermark()
        entries, _full = cache.export_since(wm)
        scratch = TranspositionCache()
        tables = self._load_cell_tables(ckey)
        if tables is not None:
            t, p, tv, pv = tables
            scratch.apply_export((t, p, tv, pv))
        scratch.apply_export(entries)
        _write_json(self._cell_path(ckey), {
            "version": STORE_VERSION,
            "terminal": _encode_tbl(scratch.terminal),
            "partial": _encode_tbl(scratch.partial),
            "terminal_version": _encode_tbl(scratch.terminal_version),
            "partial_version": _encode_tbl(scratch.partial_version),
        })
        return new_wm

    # -- journal tier (write-ahead request log) ------------------------
    # A request is journaled BEFORE its search starts and released only
    # after its result landed in the plan tier (or was answered on an
    # error/interrupt path).  A daemon that died mid-search therefore
    # leaves a pending entry behind; ``TunerService.recover`` replays
    # those on restart, resuming from the checkpoint tier.
    def _journal_path(self, req: dict) -> str:
        return os.path.join(self.journal_dir, request_key(req) + ".json")

    def journal_begin(self, req: dict) -> None:
        _write_json(self._journal_path(req), {
            "version": STORE_VERSION,
            "request": req,
            "state": "pending",
        })

    def journal_release(self, req: dict) -> None:
        try:
            os.remove(self._journal_path(req))
        except OSError:
            pass

    def pending_requests(self) -> List[dict]:
        """Validated scan of the journal, sorted by filename (so replay
        order is deterministic); corrupt entries quarantine like every
        other tier."""
        out = []
        for fname in sorted(os.listdir(self.journal_dir)):
            if not fname.endswith(".json"):
                continue
            obj = _load_json(
                os.path.join(self.journal_dir, fname),
                lambda o: isinstance(o["request"], dict)
                and o["state"] == "pending",
            )
            if obj is not None:
                out.append(obj["request"])
        return out

    def sweep_tmp(self) -> int:
        """Remove tmp-sibling debris left by writers that died mid-write
        (a SIGKILL between ``open(tmp)`` and ``os.replace`` orphans the
        tmp file forever — the atomic publish means the TIER is clean,
        but the directory isn't).  Tmp names embed the writer's pid, so
        a file whose writer is still alive (another daemon sharing this
        store, mid-publish right now) is left alone.  Called from the
        daemon's crash ``recover()``; returns the number removed."""
        n = 0
        for d in (self.plans_dir, self.cells_dir, self.journal_dir,
                  self.checkpoints_dir):
            for fname in os.listdir(d):
                parts = fname.rsplit(".tmp.", 1)
                if len(parts) != 2:
                    continue
                pid = parts[1].split(".", 1)[0]
                try:
                    os.kill(int(pid), 0)
                    continue  # writer still alive: in-flight publish
                except ValueError:
                    pass  # malformed pid: debris
                except ProcessLookupError:
                    pass  # writer is gone: debris
                except PermissionError:
                    continue  # pid exists under another uid: leave it
                try:
                    os.remove(os.path.join(d, fname))
                    n += 1
                except OSError:
                    pass
        return n

    # -- checkpoint tier (round-boundary search snapshots) -------------
    # Pickle, not JSON: a ``ProTuner.snapshot()`` carries live tree
    # objects (numpy stat arrays, ``random.Random`` state).  Same publish
    # discipline as every tier: tmp-sibling + ``os.replace``, so a
    # SIGKILL mid-write can never publish a torn file; unpicklable or
    # schema-violating checkpoints are quarantined on read and the run
    # simply starts fresh.
    def _checkpoint_path(self, req: dict) -> str:
        return os.path.join(self.checkpoints_dir, request_key(req) + ".pkl")

    def save_checkpoint(self, req: dict, snap: dict) -> None:
        path = self._checkpoint_path(req)
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump({
                    "version": STORE_VERSION,
                    "request": req,
                    "snapshot": snap,
                }, f)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load_checkpoint(self, req: dict) -> Optional[dict]:
        path = self._checkpoint_path(req)
        try:
            with open(path, "rb") as f:
                obj = pickle.load(f)
        except FileNotFoundError:
            return None
        except Exception:  # noqa: BLE001 - any unpickling failure quarantines
            obj = None
        if (isinstance(obj, dict) and obj.get("version") == STORE_VERSION
                and isinstance(obj.get("snapshot"), dict)):
            return obj["snapshot"]
        try:
            os.remove(path)
        except OSError:
            pass
        return None

    def clear_checkpoint(self, req: dict) -> None:
        try:
            os.remove(self._checkpoint_path(req))
        except OSError:
            pass

    # -- stats ---------------------------------------------------------
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "stored_plans": len(os.listdir(self.plans_dir)),
            "stored_cells": len(os.listdir(self.cells_dir)),
            "pending_journal": len(os.listdir(self.journal_dir)),
            "stored_checkpoints": len(os.listdir(self.checkpoints_dir)),
        }
