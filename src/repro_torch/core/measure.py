"""Real measurement: run the plan's step on the card and time it.

The counterpart of the JAX package's ``core/measure.py``.  There, a
measurement compiles the step for a 512-device TPU mesh in a subprocess and
re-derives roofline terms from XLA's optimized HLO; the port has no HLO
(``parse_collective_bytes`` and ``core/hlo_analysis.py`` have no analogue:
torch never emits HLO).  Here a measurement builds the port's step for the
plan, runs it on one H100 at a stated cut and times it
(``repro_torch.launch.measure``), in a subprocess (``measure_request``) or in
a persistent fleet worker (``core/measure_fleet.py``).  It is the paper's
"real execution time measurement" (§4.2) that ``mcts_cost+real_*`` re-ranks
by: seconds against the analytic model's ~100 µs.

Kept as they are: ``combine_terms`` (with ``hw`` a parameter), the request
dict, the atomic publish and quarantine of cache records, the subprocess
client, ``measure_cell`` and ``make_measure_fn``.

The cache key (``request_key``) covers every input that can change a
record: the key version, arch, shape, mesh, device count, the hardware spec
``hw``, the device kind that measured (``"cuda"`` or ``"cpu"``; ``None``
for the analytic stub), so a CPU record is never served as a card record,
and the measurement cut.  For a real measurement on mesh ``card`` it keys
on the **program** (``program_of``): the plan fields the card's step reads
for the cell's kind, ``microbatches`` capped at the cut's rows.  On a 1x1
mesh the sharding fields change nothing, so plans that differ only there
share one measurement; the record keeps the first requester's ``plan`` and
adds the ``program`` it measured.  A request on mesh ``single`` or
``multi`` is the production-mesh dry run's (``launch/dryrun_impl.py``: the
full config counted on the meta device, ``source: "dryrun"``): its key
carries that source and leaves out the device and the cut, which it never
reads.  Any other request keys on the whole plan.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import uuid
from typing import Dict, Optional

from repro_torch.configs import get_shape
from repro_torch.core.hardware import HardwareSpec, get_hardware
from repro_torch.core.space import SchedulePlan

# v3: the key gains ``hw``, the device kind and the cut, and keys a card
# measurement on its program; the versioned subdirectory keeps the port's
# records apart from any earlier layout
CACHE_DIR = os.path.join(
    os.environ.get(
        "REPRO_MEASURE_CACHE",
        os.path.join(os.getcwd(), "experiments", "measure_cache"),
    ),
    "torch-v3",
)

# the subprocess module a measurement spawns; tests point this at
# ``repro_torch.launch.dryrun_stub`` (same CLI, analytic record, no card)
DRYRUN_MODULE = "repro_torch.launch.measure"

# meshes whose measurement is the production-mesh dry run (one rank's step
# counted on the meta device, ``launch/dryrun_impl.py``), not a card's time
DRYRUN_MESHES = ("single", "multi")

# rows of the card's cut of a cell, by kind: what chip_smoke.py trains
# (B = 2 x S), one prompt, and 16 decode rows over a full-length cache
CUT_ROWS = {"train": 2, "prefill": 1, "decode": 16}

# the plan fields the port's step reads on one card, by the cell's kind
# (training/train_step.py: the tiles, remat, microbatches, grad_comm and the
# optimizer's moment dtype; decode runs the plain attention and scan steps
# and reads only the cache's dtype)
PROGRAM_FIELDS = {
    "train": ("remat", "microbatches", "opt_dtype", "grad_comm", "attn_block", "scan_chunk"),
    "prefill": ("attn_block", "scan_chunk"),
    "decode": ("kv_dtype",),
}


def combine_terms(
    flops_total: float,
    hbm_bytes_total: float,
    coll_bytes_per_chip: float,
    chips: int,
    overlap: float,
    hw="h100",
) -> Dict[str, float]:
    hw: HardwareSpec = get_hardware(hw)
    compute_s = flops_total / (chips * hw.peak_flops)
    memory_s = hbm_bytes_total / (chips * hw.hbm_bw)
    collective_s = coll_bytes_per_chip / hw.link_bw
    step_s = max(compute_s, memory_s) + (1.0 - overlap) * collective_s
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "step_s": step_s,
    }


def program_of(plan, kind: str) -> dict:
    """The plan fields the card's step of a ``kind`` cell reads, with
    ``microbatches`` capped at the cut's rows (``CUT_ROWS``).  On one card ``grad_comm``
    ``"rs_ag"`` runs the step ``"fp32"`` does (there is no collective; only
    ``"int8"`` changes the step, as a rowwise fake quant of the gradients),
    so both are the program's ``"fp32"``."""
    d = plan if isinstance(plan, dict) else plan.to_dict()
    prog = {f: d[f] for f in PROGRAM_FIELDS[kind]}
    if "attn_block" in prog:
        prog["attn_block"] = list(prog["attn_block"])
    if "microbatches" in prog:
        prog["microbatches"] = min(int(prog["microbatches"]), CUT_ROWS[kind])
    if "grad_comm" in prog and prog["grad_comm"] != "int8":
        prog["grad_comm"] = "fp32"
    return prog


# ---------------------------------------------------------------------------
# Subprocess measurement client (with on-disk cache)
# ---------------------------------------------------------------------------
KEY_VERSION = 3


def _cache_key(
    arch: str, shape: str, mesh: str, plan: Optional[dict],
    devices: Optional[int] = None, hw: str = "h100", device: Optional[str] = None,
    cut: Optional[dict] = None, source: Optional[str] = None,
) -> str:
    fields = [KEY_VERSION, arch, shape, mesh, devices, get_hardware(hw).name, device, cut, plan]
    blob = json.dumps(fields + ([source] if source else []), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def make_request(
    arch: str,
    shape: str,
    mesh: str = "single",
    plan=None,
    devices: Optional[int] = None,
    timeout: float = 1800.0,
    module: Optional[str] = None,
    extras: Optional[dict] = None,
    *,
    hw: str = "h100",
    device: Optional[str] = None,
    cut: Optional[dict] = None,
) -> dict:
    """Normalize one measurement request to the plain-dict form every
    measurement path (serial ``measure_cell``, the fleet) shares.
    ``device`` is the device kind a real measurement runs on (``"cuda"`` or
    ``"cpu"``; None for the analytic stub) and ``cut`` its cut (``layers``,
    ``seq``, ``reduced``; ``launch/measure.py`` runs the full config at the
    cell's length by default).
    ``extras`` is transport-only: it never enters the cache key
    (fault-injection hooks for tests live there)."""
    if plan is not None and not isinstance(plan, dict):
        plan = plan.to_dict()
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "plan": plan,
        "devices": devices, "timeout": timeout,
        "module": module or DRYRUN_MODULE, "extras": extras,
        "hw": hw, "device": device, "cut": cut,
    }


def request_key(req: dict) -> str:
    plan = req["plan"]
    if req["mesh"] in DRYRUN_MESHES:
        # the dry run's record: the full config on the meta device, whatever
        # device or cut the request names
        return _cache_key(req["arch"], req["shape"], req["mesh"], plan, req.get("devices"),
                          req.get("hw") or "h100", source="dryrun")
    if req.get("device") is not None and req["mesh"] == "card" and plan is not None:
        plan = {"program": program_of(plan, get_shape(req["shape"]).kind)}
    return _cache_key(
        req["arch"], req["shape"], req["mesh"], plan, req.get("devices"),
        req.get("hw") or "h100", req.get("device"), req.get("cut"),
    )


def load_record(path: str) -> Optional[dict]:
    """Validated cache read.  A corrupt or truncated entry (a crashed
    writer, a pre-atomic-rename cache) is QUARANTINED — deleted so the
    next call re-measures — instead of being served as a hit or raising
    on every lookup forever."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        rec = None
    if isinstance(rec, dict) and "step_s" in rec:
        return rec
    try:
        os.remove(path)
    except OSError:
        pass
    return None


def write_record(path: str, record: dict) -> None:
    """Atomic publish: write to a sibling tmp file, ``os.replace`` into
    place.  Readers can never observe a partial record."""
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _tail(text, n: int = 2000) -> str:
    return (text or "")[-n:]


def measure_request(req: dict) -> dict:
    """Pure measurement of one request: spawn the measurement subprocess,
    point its ``--json-out`` at a PRIVATE tmp file, and return the parsed
    record.  No cache interaction and no on-disk residue on any failure
    path — a killed or timed-out run can never poison a cache entry,
    because the final cache path is only ever written by the caller's
    atomic ``write_record``."""
    arch, shape, mesh = req["arch"], req["shape"], req["mesh"]
    timeout = req.get("timeout") or 1800.0
    tmp = os.path.join(
        tempfile.gettempdir(), f"repro-measure-{os.getpid()}-{uuid.uuid4().hex}.json"
    )
    cmd = [
        sys.executable,
        "-m",
        req.get("module") or DRYRUN_MODULE,
        "--arch", arch,
        "--shape", shape,
        "--mesh", mesh,
        "--hw", req.get("hw") or "h100",
        "--json-out", tmp,
    ]
    if req.get("plan") is not None:
        cmd += ["--plan-json", json.dumps(req["plan"])]
    if req.get("devices") is not None:
        cmd += ["--devices", str(req["devices"])]
    if req.get("device") is not None:
        cmd += ["--device", req["device"]]
    for k, v in sorted((req.get("cut") or {}).items()):
        if v is True:
            cmd.append(f"--{k}")
        elif v not in (None, False):
            cmd += [f"--{k}", str(v)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in [env.get("PYTHONPATH"), _src_path()] if p]
    )
    try:
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=timeout, env=env
            )
        except subprocess.TimeoutExpired as e:
            # surface the same RuntimeError path as a failed run, with
            # whatever partial output the subprocess produced
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout
            err = e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr
            raise RuntimeError(
                f"measurement timed out after {timeout:.0f}s for "
                f"{arch}×{shape}×{mesh}:\n"
                f"stdout: {_tail(out)}\nstderr: {_tail(err)}"
            ) from None
        rec = load_record(tmp) if proc.returncode == 0 else None
        if rec is None:
            raise RuntimeError(
                f"measurement failed for {arch}×{shape}×{mesh} "
                f"(exit {proc.returncode}):\n"
                f"stdout: {_tail(proc.stdout)}\nstderr: {_tail(proc.stderr)}"
            )
        return rec
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def measure_cell(
    arch: str,
    shape: str,
    mesh: str = "single",
    plan: Optional[SchedulePlan] = None,
    cache_dir: str = CACHE_DIR,
    timeout: float = 1800.0,
    devices: Optional[int] = None,
    target=None,
    *,
    hw: str = "h100",
    device: Optional[str] = None,
    cut: Optional[dict] = None,
) -> dict:
    """Measure (arch, shape, plan) on ``device`` in a subprocess and return
    the record.  Results are cached on disk — re-measuring a program is
    free.  Corrupt cache entries are quarantined and re-measured; the cache
    file itself is only ever written atomically.  ``target`` overrides the
    measurement function (default: the subprocess ``measure_request``;
    tests pass the analytic stub)."""
    req = make_request(arch, shape, mesh, plan, devices, timeout,
                       hw=hw, device=device, cut=cut)
    key = request_key(req)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".json")
    rec = load_record(path)
    if rec is not None:
        return rec
    rec = (target or measure_request)(req)
    write_record(path, rec)
    # return the JSON round-trip of what was stored, so a fresh
    # measurement and a later cache hit are structurally identical
    # (e.g. tuples in the plan normalize to lists)
    return load_record(path)


def measured_step_time(
    arch: str, shape: str, mesh: str = "single", plan: Optional[SchedulePlan] = None,
    **kw,
) -> float:
    return measure_cell(arch, shape, mesh, plan, **kw)["step_s"]


def make_measure_fn(arch: str, shape: str, mesh: str = "single", **kw):
    def fn(plan: SchedulePlan) -> float:
        return measured_step_time(arch, shape, mesh, plan, **kw)

    return fn


def _src_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return here
