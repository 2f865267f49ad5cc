"""The harness's data: ``BENCHMARK.json``, the cell's files, and one run's record.

A cell is found by its name alone.  Its entry in ``BENCHMARK.json`` names
a configuration (``configs/<config>.json`` by the entry's ``file``) and a
traffic mix (``traffic/<traffic>.json``); the mix names its kind
(``kinds/<kind>.py``), and the cell's limits on what ``correct`` compares
sit in ``limits/<cell>.json``.  Each metric is read by
``metrics/<metric>.py``.  A later cell, mix, kind or metric is new files
and entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level names no run may load


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """The module of the file ``path`` (whose name may hold dots, as a
    metric's does), loaded once a process."""
    key = "cardbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # name -> limit of each number ``correct`` compares
    end_to_end: List[dict]  # BENCHMARK.json's metric entries this cell reports
    per_layer: List[dict]
    root: Path  # the folder the cell's files were found in

    def kind(self):
        return load_module(self.root / "kinds" / f"{self.traffic['kind']}.py")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, benchmark: Path = REPO / "BENCHMARK.json", root: Path = HERE) -> Cell:
    """The cell ``name`` of ``benchmark``, its files under ``root``."""
    bench = load_json(benchmark)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(work)}")
    w = work[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=w["chips"], config=load_json(Path(benchmark).parent / cfg_entry["file"]),
                traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(root / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


@dataclasses.dataclass
class Run:
    """One run's record: what the kind and the harness measured, which the
    metric readers read."""
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: str = "cuda"
    process_start: float = 0.0  # host clock (time.time) when the process started
    cfg: object = None  # the program's ModelConfig of the cell
    plan: object = None  # the SchedulePlan the cell runs, projected to its rows
    tune_s: Optional[float] = None
    setup_s: Optional[float] = None
    window_start: Optional[float] = None  # host clock (perf_counter)
    step_starts: List[float] = dataclasses.field(default_factory=list)
    step_ends: List[float] = dataclasses.field(default_factory=list)
    step_tokens: List[int] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # kernels in the window
    peak_bytes: Optional[int] = None
    trace: object = None  # trace.Summary of the traced window
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)  # name -> value, limit
    work: Dict[str, float] = dataclasses.field(default_factory=dict)  # a step's FLOPs and bytes

    def step_seconds(self) -> List[float]:
        return [b - a for a, b in zip(self.step_starts, self.step_ends)]

    def mean_step_s(self) -> Optional[float]:
        s = self.step_seconds()
        return sum(s) / len(s) if s else None

    def check(self, name: str, value: float) -> None:
        """Record a number ``correct`` compares, beside its limit."""
        self.checks[name] = {"value": value, "limit": self.cell.limits[name]}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks.values())


def read_metrics(run: Run, entries: List[dict]) -> Dict[str, dict]:
    """Each metric of ``entries`` that its reader finds something to read for."""
    out = {}
    for m in entries:
        value = load_module(run.cell.root / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def sync(device: str) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
