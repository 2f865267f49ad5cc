"""``BENCHMARK.json`` against the benchmark's contract, and every file a cell
and a metric are found by."""
import json
import re
from pathlib import Path

import pytest

from cardbench import bench

B = json.loads((bench.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {"name", "unit", "better", "bound", "source"}
LAYER = {"name", "unit", "better", "source", "layer", "moves"}


def test_cardbench_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                              for p in B["paths"])
    assert len(B["command"]) <= 32 and all(1 <= len(w) <= 200 for w in B["command"])
    assert all(w.startswith(tuple(B["paths"])) for w in B["command"] if "/" in w)
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B).encode()) <= 64 * 1024


def test_cardbench_names_and_units():
    metrics = B["end_to_end"] + B["per_layer"]
    for group in (B["configs"], B["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(B["workloads"]) // 4)


def test_cardbench_entry_keys_and_bounds():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names and 1 <= len(B["end_to_end"]) <= 16
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == E2E
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == LAYER
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names and "\n" not in m["layer"]


def _cells_reporting(metric):
    return [w["name"] for w in B["workloads"]
            if "workloads" not in metric or w["name"] in metric["workloads"]]


def test_cardbench_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"] if w["name"] in _cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells_reporting(m) for m in B["per_layer"])


def test_cardbench_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        for cell in m["workloads"]:
            assert cell in _cells_reporting(e2e[m["moves"]]), (m["name"], cell)
    layers = {}
    for m in B["per_layer"]:  # a layer's metrics give its name letter for letter
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cardbench_shares_name_their_peak():
    for m in B["per_layer"]:
        if m["unit"] == "%" and "idle" not in m["name"]:
            assert "_roofline" in m["name"] or "mfu" in m["name"]


def test_cardbench_every_config_has_a_cell_and_files():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        cfg = json.loads((bench.REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_cardbench_cell_files_are_found_by_name(workload):
    cell = bench.find_cell(workload)
    assert cell.kind().__name__
    for m in cell.end_to_end + cell.per_layer:
        assert (bench.HERE / "metrics" / f"{m['name']}.py").exists()
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_cardbench_paths_hold_only_the_benchmark():
    for p in B["paths"]:
        assert (bench.REPO / p).is_dir()
        assert not (bench.REPO / p).name.endswith("_torch")
    assert not any(Path(bench.REPO / p).name == "benchmarks" for p in B["paths"])
