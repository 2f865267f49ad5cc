"""The harness as the driver starts it, here where there is no card, and a
cell, a mix and a metric added as files of a folder of their own."""
import json
import shutil
import subprocess
import sys

from cardbench import bench
from cardbench.tests import tiny

import cardbench.run as R

ARGS = ["--workload", "granite-moe-1b-a400m.decode-32k", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def test_cardbench_no_card_no_result():
    out = subprocess.run([sys.executable, "cardbench/run.py", *ARGS], capture_output=True, text=True,
                         cwd=bench.REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_cardbench_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(bench.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "cardbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "cardbench/run.py", *ARGS], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


def test_cardbench_a_metric_added_as_a_file(tmp_path):
    path = tiny.make(tmp_path)
    (tmp_path / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.step_ends)) if run.step_ends else None\n")
    b = json.loads(path.read_text())
    b["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "train step", "moves": "train_tokens_per_s",
                           "workloads": [tiny.TRAIN]})
    path.write_text(json.dumps(b))
    cell = bench.find_cell(tiny.TRAIN, path, tmp_path)
    run = tiny.run(cell, traced=False)
    out = R.execute(run)
    got = bench.read_metrics(run, [m for m in cell.per_layer if m["name"] == "steps_in_window"])
    assert got["steps_in_window"]["value"] == out["attempted"] >= 1


def test_cardbench_a_mix_added_as_a_file(tmp_path):
    """A new decode mix (another slot count and history) in a folder of its
    own runs through the same kind, generator and metrics."""
    path = tiny.make(tmp_path)
    mix = dict(tiny.TRAFFIC["decode-tiny"], slots=3, history_lengths=[8, 20], history_std=1.0)
    (tmp_path / "traffic" / "decode-other.json").write_text(json.dumps(mix))
    b = json.loads(path.read_text())
    b["workloads"].append({"name": "tiny-moe.other", "config": "tiny-moe", "traffic": "decode-other",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if tiny.DECODE in m.get("workloads", []):
            m["workloads"].append("tiny-moe.other")
    path.write_text(json.dumps(b))
    limits = json.loads((tmp_path / "limits" / f"{tiny.DECODE}.json").read_text())
    (tmp_path / "limits" / "tiny-moe.other.json").write_text(json.dumps(limits))
    # a window that ends at the mix's most steps, however slow the machine
    out = R.execute(tiny.run(bench.find_cell("tiny-moe.other", path, tmp_path), seconds=600))
    # peak_gib reads nothing on the CPU
    assert out["correct"] and set(out["metrics"]) == {"setup_s", "decode_tokens_per_s",
                                                       "decode_step_p95_ms"}
