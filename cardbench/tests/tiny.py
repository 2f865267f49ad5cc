"""A benchmark of two tiny cells in a temporary folder, for the CPU tests:
the program's ``reduced()`` configurations in float32, at a few rows, under
the real kinds and metrics."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from cardbench import bench

TRAIN, DECODE = "tiny-mamba.train", "tiny-moe.decode"

SIZES = {
    "tiny-mamba": {"arch": "falcon-mamba-7b", "sizes": {
        "d_model": 64, "n_layers": 2, "vocab_size": 256, "period": [["mamba", "none"]],
        "norm_eps": 1e-06, "tie_embeddings": False, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
        "n_experts": 0, "d_inner": 128, "ssm_state": 8, "dt_rank": 8, "conv_width": 4}},
    "tiny-moe": {"arch": "granite-moe-1b-a400m", "sizes": {
        "d_model": 64, "n_layers": 2, "vocab_size": 256, "period": [["attn", "moe"]],
        "norm_eps": 1e-06, "tie_embeddings": True, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "rope_theta": 10000.0, "d_ff": 128, "n_experts": 4, "experts_per_token": 2,
        "capacity_factor": 1.25, "capacity_block": 128}},
}

TRAFFIC = {
    "train-tiny": {"kind": "train", "rows": 2, "seq_len": 32, "pool_rows": 8, "warmup_steps": 2,
                   "tune": {"algo": "mcts_1s", "shape": "train_4k", "hw": "h100", "mesh": "card",
                            "seed": 0},
                   "optimizer": {"peak_lr": 0.001, "warmup_steps": 2, "total_steps": 100,
                                 "b1": 0.9, "b2": 0.95, "eps": 1e-08, "weight_decay": 0.1,
                                 "clip_norm": 1.0}},
    "decode-tiny": {"kind": "decode", "slots": 4, "max_len": 64, "history_lengths": [16, 40],
                    "history_std": 3.0, "warmup_steps": 2, "most_steps": 6,
                    "tune": {"algo": "mcts_1s", "shape": "decode_32k", "hw": "h100", "mesh": "card",
                             "seed": 0}},
}


# the training kind's metrics, which no cell of the benchmark reports yet
TRAIN_END_TO_END = [
    {"name": "train_tokens_per_s", "unit": "tokens/s", "better": "higher", "bound": 0.05,
     "source": "host_clock", "workloads": [TRAIN]}]
TRAIN_PER_LAYER = [
    {"name": "mfu.train", "unit": "%", "better": "higher", "source": "host_clock", "layer": "train step",
     "moves": "train_tokens_per_s", "workloads": [TRAIN]},
    {"name": "selective_scan_roofline.train", "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "kernels", "moves": "train_tokens_per_s", "workloads": [TRAIN]},
    {"name": "device_idle_share.train", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "train_tokens_per_s", "workloads": [TRAIN]}]


def make(root: Path, limits=None) -> Path:
    """Write the tiny benchmark under ``root``; returns its BENCHMARK.json."""
    for sub in ("kinds", "metrics"):
        shutil.copytree(bench.HERE / sub, root / sub)
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir()
    init = json.loads((bench.HERE / "configs" / "falcon-mamba-7b.json").read_text())["init"]
    init.update(json.loads((bench.HERE / "configs" / "granite-moe-1b-a400m.json").read_text())["init"])
    for name, c in SIZES.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(
            {**c, "variant": "reduced", "dtype": "float32", "reduced": [], "init": init}))
    for name, t in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    lim = {TRAIN: {"grad_gap": 1e-3, "nu_gap": 1e-3, "change_gap": 1e-3},
           DECODE: {"token_gap_p99": 1e-3, "kv_first_layer_err": 1e-3, "kv_median_err": 1e-3}}
    lim.update(limits or {})
    for cell, values in lim.items():
        (root / "limits" / f"{cell}.json").write_text(json.dumps(values))
    real = json.loads((bench.REPO / "BENCHMARK.json").read_text())
    benchmark = {
        **real,
        "configs": [{"name": n, "source": "test", "file": f"configs/{n}.json", "reduced": [],
                     "why": "test"} for n in SIZES],
        "workloads": [{"name": TRAIN, "config": "tiny-mamba", "traffic": "train-tiny", "chips": 1,
                       "why": "test"},
                      {"name": DECODE, "config": "tiny-moe", "traffic": "decode-tiny", "chips": 1,
                       "why": "test"}],
    }
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        if "workloads" in m:  # the benchmark's cells decode; the search's time is both kinds'
            m["workloads"] = [DECODE, TRAIN] if m.get("moves") == "setup_s" else [DECODE]
    benchmark["end_to_end"] += TRAIN_END_TO_END
    benchmark["per_layer"] += TRAIN_PER_LAYER
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(benchmark))
    return path


def cell(root: Path, name: str, limits=None) -> bench.Cell:
    return bench.find_cell(name, make(root, limits), root)


def run(cell_: bench.Cell, seed: int = 5, seconds: float = 0.2, traced: bool = False) -> bench.Run:
    import time

    return bench.Run(cell_, seed, seconds, traced, "cpu", process_start=time.time())
