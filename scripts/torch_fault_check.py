#!/usr/bin/env python3
"""Plant known faults in copies of the port's CUDA kernels and check that the
kernel phases of ``chip_smoke.py`` catch every one.

    python3 scripts/torch_fault_check.py DIR     # on a machine with a CUDA card

``DIR`` must lie outside the checkout.  Each case is a copy of ``src/`` and
``chip_smoke.py`` in ``DIR/<case>`` with at most one edit to one kernel's
source under ``csrc/``; the copy builds its own kernels and runs, in a fresh
process, the ``chip_smoke`` phase of the edited kernel (the unedited control
runs the phases of every kernel that has a fault below).  The control must
pass and every mutant must fail.  Prints one JSON line per case (with the
failing check's numbers) and exits 1 if any case went the other way.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")

# kernel -> (its module under repro_torch.kernels, its chip_smoke phase)
PHASES = {
    "flash_attention": ("flash_attention", "phase_kernels_flash"),
    "moe_gemm": ("moe_gemm", "phase_kernels_moe"),
    "selective_scan": ("selective_scan", "phase_kernels_scan"),
}

# case -> (kernel, text of its source, the replacement); the first occurrence
# in the file is replaced, which is the bf16 kernel's where a file has two
CASES = {
    "control": None,
    # query tiles from row 2048 on never visit their last kv tile: only the
    # 4096-token main-path shapes have such rows
    "flash_skip_last_kv_tile_from_row_2048": (
        "flash_attention",
        "const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1);",
        "const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1) - (q0 >= 2048);",
    ),
    # the accumulator of the first 8 rows of each warp is not rescaled when
    # the running max grows
    "flash_alpha_not_applied_to_rows_g": (
        "flash_attention",
        "        acc[n][0] *= alpha_a;\n        acc[n][1] *= alpha_a;\n",
        "",
    ),
    # the bf16 grouped GEMM never runs its last block_d step
    "moe_gemm_skip_last_block_d_step": (
        "moe_gemm",
        "for (int d0 = 0; d0 < d; d0 += block_d) {",
        "for (int d0 = 0; d0 < d - block_d; d0 += block_d) {",
    ),
    # the scan's state is zeroed at every chunk boundary instead of once per
    # (batch, d-block): right within a chunk, wrong from the second one on
    "scan_zero_state_every_chunk": (
        "selective_scan",
        "    __syncthreads();  // the previous chunk is consumed\n",
        "    for (int n = 0; n < kMaxN; ++n) x[n] = 0.f;\n"
        "    __syncthreads();  // the previous chunk is consumed\n",
    ),
}

RUN = """
import sys
sys.path.insert(0, "src")
import torch, torch.nn.functional as F
import chip_smoke
from repro_torch.kernels import {module} as kernel
torch.backends.cuda.matmul.allow_tf32 = False
chip_smoke.{phase}(torch, F, kernel)
"""


def run_case(base: Path, name: str, edit) -> dict:
    work = base / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src", work / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
    kernels = sorted({c[0] for c in CASES.values() if c is not None})
    if edit is not None:
        kernel, old, new = edit
        path = work / CSRC / f"{kernel}.cu"
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: the text to edit is not in {path.name}")
        path.write_text(text.replace(old, new, 1))
        kernels = [kernel]
    failure, passed = [], True
    for kernel in kernels:
        module, phase = PHASES[kernel]
        proc = subprocess.run([sys.executable, "-c", RUN.format(module=module, phase=phase)],
                              cwd=work, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("AssertionError")]
        if proc.returncode != 0 and not lines:
            raise RuntimeError(f"{name}: the {phase} phase did not run:\n{proc.stderr[-4000:]}")
        passed &= proc.returncode == 0
        failure += lines
    return {"case": name, "kernels": kernels, "phase_passed": passed,
            "caught": failure[-1] if failure else None, "as_expected": passed == (edit is None)}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(sys.argv[1]).resolve()
    if base == ROOT or ROOT in base.parents:
        print(f"{base} lies inside the checkout; give a directory outside it", file=sys.stderr)
        return 2
    ok = True
    for name, edit in CASES.items():
        row = run_case(base, name, edit)
        ok &= row["as_expected"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
