#!/usr/bin/env python3
"""Plant known faults in copies of the port's flash-attention kernel and check
that the kernel phase of ``chip_smoke.py`` catches every one.

    python3 scripts/torch_fault_check.py DIR     # on a machine with a CUDA card

``DIR`` must lie outside the checkout.  Each case is a copy of ``src/`` and
``chip_smoke.py`` in ``DIR/<case>`` with at most one edit to
``csrc/flash_attention.cu``; the copy builds its own kernel and runs
``chip_smoke.phase_kernels_flash`` in a fresh process.  The unedited control
must pass and every mutant must fail.  Prints one JSON line per case (with the
failing check's numbers) and exits 1 if any case went the other way.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention.cu")

# case -> (text of the bf16 kernel, its replacement); the first occurrence in
# the file is the bf16 kernel's
CASES = {
    "control": None,
    # query tiles from row 2048 on never visit their last kv tile: only the
    # 4096-token main-path shapes have such rows
    "skip_last_kv_tile_from_row_2048": (
        "const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1);",
        "const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1) - (q0 >= 2048);",
    ),
    # the accumulator of the first 8 rows of each warp is not rescaled when
    # the running max grows
    "alpha_not_applied_to_rows_g": (
        "        acc[n][0] *= alpha_a;\n        acc[n][1] *= alpha_a;\n",
        "",
    ),
}

RUN = """
import sys
sys.path.insert(0, "src")
import torch, torch.nn.functional as F
import chip_smoke
from repro_torch.kernels import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
chip_smoke.phase_kernels_flash(torch, F, fa)
"""


def run_case(base: Path, name: str, edit) -> dict:
    work = base / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src", work / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
    if edit is not None:
        old, new = edit
        text = (work / KERNEL).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: the text to edit is not in {KERNEL}")
        (work / KERNEL).write_text(text.replace(old, new, 1))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=work, capture_output=True,
                          text=True, timeout=900)
    failure = [ln for ln in proc.stderr.splitlines() if ln.startswith("AssertionError")]
    passed = proc.returncode == 0
    if not passed and not failure:
        raise RuntimeError(f"{name}: the phase did not run:\n{proc.stderr[-4000:]}")
    return {"case": name, "phase_passed": passed, "caught": failure[-1] if failure else None,
            "as_expected": passed == (edit is None)}


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
