#!/usr/bin/env python3
"""Time text-replaced variants of the bf16 flash and moe_gemm kernels against
the kernels as they are, in one call on one card.

    python3 scripts/torch_kernel_variants.py DIR     # on a machine with a CUDA card

``DIR`` must lie outside the checkout.  Each variant is a copy of ``src/`` and
``chip_smoke.py`` in ``DIR/<variant>`` with one design choice of a kernel
undone by text replacement; the copy builds its own kernel and, in a fresh
process, times it at the main path's shapes with ``chip_smoke.timed`` (the
kernel, the library call, the kernel again, CUDA events) after holding its
output against the plain version.  ``control`` is the unedited source.  The
variants, each the earlier form of one part of the design:

* ``flash_exact_exp2``: the softmax's ``ex2.approx.ftz`` replaced by the
  exact ``exp2f``;
* ``moe_direct_store``: the output written straight from the accumulator
  fragment (4 bytes a thread, 8 rows a warp instruction) instead of being
  staged through the freed ring and written in 16-byte pieces;
* ``moe_encode_x10``: the launcher encodes its two TMA tensor maps ten
  times a launch instead of once, to show what encoding costs the host.

Prints one JSON line per variant and shape: ms, library ms, ``vs_library``,
the plain-version error, and the host's microseconds a launch
(``host_us``: 200 launches without a synchronisation, over their count).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = Path("src/repro_torch/kernels")

_STAGED = """      constexpr int kPitch = BN + 8;
      sm90::named_barrier_sync(1, 128 * consumers);"""
_DIRECT = """#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = ch * BN + j * 8 + col2;
        if (col >= block_f) continue;
        bf16* o = out + (static_cast<long long>(e) * C + c0 + row) * f + f0 + col;
        if (row < block_c) *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < block_c)
          *reinterpret_cast<uint32_t*>(o + 8LL * f) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      if (true) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(staged);
        continue;
      }
      constexpr int kPitch = BN + 8;
      sm90::named_barrier_sync(1, 128 * consumers);"""

# variant -> (file under src/repro_torch/kernels, [(text, replacement), ...]):
# every occurrence of each text is replaced
VARIANTS = {
    "control": None,
    "flash_exact_exp2": ("csrc/flash_attention.cu", [(
        '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n', "  y = exp2f(x);\n")]),
    "moe_direct_store": ("csrc/moe_gemm.cu", [(_STAGED, _DIRECT)]),
    "moe_encode_x10": ("csrc/moe_gemm.cu", [(
        "    CUtensorMap xmap, wmap;\n",
        "    CUtensorMap xmap, wmap;\n"
        "    for (int rep = 0; rep < 9; ++rep) {\n"
        "      sm90::encode_bf16_3d(&xmap, x, d, C, E, 64, 64);\n"
        "      sm90::encode_bf16_3d(&wmap, w, f, d, E, 64, 64);\n"
        "    }\n")]),
}

RUN = """
import json, sys, time
sys.path.insert(0, "src")
import torch, torch.nn.functional as F
import chip_smoke as cs
from repro_torch.kernels import flash_attention as fa, moe_gemm as mg
gen = torch.Generator(device="cuda").manual_seed(0)
out = []
def host_us(fn, n=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6
for B, Hq, Hkv, S, D, bq, bkv in ((1, 32, 8, 4096, 64, 256, 256), (1, 16, 8, 4096, 64, 256, 256)):
    q, k, v = (torch.randn((B, h, S, D), generator=gen, device="cuda").bfloat16() for h in (Hq, Hkv, Hkv))
    got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    exp = fa.attention_plain(q, k, v)
    ops = 4 * D * cs._visible_pairs(S, S, True) * B * Hq
    t = cs.timed(torch, lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv),
                 lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), ops)
    out.append({"kernel": "flash_attention", "shape": [B, Hq, Hkv, S, S, D], "tile": [bq, bkv],
                "rel_err": ((got.float() - exp.float()).norm() / exp.float().norm()).item(), **t,
                "host_us": host_us(lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv))})
for E, C, d, f in ((32, 1280, 1024, 512), (32, 1280, 512, 1024), (32, 8, 1024, 512), (32, 8, 512, 1024)):
    x = torch.randn((E, C, d), generator=gen, device="cuda").bfloat16()
    w = torch.randn((E, d, f), generator=gen, device="cuda").bfloat16()
    got = mg.moe_gemm(x, w, block_c=128, block_f=256, block_d=256)
    exp = mg.moe_gemm_plain(x, w)
    t = cs.timed(torch, lambda: mg.moe_gemm(x, w, block_c=128, block_f=256, block_d=256),
                 lambda: torch.bmm(x, w), 2 * E * C * d * f)
    out.append({"kernel": "moe_gemm", "shape": [E, C, d, f], "tile": [128, 256, 256],
                "rel_err": ((got.float() - exp.float()).norm() / exp.float().norm()).item(), **t,
                "host_us": host_us(lambda: mg.moe_gemm(x, w, block_c=128, block_f=256, block_d=256)),
                "library_host_us": host_us(lambda: torch.bmm(x, w))})
print(json.dumps(out))
"""


def run_variant(base: Path, name: str, edit) -> list:
    work = base / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src", work / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
    if edit is not None:
        rel, pairs = edit
        path = work / KERNELS / rel
        text = path.read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: the text to edit is not in {path.name}")
            text = text.replace(old, new)
        path.write_text(text)
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=work, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} did not run:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(sys.argv[1]).resolve()
    if base == ROOT or ROOT in base.parents:
        print(f"{base} lies inside the checkout; give a directory outside it", file=sys.stderr)
        return 2
    for name, edit in VARIANTS.items():
        for row in run_variant(base, name, edit):
            print(json.dumps({"variant": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
