#!/usr/bin/env python3
"""Time variants of the port's kernels against the kernels as they are, in
one call on one card.

    python3 scripts/torch_kernel_variants.py DIR [--parent TREE] [--only a,b] [--kernels k,...]

on a machine with a CUDA card.  ``DIR`` must lie outside the checkout.  Each
variant is a copy of ``src/`` and ``chip_smoke.py`` in ``DIR/<variant>``
with one design choice of a kernel undone by text replacement; the copy
builds its own kernels and, in a fresh process, times them at the main
path's shapes with ``chip_smoke.timed`` (the kernel, the library call, the
kernel again, CUDA events) and ``chip_smoke.graph_ms`` (CUDA-graph replay:
device time alone) after holding each output against its plain version.
``control`` is the unedited source; ``parent`` (with ``--parent TREE``,
an unpacked earlier tree of the repository) is that tree's ``src/`` timed
by this tree's script, so an earlier body of every kernel runs beside the
current one; ``--only`` picks variants by name.  The variants, each the
earlier form of one part of the design:

* ``flash_exact_exp2``: the softmax's ``ex2.approx.ftz`` replaced by the
  exact ``exp2f``;
* ``moe_direct_store``: the output written straight from the accumulator
  fragment (4 bytes a thread, 8 rows a warp instruction) instead of being
  staged through the freed ring and written in 16-byte pieces;
* ``moe_encode_x10``: the launcher encodes its two TMA tensor maps ten
  times a launch instead of once, to show what encoding costs the host;
* ``rmsnorm_one_warp_to_2048``: a row stays with one warp up to 8 vectors
  a thread (d = 2048 in bf16) instead of 4;
* ``scan_one_chain_68_registers``: the scan's ``<h, C>`` summed in one
  chain of dependent FMAs, and no bound of 64 registers (68 then, three
  blocks an SM);
* ``scan_exact_exp2``: the scan's ``ex2.approx.ftz`` replaced by the exact
  ``exp2f``;
* ``scan_bwd_span8``: the scan backward's output pass reruns 8-step spans
  into registers (checkpoints every 8 steps) instead of 4-step ones;
* ``scan_bwd_one_block_an_sm``: the output pass without its bound of 128
  registers (about 195 then, one block an SM instead of two);
* ``quantize_two_pass_long_rows``: quantize's ``cta`` rows (a block a row)
  read twice, once for the amax and once for q, by the ``two_pass`` body,
  instead of once into shared memory;
* ``quantize_cluster_pull``: the ``cluster`` regime's partial maxima
  pulled (a cluster barrier, each block reading every block's partial
  through distributed shared memory, a second cluster barrier split around
  the writes of q) instead of pushed under an mbarrier.

Prints one JSON line per variant and shape: ms, library ms, ``vs_library``,
``device_ms`` where taken, the plain-version error, and the host's
microseconds a launch (``host_us``: 200 launches without a
synchronisation, over their count; the least of five such runs, since
the host is shared).  Rows: flash and moe_gemm (prefill and
decode), rmsnorm forward at the three prefill widths and decode, rmsnorm
forward + backward at granite-moe's training shape, the backward alone
where the tree has it, the scan at falcon-mamba's prefill shape at
each ``scan_chunk`` option (a chunk the tree refuses is reported so), and
the two backward kernels alone at the training paths' shapes (flash at
``(1,16,8,4096,4096,64)`` against SDPA's backward alone, with the fwd+bwd
beside it; the scan at ``(1,4096,8192,16)``, each ``scan_chunk`` option),
and the int8 pair at stablelm-12b's widest moment rows (``(92160,13824)``
f32, ``(5120,100352)`` f32 and bf16), granite-moe's ``(786432,512)`` and the
decode rows ``(128,64)`` bf16: quantize against its bound (no library call
computes it), dequantize against ``torch.mul(q, scale)``, both with
``device_ms``.  ``--kernels`` picks which of these groups run (``scan``:
the scan and both backward kernels).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = Path("src/repro_torch/kernels")
KINDS = ("flash", "moe", "rmsnorm", "scan", "quantize")  # the kernels RUN times, by --kernels

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

_PUSH = """  cluster_wait();  // every block's `got` is initialised
  if (threadIdx.x < k) {
    const uint32_t slot = map_rank(&part[rank], threadIdx.x);
    asm volatile("st.shared::cluster.f32 [%0], %1;\\n" ::"r"(slot), "f"(amax) : "memory");
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n" ::"r"(
                     map_rank(got, threadIdx.x))
                 : "memory");
  }
  mbar_wait_cluster(got, 0);  // the k partials of the row are here
  float m = 0.f;
  for (int r = 0; r < k; ++r) m = fmaxf(m, part[r]);
"""
_PULL = """  cluster_wait();
  if (threadIdx.x == 0) part[0] = amax;
  cluster.sync();  // every block's partial is written
  float m = 0.f;
  for (int r = 0; r < k; ++r) m = fmaxf(m, *cluster.map_shared_rank(&part[0], r));
  cluster_arrive();  // done reading the other blocks' shared memory
"""
_CLUSTER_END = "  slice_write(xs, n, rq, q + row * cols + e0, vec);\n}\n"

# variant -> (file under src/repro_torch/kernels, [(text, replacement), ...]),
# or a list of such: every occurrence of each text is replaced
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
    "rmsnorm_one_warp_to_2048": ("csrc/rmsnorm.cu", [
        ("constexpr int kVecTarget = 4;", "constexpr int kVecTarget = 8;"),
        ("      if (sh.NV == 4) return CALL(T, 4, true, false);                                     \\\n",
         "      if (sh.NV == 4) return CALL(T, 4, true, false);                                     \\\n"
         "      if (sh.NV == 8) return CALL(T, 8, true, false);                                     \\\n"),
    ]),
    "scan_one_chain_68_registers": ("csrc/selective_scan.cu", [
        ("__launch_bounds__(kMaxThreads, 2)", "__launch_bounds__(kMaxThreads)"),
        ("acc[n & 3] = fmaf(h[n], Cs[t * N + n], acc[n & 3]);", "acc[0] = fmaf(h[n], Cs[t * N + n], acc[0]);"),
    ]),
    "scan_exact_exp2": ("csrc/selective_scan.cu", [(
        '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n', "  y = exp2f(x);\n")]),
    "scan_bwd_span8": [
        ("csrc/selective_scan.cu", [("constexpr int kBwdSpan = 4; ", "constexpr int kBwdSpan = 8; "),
                                    ("constexpr int kBwdCkpts = 16;", "constexpr int kBwdCkpts = 8;")]),
        ("geometry.py", [("SCAN_BWD_SPAN = 4 ", "SCAN_BWD_SPAN = 8 ")]),
    ],
    "scan_bwd_one_block_an_sm": ("csrc/selective_scan.cu", [(
        "__global__ void __launch_bounds__(kBwdThreads, 2)", "__global__ void __launch_bounds__(kBwdThreads, 1)")]),
    "quantize_two_pass_long_rows": ("csrc/quantize.cu", [(
        "    quantize_cta_kernel<T><<<static_cast<unsigned>(rows), threads, smem, s>>>(x, q, scale, cols, vec);",
        "    quantize_two_pass_kernel<T><<<static_cast<unsigned>(rows), threads, kHeaderBytes, s>>>(\n"
        "        x, q, scale, cols, vec);")]),
    "quantize_cluster_pull": ("csrc/quantize.cu", [
        (_PUSH, _PULL), (_CLUSTER_END, "  slice_write(xs, n, rq, q + row * cols + e0, vec);\n  cluster_wait();\n}\n")]),
}

RUN = """
import json, sys, time
sys.path.insert(0, "src")
import torch, torch.nn.functional as F
import chip_smoke as cs
from repro_torch.kernels import flash_attention as fa, moe_gemm as mg
from repro_torch.kernels import rmsnorm as rn, selective_scan as ss
torch.backends.cuda.matmul.allow_tf32 = False
KINDS = set(sys.argv[1].split(","))
gen = torch.Generator(device="cuda").manual_seed(0)
out = []
def host_us(fn, n=200, reps=5):
    best = float("inf")
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / n * 1e6
if "flash" in KINDS:
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
if "moe" in KINDS:
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
def rel(got, exp):
    return ((got.float() - exp.float()).norm() / exp.float().norm()).item()
if "rmsnorm" in KINDS:
    for R, d in ((4096, 2048), (4096, 1024), (4096, 4096), (4, 2048)):
        x = torch.randn((R, d), generator=gen, device="cuda").bfloat16()
        w = torch.randn((d,), generator=gen, device="cuda").bfloat16()
        lib = lambda: F.rms_norm(x, (d,), w, 1e-6)
        t = cs.timed(torch, lambda: rn.rmsnorm(x, w), lib, 4 * R * d)
        out.append({"kernel": "rmsnorm", "shape": [R, d], "rel_err": rel(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w)),
                    **t, "device_ms": cs.graph_ms(torch, lambda: rn.rmsnorm(x, w)),
                    "library_device_ms": cs.graph_ms(torch, lib),
                    "host_us": host_us(lambda: rn.rmsnorm(x, w)), "library_host_us": host_us(lib)})
    x = torch.randn((4096, 1024), generator=gen, device="cuda").bfloat16().requires_grad_()
    w = (1 + 0.1 * torch.randn((1024,), generator=gen, device="cuda")).bfloat16().requires_grad_()
    gy = torch.randn((4096, 1024), generator=gen, device="cuda").bfloat16()
    fb = lambda: torch.autograd.grad(rn.rmsnorm(x, w), (x, w), gy)
    row = {"kernel": "rmsnorm fwd+bwd", "shape": [4096, 1024], "fwd_bwd_ms": cs.cuda_ms(torch, fb),
           "plain_fwd_bwd_ms": cs.cuda_ms(torch, lambda: torch.autograd.grad(rn.rmsnorm_plain(x, w), (x, w), gy))}
    try:
        row["fwd_bwd_device_ms"] = cs.graph_ms(torch, fb)
    except Exception as e:  # a measurement this tree's code may not allow under capture
        row["fwd_bwd_device_ms"] = f"not measured: {type(e).__name__}: {str(e)[:200]}"
    if hasattr(rn, "rmsnorm_backward"):
        xd, wd = x.detach(), w.detach()
        row.update(bwd_ms=cs.cuda_ms(torch, lambda: rn.rmsnorm_backward(xd, wd, gy)),
                   bwd_device_ms=cs.graph_ms(torch, lambda: rn.rmsnorm_backward(xd, wd, gy)),
                   bwd_host_us=host_us(lambda: rn.rmsnorm_backward(xd, wd, gy)))
    out.append(row)
if "scan" in KINDS:
    B, L, Di, N = 1, 4096, 8192, 16
    u = torch.randn((B, L, Di), generator=gen, device="cuda").bfloat16()
    delta = torch.nn.functional.softplus(torch.randn((B, L, Di), generator=gen, device="cuda")).bfloat16()
    A = -torch.exp(0.5 * torch.randn((Di, N), generator=gen, device="cuda"))
    Bm = torch.randn((B, L, N), generator=gen, device="cuda").bfloat16()
    Cm = torch.randn((B, L, N), generator=gen, device="cuda").bfloat16()
    D = torch.linspace(0.1, 1.0, Di, device="cuda")
    exp = ss.selective_scan_plain(u, delta, A, Bm, Cm, D)
    for ch in (64, 128, 256):
        run = lambda: ss.selective_scan(u, delta, A, Bm, Cm, D, chunk=ch, d_block=256)
        try:
            got = run()
        except ValueError as e:
            out.append({"kernel": "selective_scan", "shape": [B, L, Di, N], "chunk": ch, "refused": str(e)})
            continue
        out.append({"kernel": "selective_scan", "shape": [B, L, Di, N], "chunk": ch, "rel_err": rel(got, exp),
                    **cs.timed(torch, run, None, B * L * Di * (7 * N + 3), iters=10),
                    "host_us": host_us(run, n=20)})
    if hasattr(fa, "BWD_LAUNCHES"):  # the backward kernels, where the tree has them
        from repro_torch.kernels import ref
        q, k, v = (torch.randn((1, h, 4096, 64), generator=gen, device="cuda").bfloat16() for h in (16, 8, 8))
        do = torch.randn((1, 16, 4096, 64), generator=gen, device="cuda").bfloat16()
        _, lse = fa._launch(q, k, v, True, fa.flash_launch(1, 16, 4096, 4096, 64, "bfloat16", 256, 256),
                            with_lse=True)
        bwd = fa.flash_backward_launch(1, 16, 8, 4096, 4096, 64, "bfloat16")
        run = lambda: fa._launch_backward(q, k, v, lse, do, True, bwd)
        exp = fa.attention_backward_plain(q, k, v, lse, do)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        ys = F.scaled_dot_product_attention(*xs, is_causal=True, enable_gqa=True)
        ops = 10 * 64 * cs._visible_pairs(4096, 4096, True) * 16
        out.append({"kernel": "flash_attention_backward", "shape": [1, 16, 8, 4096, 4096, 64],
                    "rel_err": max(rel(a, b) for a, b in zip(run(), exp)),
                    **cs.timed(torch, run, lambda: torch.autograd.grad(ys, xs, do, retain_graph=True), ops,
                               iters=10),
                    "fwd_bwd_ms": cs.cuda_ms(torch, lambda: torch.autograd.grad(
                        fa.flash_attention(*xs, block_q=256, block_kv=256), xs, do), iters=10),
                    "host_us": host_us(run, n=20)})
        del ys, xs
        for ch in (64, 128, 256):
            launch = ss.scan_launch(B, L, Di, N, "bfloat16", ch, 256)
            bwd = ss.scan_backward_launch(B, L, Di, N, "bfloat16", ch, 256)
            _, states = ss._launch(u, delta, A, Bm, Cm, D, launch)
            run = lambda: ss._launch_backward(u, delta, A, Bm, Cm, D, states, u, bwd)
            row = {"kernel": "selective_scan_backward", "shape": [B, L, Di, N], "chunk": ch}
            if ch == 128:
                exp = ref.selective_scan_chunked_backward(u, delta, A, Bm, Cm, D, u, ch)
                row["rel_err"] = max(rel(a, b) for a, b in zip(run(), exp))
            out.append({**row, **cs.timed(torch, run, None, 25 * B * L * Di * N, iters=10)})
if "quantize" in KINDS:
    # the int8 pair at the main paths' widest rows and the decode rows (an
    # earlier tree given by --parent times its own body by this script)
    from repro_torch.kernels import geometry as geo
    from repro_torch.kernels import quantize as qt
    for R, C, dt in ((92160, 13824, "float32"), (5120, 100352, "float32"), (5120, 100352, "bfloat16"),
                     (786432, 512, "float32"), (128, 64, "bfloat16")):
        x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0).to(getattr(torch, dt))
        q, s = qt.quantize_int8(x)
        qp, sp = qt.quantize_int8_plain(x)
        nb = R * C * x.element_size() + R * C + 4 * R
        dnb = R * C + 4 * R + R * C * 4
        row = {"kernel": "quantize_int8", "shape": [R, C], "dtype": dt,
               "regime": geo.quantize_launch(R, C, dt).regime if hasattr(geo, "quantize_launch") else None,
               "bit_equal": bool(torch.equal(q, qp) and torch.equal(s, sp)),
               **cs.timed(torch, lambda: qt.quantize_int8(x), None, 4 * R * C),
               "device_ms": cs.graph_ms(torch, lambda: qt.quantize_int8(x)),
               "bound_ms": nb / cs.HBM_BYTES_PER_S * 1e3, "host_us": host_us(lambda: qt.quantize_int8(x))}
        row["bound_share_device"] = row["bound_ms"] / row["device_ms"]
        out.append(row)
        del qp, sp
        dq = cs.timed(torch, lambda: qt.dequantize_int8(q, s), lambda: torch.mul(q, s), R * C)
        out.append({"kernel": "dequantize_int8", "shape": [R, C], "dtype": "float32", **dq,
                    "device_ms": cs.graph_ms(torch, lambda: qt.dequantize_int8(q, s)),
                    "bound_ms": dnb / cs.HBM_BYTES_PER_S * 1e3})
        del x, q, s
print(json.dumps(out))
"""


def run_variant(base: Path, name: str, edit, src: Path = ROOT / "src", kinds=KINDS) -> list:
    work = base / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, work / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
    for rel, pairs in ([] if edit is None else edit if isinstance(edit, list) else [edit]):
        path = work / KERNELS / rel
        text = path.read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: the text to edit is not in {path.name}")
            text = text.replace(old, new)
        path.write_text(text)
    proc = subprocess.run([sys.executable, "-c", RUN, ",".join(kinds)], cwd=work, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} did not run:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--parent", help="an unpacked earlier tree of the repository")
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help=f"comma-separated kernels to time, of {','.join(KINDS)} (default all)")
    args = ap.parse_args()
    base = Path(args.dir).resolve()
    if base == ROOT or ROOT in base.parents:
        print(f"{base} lies inside the checkout; give a directory outside it", file=sys.stderr)
        return 2
    runs = [(name, edit, ROOT / "src") for name, edit in VARIANTS.items()]
    if args.parent:
        runs.insert(1, ("parent", None, Path(args.parent).resolve() / "src"))
    if args.only:
        keep = args.only.split(",")
        runs = [r for r in runs if r[0] in keep]
    kinds = args.kernels.split(",")
    if set(kinds) - set(KINDS):
        print(f"--kernels takes {','.join(KINDS)}", file=sys.stderr)
        return 2
    for name, edit, src in runs:
        for row in run_variant(base, name, edit, src, kinds):
            print(json.dumps({"variant": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
