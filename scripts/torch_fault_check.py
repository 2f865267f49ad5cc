#!/usr/bin/env python3
"""Plant known faults in copies of the port's kernels, wrappers and decode
path and check that the phases of ``chip_smoke.py`` catch every one.

    python3 scripts/torch_fault_check.py DIR [CASE ...]  # on a machine with a CUDA card

The distribution layer's faults (the int8 ring, expert parallelism, int8
moments over shards) are caught by the CPU tests against the JAX package,
which run where JAX is (not on the card's machine):

    PYTHONPATH=src python3 scripts/torch_fault_check.py DIR ring_chunk_off_by_one \
        ep_expert_slice_offset ep_input_grad_not_reduced int8_moment_amax_local

and one more, a sequence-parallel norm's gradient left unsummed over the
model ranks (``sp_norm_grad_not_summed``), by the card's ``mesh`` phase,
leaf by leaf.  Four faults of decode over a mesh (the partial softmaxes
combined under each rank's own max, the mask on local positions, the new
row at a shard's first position written on the shard before, and Mamba's
``in_proj`` taken as a contiguous split) must be caught by
``tests/test_torch_mesh_decode.py`` and, all but the mask (planted in the
plain decode attention, which the card does not run), by the card's
``mesh_decode`` phase; the decode attention kernel's own mask on local
positions and its combine leaving out a row's last chunk are caught by
the card's ``kernels.decode_attention`` phase.  Each machine runs the half
it can (the tests where JAX is, the phase where the CUDA toolkit is), so
run those cases on both:

    PYTHONPATH=src python3 scripts/torch_fault_check.py DIR mesh_decode_combine_local_max \
        mesh_decode_mask_local_positions mesh_decode_write_on_neighbour \
        mamba_decode_in_proj_whole_split

Two faults of the optimizer's chunks (the decay read from a chunk's
period, a moment chunk's scales read from the next chunk's rows) must be
caught by ``tests/test_torch_optimizer_chunks.py`` and by the card's
falcon-mamba ``train_parity`` (its chunked update held to the whole-leaf
one):

    PYTHONPATH=src python3 scripts/torch_fault_check.py DIR optimizer_decay_from_chunk_rank \
        optimizer_moment_scales_one_chunk_off

Three faults of the dry run (a meta branch recording a launch twice, an
all-gather counted at a wrong group size, a ``work.py`` formula off by a
factor) must be caught by ``tests/test_torch_dryrun.py`` and, where the card
can see them, by its ``dryrun`` phase or its bound columns:

    PYTHONPATH=src python3 scripts/torch_fault_check.py DIR dryrun_flash_launch_counted_twice \
        collective_group_size_off_by_one work_flash_operations_halved

``--card`` runs only the card phases (the CPU tests hold the port to the JAX
package, which does not run on the card's machine).  ``DIR`` must lie
outside the checkout; naming cases runs the control and those cases only.  Each case is a copy of ``src/`` and ``chip_smoke.py`` in
``DIR/<case>`` with one fault planted in one file under ``src/repro_torch/``
(a CUDA source, a wrapper, the int8 KV cache's write in
``models/attention.py``, M-RoPE in ``models/layers.py``, the embeddings
archs' decode positions); the copy builds its own kernels and runs, in a
fresh process, the ``chip_smoke`` phase that must catch it: the file's
phase, or the case's own where it names one (the unedited control runs
every phase of the cases run; a case checked by CPU tests runs them on
its copy with ``pytest``).  The control must pass every check and every
mutant (forty-four of them) must fail every check it runs.  Prints one
JSON line per case (with the failing check's numbers) and exits 1 if any
case went the other way.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = Path("src/repro_torch")

# chip_smoke phase -> its call, with the kernel modules imported by RUN
PHASES = {
    "phase_kernels_rmsnorm": "chip_smoke.phase_kernels_rmsnorm(torch, F, rn)",
    "phase_kernels_flash": "chip_smoke.phase_kernels_flash(torch, F, fa)",
    "phase_kernels_moe": "chip_smoke.phase_kernels_moe(torch, F, mg)",
    "phase_kernels_scan": "chip_smoke.phase_kernels_scan(torch, F, ss)",
    "phase_kernels_quantize": ("chip_smoke.phase_kernels_quantize(torch, qt, "
                               "chip_smoke.quantize_moment_rows(chip_smoke.make_mods()))"),
    "phase_kernels_decode_attention": "chip_smoke.phase_kernels_decode_attention(torch, da)",
    "phase_grad": "chip_smoke.phase_grad(torch, rn, fa, mg, ss)",
    "phase_decode_int8": "chip_smoke.phase_decode_int8(torch, np, chip_smoke.make_mods())",
    "phase_positions": "chip_smoke.phase_positions(torch, chip_smoke.make_mods())",
    "phase_embed_decode_parity": "chip_smoke.phase_embed_decode_parity(torch, np, chip_smoke.make_mods())",
    "phase_dryrun": ("_build.build(chip_smoke.LIBRARIES); "
                     "chip_smoke.phase_dryrun(torch, np, chip_smoke.make_mods())"),
    # the mesh's ranks find the kernels built
    "phase_mesh": "_build.build(chip_smoke.LIBRARIES); chip_smoke.phase_mesh(torch, chip_smoke.make_mods())",
    "phase_mesh_decode": ("_build.build(chip_smoke.LIBRARIES); "
                          "chip_smoke.phase_mesh_decode(torch, chip_smoke.make_mods())"),
    # falcon-mamba-7b's 2-layer f32 train step, then its optimizer steps:
    # the chunked update against the whole-leaf one (in_proj and the
    # embedding in several chunks, the stacked norm in one)
    "phase_train_parity_mamba": ("_build.build(chip_smoke.LIBRARIES); mods = chip_smoke.make_mods(); "
                                 "chip_smoke.phase_train_parity(torch, np, mods, chip_smoke.MAMBA_ARCH, "
                                 "320, mods.SchedulePlan(scan_chunk=64))"),
}
# CPU tests (pytest arguments) that catch a case, run on the case's copy
TESTS = {
    "tests_ring": ["tests/test_torch_sharding.py", "-k", "ring"],
    "tests_ep": ["tests/test_torch_sharding.py", "-k", "expert_parallel"],
    "tests_mesh_step": ["tests/test_torch_distributed.py", "-k", "2x2 and falcon"],
    "tests_mesh_decode": ["tests/test_torch_mesh_decode.py"],
    "tests_dryrun": ["tests/test_torch_dryrun.py"],
    "tests_optimizer_chunks": ["tests/test_torch_optimizer_chunks.py"],
}
# the phase that must catch a fault in each file
PHASE_OF = {
    "kernels/csrc/rmsnorm.cu": "phase_kernels_rmsnorm",
    "kernels/csrc/flash_attention.cu": "phase_kernels_flash",
    "kernels/csrc/flash_attention_backward.cu": "phase_grad",
    "kernels/csrc/moe_gemm.cu": "phase_kernels_moe",
    "kernels/csrc/selective_scan.cu": "phase_kernels_scan",
    "kernels/csrc/quantize.cu": "phase_kernels_quantize",
    "kernels/csrc/decode_attention.cu": "phase_kernels_decode_attention",
    "kernels/rmsnorm.py": "phase_grad",
    "models/attention.py": "phase_decode_int8",
    "models/layers.py": "phase_positions",
}

# case -> (file under src/repro_torch, [(text, replacement), ...][,
# phase]); each text's first occurrence is replaced, which is the bf16
# kernel's where a .cu file has two
CASES = {
    "control": None,
    # query tiles from row 2048 on never visit their last kv tile: only the
    # 4096-token main-path shapes have such rows
    "flash_skip_last_kv_tile_from_row_2048": ("kernels/csrc/flash_attention.cu", [(
        "const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1);",
        "const int n_tiles = kv_tiles(Skv, block_kv, causal, q_off + q_end - 1) - (q0 >= 2048);",
    )]),
    # the accumulator of the first 8 rows of each warp (rows 0-7, 16-23, ...
    # of a warpgroup) is not rescaled when the running max grows
    "flash_alpha_not_applied_to_rows_g": ("kernels/csrc/flash_attention.cu", [(
        "          acc[4 * j + 0] *= alpha_a;\n          acc[4 * j + 1] *= alpha_a;\n",
        "",
    )]),
    # the head_dim-160 body leaves the last 32-column chunk out of Q.K^T
    # (its last two k-steps): every other head_dim is whole
    "flash_160_drops_last_column_chunk": ("kernels/csrc/flash_attention.cu", [(
        "        for (int kk = 0; kk < D / 16; ++kk) {",
        "        for (int kk = 0; kk < D / 16 - (D == 160 ? 2 : 0); ++kk) {",
    )]),
    # M-RoPE's published split with its first two sections swapped: the
    # temporal component rotates 24 frequencies and the height 16
    "mrope_sections_swapped": ("models/layers.py", [(
        "        return (16, 24, 24)  # Qwen2-VL published split",
        "        return (24, 16, 24)  # Qwen2-VL published split",
    )]),
    # the bf16 grouped GEMM never streams the slices of its last block_d step
    "moe_gemm_skip_last_block_d_step": ("kernels/csrc/moe_gemm.cu", [(
        "const int n_slices = cdiv(d, kSlice);",
        "const int n_slices = cdiv(d - block_d, kSlice);",
    )]),
    # the forward's w, stored (E,d,f) and so MN-major, is read without the
    # wgmma transpose bit (and its descriptor): as if it were K-major
    "moe_gemm_forward_w_transpose_bit_dropped": ("kernels/csrc/moe_gemm.cu", [(
        "constexpr int kTnspB = TB ? 0 : 1;",
        "constexpr int kTnspB = 0;",
    )]),
    # the backward's dw = x^T . dy reads x as stored (E,C,d) without the
    # transpose bit (and its descriptor): only dw, which the gradient phase
    # checks
    "moe_gemm_dw_reads_x_untransposed": ("kernels/csrc/moe_gemm.cu", [(
        "constexpr int kTnspA = TA;",
        "constexpr int kTnspA = 0;",
    )], "phase_grad"),
    # the scan's carry pass leaves chunk 0's end state out of the carry: the
    # second chunk starts from zero, the later ones from carries short of it
    "scan_carry_skips_chunk0_h": ("kernels/csrc/selective_scan.cu", [(
        "carry = fmaf(ex2(a2 * dtsum[(static_cast<long long>(b) * nC + c) * Di + d]), carry, states[at]);",
        "carry = fmaf(ex2(a2 * dtsum[(static_cast<long long>(b) * nC + c) * Di + d]), carry,"
        " c ? states[at] : 0.f);",
    )]),
    # the carry pass decays the carry by the previous chunk's sum(dt) (one
    # chunk late; the first chunk's by its own)
    "scan_carry_decay_one_chunk_late": ("kernels/csrc/selective_scan.cu", [(
        "carry = fmaf(ex2(a2 * dtsum[(static_cast<long long>(b) * nC + c) * Di + d]), carry, states[at]);",
        "carry = fmaf(ex2(a2 * dtsum[(static_cast<long long>(b) * nC + (c ? c - 1 : 0)) * Di + d]),"
        " carry, states[at]);",
    )]),
    # the flash backward's dK/dV takes the first q-head of each GQA group
    # only, dropping the group's sum
    "flash_backward_drops_gqa_group_sum": ("kernels/csrc/flash_attention_backward.cu", [(
        "  const int steps = groups * nq;",
        "  const int steps = nq;",
    )]),
    # the flash backward reads the forward's lse (natural log) as if it were
    # in log2 units (the dQ kernel, which hands it to the dK/dV kernel)
    "flash_backward_lse_read_as_log2": ("kernels/csrc/flash_attention_backward.cu", [
        ("la == -INFINITY ? INFINITY : la * kLog2e;", "la == -INFINITY ? INFINITY : la;"),
        ("lb == -INFINITY ? INFINITY : lb * kLog2e;", "lb == -INFINITY ? INFINITY : lb;"),
    ]),
    # the dK/dV kernel's dV += P^T.dO reads dO, stored [rows][D] and so
    # MN-major, without the wgmma transpose bit (and its descriptor): as if
    # it were K-major (at the main path's 64 rows x 64 the reads stay in the
    # tile and give dO^T)
    "flash_backward_dv_transpose_bit_dropped": ("kernels/csrc/flash_attention_backward.cu", [(
        "        product_rows<D, BQ>(adv, pa, osm);\n",
        "        for (int kk = 0; kk < BQ / 16; ++kk)\n"
        "          sm90::wgmma_rs<0>(adv, pa[kk], sm90::make_desc(osm + kk * 32, 16, 8 * K::kSpan,\n"
        "                            sm90::swizzle_code(K::kSpan)), 1);\n",
    )]),
    # the dK/dV kernel's S^T and dP^T leave out the last 32-element chunk of
    # the head dimension (their last two k-steps) at head_dim 160 only
    "flash_backward_160_dkdv_drops_last_head_chunk": ("kernels/csrc/flash_attention_backward.cu", [(
        "        product_hd<D>(st, kw, qsm);\n        product_hd<D>(dpt, vw, osm);\n",
        "        for (int kk = 0; kk < D / 16 - (D == 160 ? 2 : 0); ++kk) {\n"
        "          constexpr uint32_t swz = sm90::swizzle_code(K::kSpan);\n"
        "          sm90::wgmma_ss<0, 0>(st, sm90::make_desc(kw + kstep<D>(kk, kRows), 16, 8 * K::kSpan, swz),\n"
        "                               sm90::make_desc(qsm + kstep<D>(kk, BQ), 16, 8 * K::kSpan, swz), kk > 0);\n"
        "          sm90::wgmma_ss<0, 0>(dpt, sm90::make_desc(vw + kstep<D>(kk, kRows), 16, 8 * K::kSpan, swz),\n"
        "                               sm90::make_desc(osm + kstep<D>(kk, BQ), 16, 8 * K::kSpan, swz), kk > 0);\n"
        "        }\n",
    )]),
    # the dK/dV kernel takes each query row's Delta from its neighbour's row
    "flash_backward_delta_from_wrong_row": ("kernels/csrc/flash_attention_backward.cu", [(
        "dpt[i] = p * (dpt[i] - lsm[BQ + col]);",
        "dpt[i] = p * (dpt[i] - lsm[BQ + (col ^ 1)]);",
    )]),
    # the scan backward never folds the adjoint carried in from later
    # chunks: each chunk's walk starts from zero
    "scan_backward_skips_reverse_fold": ("kernels/csrc/selective_scan.cu", [(
        "      gn[j] = (st && c < nC - 1) ? adj[state_at(b, c + 1, n0 + j, d, nC, N, Di)] : 0.f;",
        "      gn[j] = 0.f;",
    )], "phase_grad"),
    # the scan backward's du leaves out the skip term D * gy
    "scan_backward_du_drops_d_gy": ("kernels/csrc/selective_scan.cu", [(
        "if (q == 0) in[i * kBwdCh + ch] = fmaf(dskip, gyv, r);",
        "if (q == 0) in[i * kBwdCh + ch] = r;",
    )], "phase_grad"),
    # the last level of the scan backward's transposing reduction over the
    # warp's channels drops the partner lane's half for the dB sums (lanes
    # 0-15): dB misses four of each warp's eight channels
    "scan_backward_db_reduction_drops_a_lane": ("kernels/csrc/selective_scan.cu", [(
        "  return (u4 ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, u4 ? z[0] : z[1], 4);",
        "  const float o = __shfl_xor_sync(0xffffffffu, u4 ? z[0] : z[1], 4);\n"
        "  return (u4 ? z[1] : z[0]) + ((lane & 16) ? o : 0.f);",
    )], "phase_grad"),
    # a row spread over a group of warps (d >= 4096 in bf16) normalises by
    # its own warp's sum of squares, not the group's
    "rmsnorm_group_sum_own_warp_only": ("kernels/csrc/rmsnorm.cu", [(
        "    for (int g = 0; g < G; ++g) v += s[group * G + g];\n",
        "    v = s[warp];\n",
    )]),
    # the backward's dw leaves out the last block's partial row
    "rmsnorm_backward_dw_drops_last_block": ("kernels/csrc/rmsnorm.cu", [(
        "    for (int b = sy; b < blocks; b += kDwSlices)",
        "    for (int b = sy; b < blocks - 1; b += kDwSlices)",
    )], "phase_grad"),
    # quantize rounds half away from zero (roundf) instead of half to even:
    # every regime's codes go through RowQuant::code
    "quantize_round_half_away_from_zero": ("kernels/csrc/quantize.cu", [(
        "const float r = rintf(__fdiv_rn(x, s));",
        "const float r = roundf(__fdiv_rn(x, s));",
    )]),
    # quantize multiplies by 127 / amax instead of dividing by amax / 127, in
    # every regime (row_quant and RowQuant::code)
    "quantize_scale_by_reciprocal": ("kernels/csrc/quantize.cu", [
        ("  float s;  // the row's scale\n", "  float s, inv;  // the row's scale\n"),
        ("  return RowQuant{amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f};",
         "  return RowQuant{amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f,"
         " amax > 0.f ? __fdiv_rn(127.0f, amax) : 1.0f};"),
        ("const float r = rintf(__fdiv_rn(x, s));", "const float r = rintf(x * inv);"),
    ]),
    # the cluster regime's row max leaves out the partial of the cluster's
    # first block (rows whose amax lies in the first slice get too small a
    # scale)
    "quantize_cluster_drops_first_partial": ("kernels/csrc/quantize.cu", [(
        "  for (int r = 0; r < k; ++r) m = fmaxf(m, part[r]);",
        "  for (int r = 1; r < k; ++r) m = fmaxf(m, part[r]);",
    )]),
    # the narrow regime's segmented max starts one step too wide: each row's
    # group also takes the max of its neighbour row's group (a whole-warp row
    # is unaffected: a shuffle across 32 lanes returns the lane's own value)
    "quantize_narrow_max_reads_neighbour_row": ("kernels/csrc/quantize.cu", [(
        "  for (int off = lanes >> 1; off > 0; off >>= 1)  // within the row's group only",
        "  for (int off = lanes; off > 0; off >>= 1)  // within the row's group only",
    )]),
    # the rmsnorm wrapper launches without its autograd Function: the output
    # is cut from the graph and every gradient below it is lost
    "rmsnorm_output_detached": ("kernels/rmsnorm.py", [(
        "        return RMSNormFn.apply(x, w, lambda a, b: _launch(a, b, eps, vec),\n"
        "                               lambda a, b, g: rmsnorm_backward(a, b, g, eps=eps))\n",
        "        return _launch(x, w, eps, vec)\n",
    )]),
    # the int8 KV cache writes the new row's K and V scales one position
    # early: the row at cur keeps the scale it had
    "int8_kv_scale_written_one_position_off": ("models/attention.py", [(
        '            _write_at_cur_(cache["k_s"], ks, cur, commit, o)\n'
        '            _write_at_cur_(cache["v_s"], vs, cur, commit, o)\n',
        '            _write_at_cur_(cache["k_s"], ks, cur - 1, commit, o)\n'
        '            _write_at_cur_(cache["v_s"], vs, cur - 1, commit, o)\n',
    )]),
    # the decode path quantizes the new K and V rows with the plain version,
    # on the card too
    "int8_kv_quantized_by_the_plain_version": ("models/attention.py", [
        ("from repro_torch.kernels import ops\n", "from repro_torch.kernels import ops, ref\n"),
        ("q, s = ops.quantize_int8(", "q, s = ref.quantize_int8("),
    ]),
    # musicgen's decode adds the sinusoid of the position after each row's own
    "decode_sinusoid_one_position_late": ("models/transformer.py", [(
        "    h = _embed(params, cfg, inputs, pos, par)\n    for p in range(cfg.n_periods):",
        "    h = _embed(params, cfg, inputs, pos + 1, par)\n    for p in range(cfg.n_periods):",
    )], "phase_embed_decode_parity"),
    # the int8 ring's reduce-scatter adds the chunk one hop early
    "ring_chunk_off_by_one": ("training/grad_compress.py", [(
        "c = (idx - step - 1) % n  # the chunk", "c = (idx - step) % n  # the chunk",
    )], "tests_ring"),
    # expert parallelism: every model rank runs the first E / tp experts'
    # slots, whatever its own experts are
    "ep_expert_slice_offset": ("models/moe.py", [(
        "grouped = grouped[r * E_loc:(r + 1) * E_loc]", "grouped = grouped[0:E_loc]",
    )], "tests_ep"),
    # expert parallelism: the replicated input's gradient is not summed over
    # the model ranks (no copy_to_region on entry)
    "ep_input_grad_not_reduced": ("models/moe.py", [(
        "x = ctx.enter(x, region)", "x = ctx.enter(x, region and mode != \"ep\")",
    )], "tests_ep"),
    # sequence parallelism: a block's first norm weight, used on each rank's
    # own rows, has its gradient left unsummed over the model ranks (caught
    # only by the mesh phase's leaf-by-leaf gate: Adam's first step moves an
    # element by about lr either way, inside the absolute bound of 2 lr)
    "sp_norm_grad_not_summed": ("models/transformer.py", [(
        'hn = layers.norm(h, par.w(bp, "norm1", tp=par.ctx.seq), cfg.norm)',
        'hn = layers.norm(h, par.w(bp, "norm1", tp=False), cfg.norm)',
    )], "phase_mesh"),
    # an int8 moment split on its last axis takes the row's amax over the
    # local shard: its scale is not the whole row's
    "int8_moment_amax_local": ("training/optimizer.py", [(
        "amax = cc.all_reduce_max(rows.abs().amax(dim=-1, keepdim=True), mesh, axes)",
        "amax = rows.abs().amax(dim=-1, keepdim=True)",
    )], "tests_mesh_step"),
    # a decoded token's id reaches the temporal M-RoPE component only; the
    # height and width components rotate by position 0
    "mrope_decode_id_temporal_only": ("models/attention.py", [(
        "        pos = pos[:, None, :].expand(B, 3, 1)\n",
        "        pos = torch.cat([pos[:, None, :], torch.zeros_like(pos)[:, None, :].expand(B, 2, 1)], 1)\n",
    )], "phase_embed_decode_parity"),
    # decode over a cache split by position: the partial softmaxes combined
    # under each rank's own max, with no rescale to the global one
    "mesh_decode_combine_local_max": ("sharding/collectives.py", [(
        'm = all_reduce_(lse.clone(memory_format=torch.contiguous_format), mesh, axes, "max")',
        "m = lse.clone()",
    )], ("tests_mesh_decode", "phase_mesh_decode")),
    # the plain decode attention's mask compares a rank's local position
    # with the row's global cur (the CPU path; the card runs the kernel)
    "mesh_decode_mask_local_positions": ("kernels/decode_attention.py", [(
        "t = torch.arange(o, o + L, device=q.device)  # global positions",
        "t = torch.arange(L, device=q.device)  # global positions",
    )], "tests_mesh_decode"),
    # the kernel's mask likewise: a rank's first position taken as 0
    "decode_attention_mask_local_positions": ("kernels/csrc/decode_attention.cu", [(
        "const long long lim = a.cur[a.cur_per_row ? b : 0] - a.off + 1;",
        "const long long lim = a.cur[a.cur_per_row ? b : 0] + 1;",
    )], "phase_kernels_decode_attention"),
    # the combine leaves out each row's last visible chunk
    "decode_attention_combine_drops_last_chunk": ("kernels/csrc/decode_attention.cu", [(
        "const int nv = (visible_end(a, b) + a.chunk - 1) / a.chunk;",
        "const int nv = max(1, (visible_end(a, b) + a.chunk - 1) / a.chunk - 1);",
    )], "phase_kernels_decode_attention"),
    # the new row at a shard's first position is written at the end of the
    # shard before it
    "mesh_decode_write_on_neighbour": ("models/attention.py", [(
        "hit = (at >= o) & (at < o + L)", "hit = (at > o) & (at <= o + L)",
    )], ("tests_mesh_decode", "phase_mesh_decode")),
    # Mamba's decode takes in_proj's columns as a contiguous split of [x | z]
    # (rank 0 all of x at tp 2) instead of its own channels of each half
    "mamba_decode_in_proj_whole_split": ("models/mamba.py", [(
        '        xi, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)  # (B, Di) each: this rank\'s channels\n',
        '        xz = cc.all_gather_raw(x[:, 0] @ p["in_proj"], par.mesh, "model", 1)\n'
        "        n = par.ctx.tp\n"
        "        xz = xz.reshape(xz.shape[0], n, 2, -1).transpose(1, 2).reshape(xz.shape[0], -1)\n"
        "        xi, z = xz.chunk(n, dim=-1)[par.ctx.tp_rank].chunk(2, dim=-1)\n",
    )], ("tests_mesh_decode", "phase_mesh_decode")),
    # the dry run: the flash forward's meta branch records each launch twice
    # (caught against a real step's launches, on the CPU and on the card)
    "dryrun_flash_launch_counted_twice": ("kernels/flash_attention.py", [(
        "        work.dry_launch(LAUNCHES.name, wk, plain, tile=(launch.block_q, launch.block_kv))\n",
        "        work.dry_launch(LAUNCHES.name, wk, plain, tile=(launch.block_q, launch.block_kv))\n"
        "        work.dry_launch(LAUNCHES.name, wk, plain, tile=(launch.block_q, launch.block_kv))\n",
    )], ("tests_dryrun", "phase_dryrun")),
    # an all-gather counted at one rank more than its group: its wire bytes
    # (caught by the ring formulas and the pinned records of the CPU tests)
    "collective_group_size_off_by_one": ("sharding/collectives.py", [(
        '    _count("all-gather", src, n)', '    _count("all-gather", src, n + 1)',
    )], "tests_dryrun"),
    # work.py's flash forward counts 2·D operations a visible pair, not 4·D
    # (caught by the CPU tests' bounds and the card's bound columns)
    "work_flash_operations_halved": ("kernels/work.py", [(
        "    return Work(4 * D * visible_pairs(Sq, Skv, causal) * B * Hq, nbytes, dtype)",
        "    return Work(2 * D * visible_pairs(Sq, Skv, causal) * B * Hq, nbytes, dtype)",
    )], ("tests_dryrun", "phase_kernels_flash")),
    # the weight decay read from one index of a chunk (``pc[0]``, the rank a
    # loop over periods would see) instead of the whole leaf's: a stacked
    # norm leaf (n_periods, d) loses its decay (so does a 2-D embedding)
    "optimizer_decay_from_chunk_rank": ("training/optimizer.py", [(
        "            if decay:\n", "            if pc[0].ndim >= 2:\n",
    )], ("tests_optimizer_chunks", "phase_train_parity_mamba")),
    # an int8 moment chunk's scales taken from the rows of the next chunk
    # (where the next chunk is as long): its codes are read and written
    # against another chunk's scales
    "optimizer_moment_scales_one_chunk_off": ("training/optimizer.py", [(
        '        return {"q": m["q"][index], "s": m["s"][index]}',
        '        shift = index.stop - index.start\n'
        '        nxt = slice(index.stop, index.stop + shift)\n'
        '        return {"q": m["q"][index],\n'
        '                "s": m["s"][nxt if nxt.stop <= m["s"].shape[0] else index]}',
    )], ("tests_optimizer_chunks", "phase_train_parity_mamba")),
}

RUN = """
import sys
sys.path.insert(0, "src")
import numpy as np
import torch, torch.nn.functional as F
import chip_smoke
from repro_torch.kernels import decode_attention as da, flash_attention as fa, moe_gemm as mg
from repro_torch.kernels import quantize as qt, rmsnorm as rn, selective_scan as ss
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
{call}
"""


def _phases(edit) -> list:
    """The checks that must catch a case: one, or a tuple of a CPU test run
    and a card phase, each run where it can (``_runnable``)."""
    p = edit[2] if len(edit) > 2 else PHASE_OF[edit[0]]
    return [q for q in p if _runnable(q)] if isinstance(p, tuple) else [p]


def _runnable(phase: str) -> bool:
    """CPU tests need JAX (the reference) and are not run with ``--card``; a
    card phase needs the CUDA toolkit."""
    if phase in TESTS:
        return not CARD_ONLY and importlib.util.find_spec("jax") is not None
    return shutil.which("nvcc") is not None or os.path.exists("/usr/local/cuda/bin/nvcc")


def run_case(base: Path, name: str, edit, cases: dict) -> dict:
    work = base / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src", work / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
    if any(p in TESTS for c in cases.values() if c is not None for p in _phases(c)):
        shutil.copytree(ROOT / "tests", work / "tests", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(ROOT / "pyproject.toml", work / "pyproject.toml")
    phases = sorted({p for c in cases.values() if c is not None for p in _phases(c)})
    if edit is not None:
        rel, pairs = edit[:2]
        path = work / PORT / rel
        text = path.read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: the text to edit is not in {path.name}")
            text = text.replace(old, new, 1)
        path.write_text(text)
        phases = _phases(edit)
        if not phases:
            raise RuntimeError(f"{name}: none of its checks can run on this machine")
    failure, passes = [], []
    for phase in phases:
        if phase in TESTS:
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *TESTS[phase]],
                cwd=work, capture_output=True, text=True, timeout=900,
                env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("FAILED")]
            if proc.returncode not in (0, 1) or (proc.returncode == 1 and not lines):
                raise RuntimeError(f"{name}: the {phase} tests did not run:\n{proc.stdout[-4000:]}")
            passes.append(proc.returncode == 0)
            failure += lines
            continue
        proc = subprocess.run([sys.executable, "-c", RUN.format(call=PHASES[phase])],
                              cwd=work, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("AssertionError")]
        if proc.returncode != 0 and not lines:
            raise RuntimeError(f"{name}: the {phase} phase did not run:\n{proc.stderr[-4000:]}")
        passes.append(proc.returncode == 0)
        failure += lines
    # the control must pass every check; a mutant must fail every one
    ok = all(passes) if edit is None else not any(passes)
    return {"case": name, "phases": phases, "phase_passed": passes,
            "caught": failure[-1] if failure else None, "as_expected": ok}


CARD_ONLY = False


def main() -> int:
    global CARD_ONLY
    if "--card" in sys.argv:
        CARD_ONLY = True
        sys.argv.remove("--card")
    if len(sys.argv) < 2 or any(n not in CASES for n in sys.argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(sys.argv[1]).resolve()
    if base == ROOT or ROOT in base.parents:
        print(f"{base} lies inside the checkout; give a directory outside it", file=sys.stderr)
        return 2
    names = sys.argv[2:]
    cases = {n: e for n, e in CASES.items() if not names or n == "control" or n in names}
    ok = True
    for name, edit in cases.items():
        row = run_case(base, name, edit, cases)
        ok &= row["as_expected"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
