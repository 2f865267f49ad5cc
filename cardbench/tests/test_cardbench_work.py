"""The frozen work formulas against the program's, at both cells' shapes,
and the model counts written out."""
import pytest

from cardbench import bench, work

FALCON = bench.load_json(bench.HERE / "configs" / "falcon-mamba-7b.json")["sizes"]
GRANITE = bench.load_json(bench.HERE / "configs" / "granite-moe-1b-a400m.json")["sizes"]
CALLS = [  # (kernel, arguments) at the cells' shapes
    ("selective_scan", (1, 4096, 8192, 16, "bfloat16")),
    ("selective_scan_backward", (1, 4096, 8192, 16, "bfloat16")),
    ("rmsnorm", (4096 * 4096, 4096, "bfloat16")),
    ("rmsnorm_backward", (4096 * 4096, 4096, "bfloat16")),
    ("quantize_int8", (64 * 4096, 16384, "float32")),
    ("dequantize_int8", (64 * 4096, 16384, "float32")),
    ("rmsnorm", (16 * 1, 1024, "bfloat16")),
    ("quantize_int8", (16 * 8, 64, "bfloat16")),
    ("moe_gemm", (32, 8, 1024, 512, "bfloat16")),
    ("moe_gemm", (32, 8, 512, 1024, "bfloat16")),
    ("flash_attention", (1, 16, 8, 4096, 4096, 64, "bfloat16", True, True)),
    ("flash_attention_backward", (1, 16, 8, 4096, 4096, 64, "bfloat16", True)),
]


@pytest.mark.parametrize("name,args", CALLS)
def test_cardbench_frozen_work_equals_the_programs(name, args):
    from repro_torch.kernels import work as program

    mine, theirs = getattr(work, name)(*args), getattr(program, name)(*args)
    assert (mine.flops, mine.bytes, mine.ops_dtype) == (theirs.flops, theirs.bytes, theirs.ops_dtype)
    peaks = {"bfloat16": work.PEAK_BF16, "float32": work.PEAK_F32}
    ms, by = program.bound_ms(theirs, work.HBM_BYTES_PER_S, peaks)
    assert work.bound_s(mine) == (pytest.approx(ms / 1e3), by)


def test_cardbench_falcon_mamba_train_flops_written_out():
    per_layer = 4096 * 16384 + 4 * 8192 + 8192 * (256 + 32) + 256 * 8192 + 8192 * 4096
    full = dict(FALCON, n_layers=64)
    assert work.matmul_params(full) == 64 * per_layer + 65024 * 4096 == 6_996_099_072
    assert work.matmul_params(FALCON) == FALCON["n_layers"] * per_layer + 65024 * 4096
    assert work.train_flops(FALCON, 4096) == 6 * work.matmul_params(FALCON) * 4096


def test_cardbench_matmul_params_against_the_programs_leaves():
    """The leaves of two or more axes a period that enter a product, from the
    program's declared shapes (routers and A_log left out: no product)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    import dataclasses

    for arch, sizes in (("falcon-mamba-7b", FALCON), ("granite-moe-1b-a400m", GRANITE)):
        cfg = dataclasses.replace(get_config(arch), n_layers=sizes["n_layers"])
        shapes = transformer.param_shapes(cfg)
        n = 0
        for block in shapes["blocks"].values():
            for part in block.values():
                if not isinstance(part, dict):
                    continue
                for leaf, shape in part.items():
                    if len(shape) >= 3 and leaf not in ("A_log",):
                        count = 1
                        for x in shape:
                            count *= x
                        n += count
        head = shapes["embed"] if cfg.tie_embeddings else shapes["head"]
        n += head[0] * head[1]
        assert work.matmul_params(sizes) == n, arch


def test_cardbench_granite_decode_work_written_out():
    positions = [20_000] * 16
    wk = work.decode_work(GRANITE, positions, "int8")
    per_position = 2 * 8 * 64 + 2 * 8 * 4  # K and V codes, their f32 scales
    cache = 24 * per_position * (16 * 20_001 + 16)
    weights = work.weight_bytes(GRANITE, "bfloat16")
    assert wk.bytes == weights + cache + 16 * 49155 * 2
    active = 24 * (1024 * 2048 + 1024 * 1024 + 1024 * 32 + 3 * 1024 * 512 * 8) + 49155 * 1024
    assert wk.flops == 2 * active * 16 + 24 * 4 * 64 * 16 * 16 * 20_001
    assert 2.6e9 < weights < 2.7e9
