"""The kernels' shared launch path and the Python half of their dispatch, on
the CPU: which device a call goes to, which variant of a kernel runs for
which dtype, shape and alignment, and what the launchers' libraries are
built from.  The kernels themselves are held on the card by
`tests/test_torch_cuda.py`.  Also the training entry point
(`repro_torch.launch.train`) on the CPU: its log in the reference's
format, its resume from a checkpoint, its refusal of a multi-device mesh,
and `zoo.input_specs` against the reference's for every config and shape
kind."""
import os
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as moe
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import rwkv6_scan as rwkv
from repro_torch.kernels import ssd_scan as ssd

WRAPPERS = ["wavefront", "rmsnorm", "decode_attention", "flash_attention",
            "ssd_scan", "rwkv6_scan", "moe_gemm", "mla_attention"]


def _at_offset(shape, dtype, offset):
    """A contiguous tensor that starts `offset` elements into its storage."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def test_cuda_index_of_cpu_tensors_is_minus_one():
    a, b = torch.ones(3), torch.ones(2, 2)
    assert build.cuda_index(a) == -1
    assert build.cuda_index(a, b, a) == -1


@pytest.mark.parametrize("other", ["meta", "meta-only"])
def test_cuda_index_refuses_other_devices(other):
    meta = torch.empty(3, device="meta")
    tensors = (meta,) if other == "meta-only" else (torch.ones(3), meta)
    with pytest.raises(ValueError, match="meta"):
        build.cuda_index(*tensors)


@pytest.mark.parametrize("E,C,K,N", [(64, 8, 2048, 1408),
                                     (64, 60, 2048, 1408),
                                     (64, 8, 1408, 2048),
                                     (64, 60, 1408, 2048), (2, 1, 64, 48),
                                     (2, 65, 64, 48)])
def test_moe_gemm_serving_shapes_in_bf16_take_the_tensor_cores(E, C, K, N):
    x = torch.zeros(E, C, K, dtype=torch.bfloat16)
    w = torch.zeros(E, K, N, dtype=torch.bfloat16)
    assert moe.variant(x, w) == "mma"


@pytest.mark.parametrize("case", ["float32", "k-ragged", "n-ragged",
                                  "x-misaligned", "w-misaligned"])
def test_moe_gemm_other_calls_take_the_cuda_cores(case):
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    K = 33 if case == "k-ragged" else 64
    N = 65 if case == "n-ragged" else 48
    x = _at_offset((2, 8, K), dtype, int(case == "x-misaligned"))
    w = _at_offset((2, K, N), dtype, int(case == "w-misaligned"))
    assert moe.variant(x, w) == "fma"


def _model_heads(B, S, H, D, dtype=torch.bfloat16, offset=0):
    """(B, H, S, D) as the model passes it: a transposed view of its
    (B, S, H, D) activations or cache, `offset` elements into storage."""
    return _at_offset((B, S, H, D), dtype, offset).transpose(1, 2)


# (B, S = T, Hq, Hkv, D) of the serving paths' attention layers
SERVING_ATTENTION = {"llama3.2-3b": (4, 128, 24, 8, 128),
                     "deepseek-moe-16b": (4, 128, 16, 16, 128),
                     "zamba2-2.7b": (4, 128, 32, 32, 80)}


@pytest.mark.parametrize("arch", sorted(SERVING_ATTENTION))
@pytest.mark.parametrize("S", [1, 65, 128])
def test_flash_attention_serving_shapes_in_bf16_take_the_tensor_cores(arch,
                                                                      S):
    B, _, Hq, Hkv, D = SERVING_ATTENTION[arch]
    q = _model_heads(B, S, Hq, D)
    k, v = _model_heads(B, S, Hkv, D), _model_heads(B, S, Hkv, D)
    assert fa.variant(q, k, v) == "mma"


@pytest.mark.parametrize("case", ["float32", "d40", "d136", "q-misaligned",
                                  "k-misaligned", "v-misaligned"])
def test_flash_attention_other_calls_take_the_cuda_cores(case):
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    D = {"d40": 40, "d136": 136}.get(case, 128)
    q, k, v = (_model_heads(2, 64, H, D, dtype, int(case == f"{n}-misaligned"))
               for n, H in (("q", 24), ("k", 8), ("v", 8)))
    assert fa.variant(q, k, v) == "fma"


@pytest.mark.parametrize("arch", sorted(SERVING_ATTENTION))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_serving_shapes_take_the_split_kernel(arch, dtype):
    B, S, Hq, Hkv, D = SERVING_ATTENTION[arch]
    q = torch.zeros(B, 1, Hq, D, dtype=dtype)[:, 0]
    k = _model_heads(B, S + 40, Hkv, D, dtype)     # the max_len 168 cache
    v = _model_heads(B, S + 40, Hkv, D, dtype)
    assert dec.variant(q, k, v) == "split"


@pytest.mark.parametrize("case", ["d36", "k-misaligned", "v-misaligned",
                                  "f32-odd-stride"])
def test_decode_attention_other_calls_take_the_head_kernel(case):
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    D = 36 if case == "d36" else 128
    q = torch.zeros(4, 24, D, dtype=dtype)
    k = _model_heads(4, 168, 8, D, dtype, int(case == "k-misaligned"))
    v = _model_heads(4, 168, 8, D, dtype, int(case == "v-misaligned"))
    if case == "f32-odd-stride":       # T rows 130 floats apart
        v = torch.zeros(4, 8, 168, 130, dtype=dtype)[..., :128]
    assert dec.variant(q, k, v) == "head"


def _ssd_operands(B, S, H, P, N, dtype=torch.bfloat16, x_offset=0):
    """x, B and C as the model passes them: slices of one (B, S, H P + 2N)
    conv output, x `x_offset` elements further into its storage."""
    conv = _at_offset((B, S, H * P + 2 * N + x_offset), dtype, 0)
    x = conv[..., x_offset:x_offset + H * P].reshape(B, S, H, P)
    return x, conv[..., H * P:H * P + N], conv[..., H * P + N:H * P + 2 * N]


# (B, S, H, P, N, chunk) of zamba2-2.7b's prefill and of the card tests'
# grid, each with the kernel its bfloat16 call runs: L, P and N off the
# tensor cores' 16 and P off the slab of 32 pad with zeros on the tiled route
SSD_SHAPES = [((4, 128, 80, 64, 64, 64), "tiled"),
              ((2, 64, 5, 64, 64, 64), "tiled"),
              ((1, 128, 2, 32, 16, 32), "tiled"),
              ((2, 64, 3, 16, 8, 16), "tiled"),
              ((1, 48, 2, 8, 8, 8), "tiled"),
              ((2, 72, 3, 48, 24, 24), "tiled"),
              ((1, 80, 2, 80, 40, 40), "tiled"),
              ((1, 32, 1, 8, 4, 8), "old")]       # N = 4: 8 bytes a row

# Shared memory of one block of each tiled kernel, by the layouts of
# `csrc/ssd_scan.cu:TiledSmem` and `csrc/rwkv6_scan.cu:TiledSmem`, whatever
# the shape; the sources hold their own layouts to the same limits by
# static_assert at build time, and these mirrors to the sources' constants
# by `test_tiled_scan_constants_agree_with_the_sources`.
SLAB = 32              # both kernels' kSlab


def ssd_tiled_smem_bytes(itemsize: int) -> int:
    """Two stages of the x slab, B and C (rows padded by 16 bytes) and dt;
    then, in float32, x dt, G^T and the state slab; in bfloat16 (x rows
    padded by 16 bytes too), x dt exp(cum_L - cum) and the state slab, each
    as bf16 hi and lo parts; and three float vectors of L."""
    max_l = max_n = ssd.MAX_L
    if itemsize == 4:
        ld, xl = max_n + 4, SLAB
        rest = 4 * (max_l * SLAB + max_l * (max_l + 4) + SLAB * (max_n + 4))
    else:
        ld, xl = max_n + 8, SLAB + 8
        rest = 2 * (2 * max_l * xl + 2 * SLAB * ld)
    stage = (max_l * xl + 2 * max_l * ld) * itemsize + 4 * max_l
    return 2 * stage + rest + 4 * 3 * max_l


def rwkv_tiled_smem_bytes(itemsize: int) -> int:
    """r and k (rows padded by 16 bytes), float32 logw (its cumsum), two
    stages of the v slab, the float32 r and k factors, 2^cum_L and the
    bonus; then, in float32, k 2^(cum_L - cum), r 2^cum_ex, A^T and the
    state slab; in bfloat16 (v rows padded by 16 bytes), r 2^cum_ex, A and
    the state slab as bf16 hi and lo parts (k 2^(cum_L - cum) reuses the
    factors' room)."""
    max_l, max_k = rwkv.MAX_L, rwkv.MAX_K
    ld, n_sub = max_k + 4, max_l // rwkv.SUB
    kf_rows = 4 * n_sub * (n_sub - 1)
    ld_t = max_k + 16 // itemsize
    vl = SLAB if itemsize == 4 else SLAB + 8
    shared = 2 * max_l * ld_t * itemsize + 4 * max_l * ld + \
        2 * max_l * vl * itemsize + 4 * (max_l * ld + kf_rows * ld + max_k +
                                         max_l)
    if itemsize == 4:
        return shared + 4 * (2 * max_l * ld + max_l * (max_l + 4) +
                             max_k * (SLAB + 4))
    return shared + 2 * 2 * (max_l * ld_t + max_l * (max_l + 8) + max_k * vl)


@pytest.mark.parametrize("shape,route", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_routes_by_shape_and_alignment(shape, route, dtype):
    B, S, H, P, N, chunk = shape
    x, Bm, Cm = _ssd_operands(B, S, H, P, N, dtype)
    if dtype == torch.float32:
        route = "tiled"                # N = 4 floats are 16 bytes
    assert ssd.variant(x, Bm, Cm, chunk) == route
    smem = ssd_tiled_smem_bytes(x.element_size()) \
        if route == "tiled" else ssd.smem_bytes(P, N, min(chunk, S))
    assert smem <= build.SMEM_LIMIT


@pytest.mark.parametrize("case", ["chunk-128", "n-96", "p-ragged", "x-misaligned",
                                  "b-misaligned", "odd-stride"])
def test_ssd_scan_off_grid_calls_take_the_old_kernel(case):
    B, S, H, P, N = 2, 128, 4, 64, 64
    chunk = 128 if case == "chunk-128" else 64
    N = 96 if case == "n-96" else N
    P = 60 if case == "p-ragged" else P
    x, Bm, Cm = _ssd_operands(B, S, H, P, N, x_offset=int(case == "x-misaligned"))
    if case == "b-misaligned":
        Bm = _at_offset((B, S, N), torch.bfloat16, 1)
    if case == "odd-stride":       # rows of C 65 elements apart
        Cm = torch.zeros(B, S, N + 1, dtype=torch.bfloat16)[..., :N]
    assert ssd.variant(x, Bm, Cm, chunk) == "old"


@pytest.mark.parametrize("itemsize", [2, 4])
def test_ssd_scan_tiled_blocks_fit_the_sm(itemsize):
    # a block's shared memory fits the limit whatever the shape; in bf16
    # three blocks share an SM (228 KB, 1 KB of each block reserved)
    smem = ssd_tiled_smem_bytes(itemsize)
    assert smem <= build.SMEM_LIMIT
    if itemsize == 2:
        assert 3 * (smem + 1024) <= 228 * 1024


def _rwkv_operands(B, S, H, K, V, dtype=torch.bfloat16, offset=0):
    r, k = (_at_offset((B, S, H, K), dtype, offset) for _ in range(2))
    v = _at_offset((B, S, H, V), dtype, 0)
    return r, k, v, torch.zeros(B, S, H, K)


# (B, S, H, K, V, chunk) of rwkv6-3b's prefill and of the card tests' grid:
# L off the tensor cores' 16, K off 16 and V off the slab of 32 included
RWKV_SHAPES = [(4, 128, 40, 64, 64, 32), (2, 64, 3, 64, 32, 32),
               (1, 96, 2, 32, 16, 32), (2, 64, 3, 16, 16, 16),
               (1, 32, 1, 8, 8, 8), (2, 72, 3, 64, 48, 24),
               (1, 64, 2, 40, 80, 16)]


@pytest.mark.parametrize("shape", RWKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_serving_and_grid_shapes_take_the_tiled_kernel(shape,
                                                                 dtype):
    B, S, H, K, V, chunk = shape
    assert rwkv.variant(*_rwkv_operands(B, S, H, K, V, dtype), chunk) == \
        "tiled"
    assert rwkv_tiled_smem_bytes(torch.tensor([], dtype=dtype).element_size()) \
        <= build.SMEM_LIMIT


@pytest.mark.parametrize("case", ["chunk-64", "chunk-20", "k-96", "v-ragged",
                                  "r-misaligned", "logw-misaligned"])
def test_rwkv6_scan_off_grid_calls_take_the_old_kernel(case):
    B, S, H, K, V = 2, 128, 4, 64, 64
    chunk = {"chunk-64": 64, "chunk-20": 20}.get(case, 32)
    K = 96 if case == "k-96" else K
    V = 60 if case == "v-ragged" else V
    S = 120 if case == "chunk-20" else S
    r, k, v, logw = _rwkv_operands(B, S, H, K, V,
                                   offset=int(case == "r-misaligned"))
    if case == "logw-misaligned":
        logw = _at_offset((B, S, H, K), torch.float32, 1)
    assert rwkv.variant(r, k, v, logw, chunk) == "old"


@pytest.mark.parametrize("itemsize", [2, 4])
def test_rwkv6_scan_tiled_blocks_fit_the_sm(itemsize):
    smem = rwkv_tiled_smem_bytes(itemsize)
    assert smem <= build.SMEM_LIMIT
    if itemsize == 2:
        assert 3 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("name,mirror", [("ssd_scan", ssd), ("rwkv6_scan", rwkv)])
def test_tiled_scan_constants_agree_with_the_sources(name, mirror):
    # the wrappers' routing and this file's shared memory mirrors use the
    # kernel's constants
    src = (build.CSRC / f"{name}.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k(?:MaxL|MaxN|MaxK|Sub|Slab)) = (\d+);", src)}
    assert consts["kMaxL"] == mirror.MAX_L
    assert consts.get("kMaxN", consts.get("kMaxK")) == \
        getattr(mirror, "MAX_N", getattr(mirror, "MAX_K", None))
    assert consts["kSlab"] == SLAB
    if name == "rwkv6_scan":
        assert consts["kSub"] == mirror.SUB
        assert "kLogwMin = -6.0f" in src and mirror.LOGW_MIN == -6.0


@pytest.mark.parametrize("name", ["moe_gemm", "flash_attention",
                                  "mla_attention"])
def test_the_tensor_core_helpers_live_in_one_header(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "mma.cuh"' in src
    assert "asm volatile" not in src and "repro::mma_bf16" in src
    assert "mma.sync" in (build.CSRC / "mma.cuh").read_text()


@pytest.mark.parametrize("name", WRAPPERS)
def test_no_launcher_sets_shared_memory_on_every_launch(name):
    # repro::SmemLimit raises a kernel's limit once per device
    src = (build.CSRC / f"{name}.cu").read_text()
    assert "cudaFuncSetAttribute" not in src


@pytest.mark.parametrize("d", [64, 96, 2048, 2560, 3072, 5120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_aligned_rows_take_the_vector_path(d, dtype, scale_dtype):
    x = torch.zeros(4, d, dtype=dtype)
    assert rms.variant(x, torch.zeros(d, dtype=scale_dtype)) == "vector"


@pytest.mark.parametrize("case", ["ragged-bf16", "ragged-f32", "x-misaligned",
                                  "scale-misaligned", "too-long"])
def test_rmsnorm_other_rows_take_the_scalar_path(case):
    d = {"ragged-bf16": 100, "ragged-f32": 98,
         "too-long": 8 * rms.MAX_VECTORS + 8}.get(case, 3072)
    dtype = torch.float32 if case == "ragged-f32" else torch.bfloat16
    x = _at_offset((2, d), dtype, int(case == "x-misaligned"))
    s = _at_offset((d,), dtype, int(case == "scale-misaligned"))
    assert rms.variant(x, s) == "scalar"


def test_library_tag_covers_the_shared_header(tmp_path, monkeypatch):
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("rmsnorm")
    with open(tmp_path / "launch.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path("rmsnorm") != before


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_launcher_takes_the_device_and_shares_the_header(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "launch.cuh"' in src
    sig = re.search(r"\nint repro_\w+\(([^)]*)\)", src).group(1)
    assert re.sub(r"\s+", " ", sig).endswith("int device, void* stream")
    assert "repro::DeviceGuard guard(device);" in src


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_library_is_the_python_module_its_loader_imports(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    launcher = re.search(r"\nint (repro_\w+)\(", src).group(1)
    # load_library imports `repro_kernel_<name>`, whose init function the
    # macro names after its first argument
    assert src.rstrip().endswith(f"REPRO_PY_MODULE({name}, {launcher})")
    assert src.index('#include "launch.cuh"') < src.index("#include <")


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_wrapper_takes_the_shared_launch_path(name):
    src = (build.CSRC.parent / f"{name}.py").read_text()
    assert "cuda_index(" in src and "stream_of(index)" in src
    assert f'load_library("{name}")' in src and "lib.launch(" in src
    assert "torch.cuda.device(" not in src
    assert "current_stream(" not in src


# ---------------------------------------------------------------------------
# the training entry point
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--layers", "2", "--d-model", "64", "--seq", "32",
         "--batch", "4", "--device", "cpu"]
STEP_LINE = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{3})  "
                       r"lr (\d\.\d\de[+-]\d\d)  \((\d+\.\d\d)s/10steps\)$")


def _train(argv, capsys):
    from repro_torch.launch import train
    params = train.main(argv)
    return params, capsys.readouterr().out.splitlines()


def test_launch_train_runs_and_logs_as_the_reference(capsys):
    params, out = _train(SMOKE + ["--steps", "3"], capsys)
    # the reference logs its mesh beside the arch; the port also its device
    assert out[0] == "arch=llama3.2-3b-smoke device=cpu " \
        "mesh={'data': 1, 'model': 1}"
    steps = [STEP_LINE.match(line) for line in out[1:-1]]
    assert all(steps), out
    assert [int(m.group(1)) for m in steps] == [0, 2]
    assert all(float(m.group(2)) > 0 for m in steps)
    assert out[-1] == "done"
    assert params["embed"].shape == (2048, 64)
    assert all(bool(torch.isfinite(p).all())
               for p in params["layers"]["mixer"].values())


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.train import checkpoint as ckpt
    if ckpt.zstandard is None:
        pytest.skip("optional 'zstandard' not installed (checkpoints)")
    ckdir = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _, first = _train(SMOKE + ["--steps", "3"] + ckdir, capsys)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    assert not any(line.startswith("resumed") for line in first)
    _, out = _train(SMOKE + ["--steps", "5"] + ckdir, capsys)
    assert out[1] == "resumed from step 3"
    assert [int(STEP_LINE.match(line).group(1)) for line in out[2:-1]] == [4]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_launch_train_refuses_a_production_mesh():
    """One process is a world of one rank: the (16, 16) production mesh
    raises the reference's error for too few devices (launch.serve too)."""
    from repro_torch.launch import serve, train
    for main, argv in ((train.main, SMOKE), (serve.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="must be >= the product of "
                           r"mesh_shape \(16, 16\)"):
            main(argv + ["--production-mesh"])


def test_input_specs_match_the_reference():
    """Every config x shape kind: the same arguments, shapes and dtypes as
    the reference's ShapeDtypeStructs, as meta tensors (no storage)."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.models import zoo as ref_zoo

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.models import zoo
    for arch in REF_ARCHS:
        for shape in REF_SHAPES:
            got = zoo.input_specs(ARCHS[arch], SHAPES[shape])
            want = ref_zoo.input_specs(REF_ARCHS[arch], REF_SHAPES[shape])
            assert sorted(got) == sorted(want), (arch, shape)
            for k, spec in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(spec.shape), (arch, k)
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(spec.dtype), (arch, shape, k)
