"""The kernels' shared launch path and the Python half of their dispatch, on
the CPU: which device a call goes to, which variant of a kernel runs for
which dtype, shape and alignment, and what the launchers' libraries are
built from.  The kernels themselves are held on the card by
`tests/test_torch_cuda.py`."""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as moe
from repro_torch.kernels import rmsnorm as rms

WRAPPERS = ["wavefront", "rmsnorm", "decode_attention", "flash_attention",
            "ssd_scan", "rwkv6_scan", "moe_gemm"]


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


@pytest.mark.parametrize("name", ["moe_gemm", "flash_attention"])
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
