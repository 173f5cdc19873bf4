"""The kernels' shared launch path and the Python half of their dispatch, on
the CPU: which device a call goes to, which variant of a kernel runs for
which dtype, shape and alignment, and what the launchers' libraries are
built from.  The kernels themselves are held on the card by
`tests/test_torch_cuda.py`."""
import re

import pytest
import torch

from repro_torch.kernels import build
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
