"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  At first use it is compiled
with `nvcc` for Hopper (`sm_90a`) into a shared library under
`build/torch_kernels/` at the root of the checkout (or under
`$REPRO_TORCH_BUILD_DIR`), named by a hash of its source so an edited source
is rebuilt, and loaded with `ctypes`.  Nothing here runs on import: the CPU
tests import every module on machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}   # name -> wall time of its nvcc run
ptxas_info: dict[str, str] = {}        # name -> what `nvcc -Xptxas -v` said


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def compile_library(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built; returns
    the library's path.  Safe to run for several sources at once."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    ptxas_info[name] = proc.stderr
    os.replace(tmp, out)
    return out


def sources() -> list[str]:
    """Names of every kernel source under `csrc/`."""
    return sorted(f.stem for f in CSRC.glob("*.cu"))


def build_all() -> dict[str, Path]:
    """Compile every kernel source, one `nvcc` per source, all at once."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(compile_library, names)))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(compile_library(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned an error from cudaGetLastError()."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # as the launchers read
SMEM_LIMIT = 232448    # bytes of shared memory one Hopper block may use


def dtype_code(what: str, t: torch.Tensor) -> int:
    """The launchers' code of a tensor's type; raises for any other type."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what} must be float32 or bfloat16, not {t.dtype}")
    return code


def one_device(**tensors: torch.Tensor) -> torch.device:
    """The device all `tensors` lie on; raises when they lie on several."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    return devices.pop()


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of `device`, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream
