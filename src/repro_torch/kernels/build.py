"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` has a C launcher, and `csrc/launch.cuh` makes its
library the Python extension module `repro_kernel_<name>`, whose `launch`
converts its arguments to the launcher's parameter types and returns the
launcher's cudaError_t.  At first use a source is compiled with `nvcc` for
Hopper (`sm_90a`) against Python's C headers (not PyTorch's, so it builds in
seconds) into a shared library under `build/torch_kernels/` at the root of
the checkout (or under `$REPRO_TORCH_BUILD_DIR`), named by a hash of its
source, the shared headers (`csrc/*.cuh`) and the interpreter's ABI so an
edited source is rebuilt, and imported.  Nothing here runs on import: the
CPU tests import every module on machines without `nvcc`.

The launch path that all eight wrappers share is kept cheap, because the
serving steps are bound by the host: `cuda_index` finds the tensors' device
from integers, `stream_of` reads the raw current stream, the module's
`launch` converts the arguments in C, and each launcher takes the device
index and makes it current itself, so no wrapper enters a device context.
A launch stays safe to capture in a CUDA graph: no host sync, outputs from
PyTorch's allocator, and the kernel on the current stream.
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import ModuleType

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)

_lock = threading.Lock()
_libs: dict[str, ModuleType] = {}
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
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    abi = sysconfig.get_config_var("EXT_SUFFIX") or ""
    tag = hashlib.sha256(src + " ".join((*ARCH_FLAGS, abi)).encode()
                         ).hexdigest()[:12]
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
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           f"-I{sysconfig.get_paths()['include']}", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()  # staticcheck: allow(wall-clock)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0  # staticcheck: allow(wall-clock)
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


def load_library(name: str) -> ModuleType:
    """The extension module of `csrc/<name>.cu` (`launch`, `error_string`),
    built and imported at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            module = f"repro_kernel_{name}"
            loader = importlib.machinery.ExtensionFileLoader(
                module, str(compile_library(name)))
            lib = importlib.util.module_from_spec(
                importlib.util.spec_from_loader(module, loader))
            loader.exec_module(lib)
            _libs[name] = lib
        return _libs[name]


def check(lib: ModuleType, code: int, what: str) -> None:
    """Raise when a launcher returned an error from cudaGetLastError()."""
    if code != 0:
        msg = lib.error_string(code)
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # as the launchers read
SMEM_LIMIT = 232448    # bytes of shared memory one Hopper block may use


def dtype_code(what: str, t: torch.Tensor) -> int:
    """The launchers' code of a tensor's type; raises for any other type."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what} must be float32 or bfloat16, not {t.dtype}")
    return code


def cuda_index(*tensors: torch.Tensor) -> int:
    """The index of the CUDA device that all `tensors` lie on, or -1 when they
    all lie on the CPU; raises when they lie on several devices or on one
    of another type.  Compares integers, so a launch pays no set of
    `torch.device`s."""
    first = tensors[0]
    index, on_cuda = first.get_device(), first.is_cuda
    for t in tensors[1:]:
        if t.get_device() != index or t.is_cuda != on_cuda:
            raise ValueError(f"inputs lie on several devices: "
                             f"{sorted({str(t.device) for t in tensors})}")
    if on_cuda:
        return index
    devices = {t.device.type for t in tensors}
    if devices != {"cpu"}:
        raise ValueError(f"no kernel for tensors on {sorted(devices)}")
    return -1


def stream_of(index: int) -> int:
    """The current CUDA stream of device `index`, as the launchers take it:
    the stream a CUDA graph captures while it records."""
    # private, but the only call that skips building a torch.cuda.Stream
    # (what torch.cuda.current_stream(index).cuda_stream does every call);
    # PyTorch's own generated kernels launch through it
    return torch._C._cuda_getCurrentRawStream(index)
