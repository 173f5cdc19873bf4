"""Fused RMSNorm: the wrapper of the CUDA kernel `csrc/rmsnorm.cu`, which
replaces the JAX package's Pallas kernel `repro/kernels/rmsnorm.py:rmsnorm_fwd`.

A CPU tensor goes to the plain version (`repro_torch.kernels.ref.rmsnorm_ref`);
a CUDA tensor goes to the kernel, or the wrapper raises.
`rmsnorm_fwd.launches` counts the kernel's launches, and nothing else.

The kernel computes the TPU kernel's function, `x * rsqrt(mean(x^2) + eps)
* scale` in float32, rounded once to x's type. The model's plain rmsnorm
(`repro_torch.models.layers.rmsnorm`) rounds `x * rsqrt(...)` to x's type
before it multiplies by `scale`, so in bfloat16 the two may differ by one
rounding of the output.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import (check, dtype_code, load_library,
                                       one_device, stream_of)
from repro_torch.kernels.ref import rmsnorm_ref


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its launcher typed."""
    lib = load_library("rmsnorm")
    fn = lib.repro_rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """``x``: (..., D); ``scale``: (D,) -> (..., D) in x's type.  On CUDA,
    x and scale must be contiguous, each float32 or bfloat16."""
    if x.dim() == 0 or tuple(scale.shape) != tuple(x.shape[-1:]):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    device = one_device(x=x, scale=scale)
    if device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if device.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for {device.type}")
    x_code = dtype_code("x", x)
    s_code = dtype_code("scale", scale)
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        code = lib.repro_rmsnorm(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), rows, d, eps, x_code,
                                 s_code, stream_of(device))
    check(lib, code, "rmsnorm")
    rmsnorm_fwd.launches += 1
    return out


rmsnorm_fwd.launches = 0
