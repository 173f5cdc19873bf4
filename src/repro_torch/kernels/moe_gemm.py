"""Grouped expert GEMM (capacity layout): the wrapper of the CUDA kernel
`csrc/moe_gemm.cu`, which replaces the JAX package's Pallas kernel
`repro/kernels/moe_gemm.py:moe_gemm`.

A CPU tensor goes to the plain version (`repro_torch.kernels.ref.moe_gemm_ref`);
a CUDA tensor goes to the kernel, or the wrapper raises.
`moe_gemm.launches` counts the kernel's launches, and nothing else.
The kernel takes any C, K and N.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import (check, dtype_code, load_library,
                                       one_device, stream_of)
from repro_torch.kernels.ref import moe_gemm_ref


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its launcher typed."""
    lib = load_library("moe_gemm")
    fn = lib.repro_moe_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, K); w: (E, K, N) -> (E, C, N) in x's type, with float32
    sums.  On CUDA both contiguous, float32 or bfloat16 of one type."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    E, C, K = x.shape
    N = w.shape[2]
    device = one_device(x=x, w=w)
    if device.type == "cpu":
        return moe_gemm_ref(x, w)
    if device.type != "cuda":
        raise ValueError(f"no moe_gemm kernel for {device.type}")
    code = dtype_code("x", x)
    if w.dtype != x.dtype:
        raise TypeError(f"x and w types differ: {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if min(E, C, K, N) == 0:
        raise ValueError("moe_gemm needs E, C, K and N >= 1")
    if E > 65535 or max(C, K, N) >= 2 ** 31:
        raise ValueError(f"at most 65535 experts and 2**31 - 1 rows, "
                         f"columns and depth, not {tuple(x.shape)}, {N}")
    out = torch.empty((E, C, N), dtype=x.dtype, device=device)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.repro_moe_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 E, C, K, N, code, stream_of(device))
    check(lib, err, "moe_gemm")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
