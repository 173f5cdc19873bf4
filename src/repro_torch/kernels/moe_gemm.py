"""Grouped expert GEMM (capacity layout): the wrapper of the CUDA kernel
`csrc/moe_gemm.cu`, which replaces the JAX package's Pallas kernel
`repro/kernels/moe_gemm.py:moe_gemm`.

A CPU tensor goes to the plain version (`repro_torch.kernels.ref.moe_gemm_ref`);
a CUDA tensor goes to the kernel, or the wrapper raises.
`moe_gemm.launches` counts the kernel's launches, and nothing else.

Two kernels take a CUDA call, and `variant` names the one, openly by dtype,
shape and alignment: "mma" (`moe_gemm_kernel_mma`, bf16 tensor cores fed by
a cp.async weight stream) for bfloat16 with K and N multiples of 8 and x
and w 16-byte aligned, which the serving path always is; "fma"
(`moe_gemm_kernel_fma`, CUDA cores, any C, K and N) for float32 and every
other bfloat16 call.  Both sum in float32 and round the output once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check, cuda_index, dtype_code,
                                       load_library, stream_of)
from repro_torch.kernels.ref import moe_gemm_ref


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a call on ``x`` (E, C, K) and ``w`` (E, K, N) of one type
    runs: "mma" or "fma" (see the module's docstring)."""
    if x.dtype == torch.bfloat16 and x.shape[2] % 8 == 0 and \
            w.shape[2] % 8 == 0 and (x.data_ptr() | w.data_ptr()) % 16 == 0:
        return "mma"
    return "fma"


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, K); w: (E, K, N) -> (E, C, N) in x's type, with float32
    sums.  On CUDA both contiguous, float32 or bfloat16 of one type."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    E, C, K = x.shape
    N = w.shape[2]
    index = cuda_index(x, w)
    if index < 0:
        return moe_gemm_ref(x, w)
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
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    lib = load_library("moe_gemm")
    err = lib.launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, K, N,
                     code, variant(x, w) == "mma", index, stream_of(index))
    check(lib, err, "moe_gemm")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
