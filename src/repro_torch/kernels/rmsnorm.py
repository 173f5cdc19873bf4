"""Fused RMSNorm: the wrapper of the CUDA kernel `csrc/rmsnorm.cu`, which
replaces the JAX package's Pallas kernel `repro/kernels/rmsnorm.py:rmsnorm_fwd`.

A CPU tensor goes to the plain version (`repro_torch.kernels.ref.rmsnorm_ref`);
a CUDA tensor goes to the kernel, or the wrapper raises.
`rmsnorm_fwd.launches` counts the kernel's launches, and nothing else.
`variant` says which of the kernel's two paths a call takes: "vector" (one
pass, 16-byte loads, the row in registers) where D is a multiple of 16
bytes' worth of x, at most 2048 such vectors, and x and scale are 16-byte
aligned; "scalar" for every other row.

The kernel computes the TPU kernel's function, `x * rsqrt(mean(x^2) + eps)
* scale` in float32, rounded once to x's type. The model's plain rmsnorm
(`repro_torch.models.layers.rmsnorm`) rounds `x * rsqrt(...)` to x's type
before it multiplies by `scale`, so in bfloat16 the two may differ by one
rounding of the output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check, cuda_index, dtype_code,
                                       load_library, stream_of)
from repro_torch.kernels.ref import rmsnorm_ref


MAX_VECTORS = 2048   # 16-byte vectors of a row on the vector path
                     # (csrc/rmsnorm.cu: kMaxThreads x kVecs)


def _vector(d: int, itemsize: int, pointers: int) -> bool:
    """Whether rows of `d` values of `itemsize` bytes take the vector path;
    `pointers` is x's and scale's addresses or-ed together."""
    per_vector = 16 // itemsize
    return d % per_vector == 0 and d <= MAX_VECTORS * per_vector and \
        pointers % 16 == 0


def variant(x: torch.Tensor, scale: torch.Tensor) -> str:
    """The kernel path a contiguous ``x`` and ``scale`` take: "vector" or
    "scalar" (see the module's docstring)."""
    return "vector" if _vector(x.shape[-1], x.element_size(),
                               x.data_ptr() | scale.data_ptr()) else "scalar"


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """``x``: (..., D); ``scale``: (D,) -> (..., D) in x's type.  On CUDA,
    x and scale must be contiguous, each float32 or bfloat16."""
    shape = x.shape
    if not shape or scale.shape != shape[-1:]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    index = cuda_index(x, scale)
    if index < 0:
        return rmsnorm_ref(x, scale, eps)
    x_code = dtype_code("x", x)
    s_code = dtype_code("scale", scale)
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    out = torch.empty_like(x)
    d = shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    xp, sp = x.data_ptr(), scale.data_ptr()
    lib = load_library("rmsnorm")
    code = lib.launch(xp, sp, out.data_ptr(), rows, d, eps, x_code, s_code,
                      _vector(d, x.element_size(), xp | sp), index,
                      stream_of(index))
    check(lib, code, "rmsnorm")
    rmsnorm_fwd.launches += 1
    return out


rmsnorm_fwd.launches = 0
