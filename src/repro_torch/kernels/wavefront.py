"""FCFS wavefront serialization: the wrapper of the CUDA kernel
`csrc/wavefront.cu`, which replaces the JAX package's Pallas kernel
`repro/kernels/wavefront.py:serialize_prefix`.

A CPU tensor goes to the plain version (`repro_torch.kernels.ref`); a CUDA
tensor goes to the kernel, or the wrapper raises.  `serialize_prefix.launches`
counts the kernel's launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check, cuda_index, load_library,
                                       stream_of)
from repro_torch.kernels.ref import serialize_prefix_ref


def serialize_prefix(free0: torch.Tensor, release: torch.Tensor,
                     dur: torch.Tensor):
    """``free0``: (..., R); ``release``/``dur``: (..., R, W) float32 ->
    ``(finish (..., R, W), new_free (..., R))``.  Leading axes are flattened
    to queue rows.  On CUDA the three inputs must be contiguous float32 on one
    device (the kernel reads (rows, W) row-major)."""
    if release.shape != dur.shape or release.shape[:-1] != free0.shape:
        raise ValueError(
            f"shapes disagree: free0 {tuple(free0.shape)}, release "
            f"{tuple(release.shape)}, dur {tuple(dur.shape)}")
    if release.shape[-1] == 0:
        raise ValueError("serialize_prefix needs at least one item per row")
    index = cuda_index(free0, release, dur)
    if index < 0:
        return serialize_prefix_ref(free0, release, dur)
    for name, t in (("free0", free0), ("release", release), ("dur", dur)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    w = release.shape[-1]
    rows = release.numel() // w
    fin = torch.empty_like(release)
    new_free = torch.empty_like(free0)
    if rows == 0:
        return fin, new_free
    lib = load_library("wavefront")
    code = lib.launch(
        free0.data_ptr(), release.data_ptr(), dur.data_ptr(), fin.data_ptr(),
        new_free.data_ptr(), rows, w, index, stream_of(index))
    check(lib, code, "serialize_prefix")
    serialize_prefix.launches += 1
    return fin, new_free


serialize_prefix.launches = 0
