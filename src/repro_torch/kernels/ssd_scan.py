"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel `csrc/ssd_scan.cu`,
which replaces the JAX package's Pallas kernel
`repro/kernels/ssd_scan.py:ssd_scan`.

A CPU tensor goes to the plain version (`repro_torch.kernels.ref.ssd_scan_ref`,
the per-token recurrence); a CUDA tensor goes to the kernel, or the wrapper
raises.  `ssd_scan.launches` counts the kernel's launches, and nothing else.

The kernel computes the TPU kernel's function, extended by what
`models.ssm.mamba2_block` needs: an optional float32 initial state in, and
the final state out.  The TPU kernel zeroes its state at the first chunk and
never writes it out (`ssd_scan.py:24-26`); with no initial state the output
here is its function.

Two kernels take a CUDA call, and `variant` names the one, openly by shape
and alignment, before the launch: "tiled" (`ssd_scan_kernel_tiled`, a block
per slab of 32 columns of P; in bfloat16 every product on tensor cores,
the float32 operand of each split into bf16 hi and lo parts; in float32
register tiles on CUDA cores) for float32 and bfloat16 with L <= 64,
N <= 64, P and N whole 16-byte runs of elements and x, B and C on the
16-byte grid, which every serving call is, the model's slices of its conv
output included; "old" (`ssd_scan_kernel`, a block per head) for every
other call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (SMEM_LIMIT, check, cuda_index,
                                       dtype_code, load_library, stream_of)
from repro_torch.kernels.ref import ssd_scan_ref


MAX_L = MAX_N = 64      # the tiled kernel's kMaxL and kMaxN


def smem_bytes(P: int, N: int, L: int) -> int:
    """Shared memory of one block of the old kernel, as
    `csrc/ssd_scan.cu:smem_floats`: the (P, N+1) state, the (L, P) x*dt
    tile, the (L, N+1) B and C tiles, the (L, L) score tile and three
    vectors of L."""
    return 4 * (P * (N + 1) + L * P + 2 * L * (N + 1) + L * L + 3 * L)


def variant(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
            chunk: int = 64) -> str:
    """The kernel a CUDA call on float32 or bfloat16 ``x`` (B, S, H, P) and
    ``Bm``, ``Cm`` (B, S, N) runs: "tiled" or "old" (see the module's
    docstring)."""
    size = x.element_size()
    P, N, L = x.shape[3], Bm.shape[2], min(chunk, x.shape[1])
    if L > MAX_L or N > MAX_N or (P * size) % 16 or (N * size) % 16:
        return "old"
    strides = (*x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2])
    if any((st * size) % 16 for st in strides):
        return "old"
    if (x.data_ptr() | Bm.data_ptr() | Cm.data_ptr()) % 16:
        return "old"
    return "tiled"


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64,
             initial_state: torch.Tensor | None = None):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,N) shared across
    heads; initial_state: float32 (B,H,P,N) or None (zeros) ->
    (y (B,S,H,P) in x's type, float32 final state (B,H,P,N)).

    S must be a multiple of the chunk ``L = min(chunk, S)``, as in the
    reference.  On CUDA: x, Bm and Cm float32 or bfloat16 of one type with
    their last axis contiguous (any other strides, so the model's slices of
    its conv output pass without a copy); dt, A and the state float32."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) or \
            tuple(Bm.shape[:2]) != (Bsz, S):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (Bsz, H, P, N):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is not "
                         f"{(Bsz, H, P, N)}")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"S={S} is not a multiple of the chunk {L}")
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    if initial_state is not None:
        tensors["initial_state"] = initial_state
    index = cuda_index(*tensors.values())
    if index < 0:
        return ssd_scan_ref(x, dt, A, Bm, Cm, initial_state)
    code = dtype_code("x", x)
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, B, C types differ: {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    for name in ("dt", "A", "initial_state"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if min(x.stride(-1), Bm.stride(-1), Cm.stride(-1)) != 1 or not \
            A.is_contiguous() or (initial_state is not None and
                                  not initial_state.is_contiguous()):
        raise ValueError("x, B and C need a contiguous last axis; A and "
                         "initial_state must be contiguous")
    route = variant(x, Bm, Cm, chunk)
    if route == "old" and smem_bytes(P, N, L) > SMEM_LIMIT:
        raise ValueError(f"P={P}, N={N}, L={L} need more shared memory than "
                         f"a block has")
    if x.numel() == 0 or N == 0:
        raise ValueError("ssd_scan needs B, S, H, P and N >= 1")
    if Bsz > 65535:
        raise ValueError(f"at most 65535 batches, not {Bsz}")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 10)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        dt.stride(2), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    s0 = None if initial_state is None else initial_state.data_ptr()
    lib = load_library("ssd_scan")
    err = lib.launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), s0, y.data_ptr(), s_out.data_ptr(),
        ctypes.addressof(strides), Bsz, S, H, P, N, L, code,
        int(route == "tiled"), index,
        stream_of(index))
    check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, s_out


ssd_scan.launches = 0
