"""RWKV6 WKV chunked scan: the wrapper of the CUDA kernel
`csrc/rwkv6_scan.cu`, which replaces the JAX package's Pallas kernel
`repro/kernels/rwkv6_scan.py:rwkv6_scan`.

A CPU tensor goes to the plain version
(`repro_torch.kernels.ref.rwkv6_scan_ref`, the per-token recurrence); a
CUDA tensor goes to the kernel, or the wrapper raises.
`rwkv6_scan.launches` counts the kernel's launches, and nothing else.

The kernel computes the TPU kernel's function, extended as the SSD scan is
(`repro_torch.kernels.ssd_scan`): an optional float32 initial state in and
the final state out, which `models.rwkv.rwkv6_time_mix` carries.  Both
CUDA kernels clip logw to [LOGW_MIN, 0] as they read it, as the TPU
kernel's wrapper does before its launch (`rwkv6_scan.py:69`); the wrapper
passes the caller's float32 logw as it is.

Two kernels take a CUDA call, and `variant` names the one, openly by shape
and alignment, before the launch: "tiled" (`rwkv6_scan_kernel_tiled`, a
block per slab of 32 columns of V, the score tile's exponentials
factored by sub-chunk; o and the state update on tensor cores in bfloat16,
register tiles on CUDA cores in float32) for float32 and bfloat16 with L a
multiple of 8 up to 32, K <= 64, K and V whole 16-byte runs of elements
and r, k, v and logw on the 16-byte grid, which every serving call is;
"old" (`rwkv6_scan_kernel`, a block per head) for every other call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (SMEM_LIMIT, check, cuda_index,
                                       dtype_code, load_library, stream_of)
from repro_torch.kernels.ref import rwkv6_scan_ref

LOGW_MIN = -6.0  # per-step log-decay clamp (numerical guard, documented)
MAX_L, MAX_K, SUB = 32, 64, 8   # the tiled kernel's kMaxL, kMaxK, kSub


def smem_bytes(K: int, V: int, L: int) -> int:
    """Shared memory of one block of the old kernel, as
    `csrc/rwkv6_scan.cu:smem_floats`: six (L, K+1) tiles (r, k, cum,
    cum_ex, r_dec, k_dec), the (L, V) values, the (K, V) state, the (L, L)
    scores and the bonus vector of L."""
    return 4 * (6 * L * (K + 1) + L * V + K * V + L * L + L)


def variant(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, chunk: int = 32) -> str:
    """The kernel a CUDA call on contiguous float32 or bfloat16 ``r``,
    ``k`` (B, S, H, K), ``v`` (B, S, H, V) and float32 ``logw`` runs:
    "tiled" or "old" (see the module's docstring)."""
    size = r.element_size()
    K, V, L = r.shape[3], v.shape[3], min(chunk, r.shape[1])
    if L > MAX_L or L % SUB or K > MAX_K or (K * size) % 16 or \
            (V * size) % 16:
        return "old"
    if (r.data_ptr() | k.data_ptr() | v.data_ptr() | logw.data_ptr()) % 16:
        return "old"
    return "tiled"


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 32,
               initial_state: torch.Tensor | None = None):
    """r, k, logw: (B,S,H,K); v: (B,S,H,V); u: (H,K); initial_state:
    float32 (B,H,K,V) or None (zeros) -> (o (B,S,H,V) in r's type, float32
    final state (B,H,K,V)).

    S must be a multiple of the chunk ``L = min(chunk, S)``, as in the
    reference.  On CUDA: r, k, v contiguous, float32 or bfloat16 of one
    type; logw, u and the state float32 and contiguous."""
    if r.dim() != 4 or r.shape != k.shape or r.shape != logw.shape or \
            v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"shapes: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logw {tuple(logw.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)} is not {(H, K)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (B, H, K, V):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is not "
                         f"{(B, H, K, V)}")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"S={S} is not a multiple of the chunk {L}")
    tensors = dict(r=r, k=k, v=v, logw=logw, u=u)
    if initial_state is not None:
        tensors["initial_state"] = initial_state
    index = cuda_index(*tensors.values())
    if index < 0:
        return rwkv6_scan_ref(r, k, v, logw, u, initial_state)
    code = dtype_code("r", r)
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v types differ: {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name in ("logw", "u", "initial_state"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("r, k, v, logw, u and initial_state must be "
                         "contiguous")
    route = variant(r, k, v, logw, chunk)
    if route == "old" and smem_bytes(K, V, L) > SMEM_LIMIT:
        raise ValueError(f"K={K}, V={V}, L={L} need more shared memory than "
                         f"a block has")
    if r.numel() == 0 or V == 0:
        raise ValueError("rwkv6_scan needs B, S, H, K and V >= 1")
    if B > 65535:
        raise ValueError(f"at most 65535 batches, not {B}")
    o = torch.empty((B, S, H, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    s0 = None if initial_state is None else initial_state.data_ptr()
    lib = load_library("rwkv6_scan")
    err = lib.launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0, o.data_ptr(), s_out.data_ptr(), B, S, H, K, V, L,
        code, int(route == "tiled"), index, stream_of(index))
    check(lib, err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return o, s_out


rwkv6_scan.launches = 0
