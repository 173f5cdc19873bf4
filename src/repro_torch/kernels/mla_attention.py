"""MLA's causal prefill attention: the wrapper of the CUDA kernel
`csrc/mla_attention.cu`, which replaces no Pallas kernel (the JAX
package's MLA prefill is its plain blocked attention on keys of
qk_nope + qk_rope columns and values of v_dim, which its flash kernel
cannot take).

A CPU tensor goes to the plain version
(`repro_torch.kernels.ref.mla_attention_ref`); a CUDA tensor goes to the
kernel, or the wrapper raises.  `variant` names the route openly, by dtype,
widths and alignment: "mma" (`mla_attention_kernel_mma`, bf16 tensor
cores) for bfloat16 tensors of widths the kernel is compiled for
(`WIDTHS`), every B, H and S|T stride a multiple of 8 elements and the four
inputs 16-byte aligned; "plain" for every other call, which the wrapper
refuses on the card and the model (`models.attention.mla_attention`) sends
to its blocked attention on per-head keys instead.
`mla_attention_fwd.launches` counts the kernel's launches, and nothing
else.  While a profiler records, the kernel counts the pairs of 64
query rows and 64 keys it computes and skips above the diagonal, from
shapes (`attn.mla_tiles`, `attn.mla_tiles_skipped`).

The kernel and its plain version round p once to bf16 (v's type) before
the P V product and normalise after it, as the reference's blocked
attention does (`repro/models/layers.py:156-158`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, cuda_index, load_library, \
    stream_of
from repro_torch.kernels.ref import mla_attention_ref
from repro_torch.obs.realtime import device_tracer

# (qk_nope, qk_rope, v_dim) the kernel is compiled for: DeepSeek-V2's, and
# the reduced MLA configs' (`configs.reduce_config`)
WIDTHS = ((128, 64, 128), (32, 16, 32))
TILE = 64               # query rows and keys of a counted tile pair


def variant(q: torch.Tensor, kn: torch.Tensor, kr: torch.Tensor,
            v: torch.Tensor) -> str:
    """The route of a CUDA call (see the module's docstring): "mma" or
    "plain"."""
    if any(t.dtype != torch.bfloat16 for t in (q, kn, kr, v)):
        return "plain"
    if (kn.shape[-1], kr.shape[-1], v.shape[-1]) not in WIDTHS:
        return "plain"
    if any(s % 8 for t in (q, kn, v) for s in t.stride()[:3]) or \
            kr.stride(0) % 8 or kr.stride(1) % 8 or \
            any(t.stride(-1) != 1 for t in (q, kn, kr, v)):
        return "plain"
    if (q.data_ptr() | kn.data_ptr() | kr.data_ptr() | v.data_ptr()) % 16:
        return "plain"
    return "mma"


def tile_pairs(S: int, T: int) -> tuple[int, int]:
    """(computed, skipped) pairs of 64 query rows and 64 keys in one call:
    rows 64i .. 64i + 63 read the key tiles up to their last row's key,
    min(T, 64 (i + 1)) (the kernel's warps, 32 rows each, skip the same).

        >>> tile_pairs(4096, 4096)
        (2080, 2016)
        >>> tile_pairs(65, 65), tile_pairs(1, 1)
        ((3, 1), (1, 0))
    """
    nq, nk = -(-S // TILE), -(-T // TILE)
    tri = min(nq, nk)
    computed = tri * (tri + 1) // 2 + (nq - tri) * nk
    return computed, nq * nk - computed


def mla_attention_fwd(q: torch.Tensor, kn: torch.Tensor, kr: torch.Tensor,
                      v: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Causal attention of ``q`` (B, S, H, qk_nope + qk_rope) over keys
    whose first qk_nope columns are ``kn`` (B, T, H, qk_nope) and whose last
    qk_rope are ``kr`` (B, T, qk_rope), one for every head, and values ``v``
    (B, T, H, v_dim): (B, S, H, v_dim) in q's type.  The scores' factor is
    ``scale`` (MLA's: YaRN's temperature over sqrt(qk_nope + qk_rope)),
    which the kernel takes only positive; the mask is aligned top-left
    (query i sees keys j <= i)."""
    if q.dim() != 4 or kn.dim() != 4 or kr.dim() != 3 or v.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}, kn {tuple(kn.shape)}, "
                         f"kr {tuple(kr.shape)}, v {tuple(v.shape)}")
    B, S, H, DQ = q.shape
    T = kn.shape[1]
    if kn.shape[:3] != (B, T, H) or v.shape[:3] != (B, T, H) or \
            kr.shape[:2] != (B, T) or DQ != kn.shape[3] + kr.shape[2]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, kn "
                         f"{tuple(kn.shape)}, kr {tuple(kr.shape)}, v "
                         f"{tuple(v.shape)}")
    index = cuda_index(q, kn, kr, v)
    if index < 0:
        return mla_attention_ref(q, kn, kr, v, scale=scale)
    if variant(q, kn, kr, v) == "plain":
        raise ValueError(
            f"the kernel takes bfloat16 at widths {WIDTHS}, strides of 8 "
            f"elements and 16-byte aligned inputs, not {q.dtype} at "
            f"{(kn.shape[3], kr.shape[2], v.shape[3])}: route such a call "
            "to the blocked attention")
    if q.numel() == 0 or T == 0:
        raise ValueError("mla_attention needs B, S, T and H >= 1")
    if B > 65535 or H > 65535:
        raise ValueError(f"at most 65535 batches and heads, not {B}, {H}")
    if not scale > 0:
        raise ValueError(f"the kernel takes a scale > 0, not {scale}")
    out = q.new_empty((B, S, H, v.shape[3]))
    strides = (ctypes.c_int64 * 14)(
        q.stride(0), q.stride(2), q.stride(1), kn.stride(0), kn.stride(2),
        kn.stride(1), v.stride(0), v.stride(2), v.stride(1), out.stride(0),
        out.stride(2), out.stride(1), kr.stride(0), kr.stride(1))
    lib = load_library("mla_attention")
    err = lib.launch(
        q.data_ptr(), kn.data_ptr(), kr.data_ptr(), v.data_ptr(),
        out.data_ptr(), ctypes.addressof(strides), B, H, S, T, kn.shape[3],
        kr.shape[2], v.shape[3], float(scale), index, stream_of(index))
    check(lib, err, "mla_attention")
    mla_attention_fwd.launches += 1
    tr = device_tracer()
    pairs = tile_pairs(S, T)
    tr.count("attn.mla_tiles", pairs[0])
    tr.count("attn.mla_tiles_skipped", pairs[1])
    return out


mla_attention_fwd.launches = 0
