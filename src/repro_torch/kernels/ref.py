"""Plain PyTorch versions of the port's kernels: the ground truth each CUDA
kernel is held against, and what a wrapper runs on CPU tensors.

The prefix ops keep the JAX package's shift-doubling order
(`repro/kernels/ref.py`), so float32 sums associate as the reference's do.
"""
from __future__ import annotations

import torch

NEG = -1e30


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by shift-doubling."""
    k = 1
    w = x.shape[-1]
    while k < w:
        pad = x.new_zeros(x.shape[:-1] + (k,))
        x = x + torch.cat([pad, x[..., :-k]], dim=-1)
        k *= 2
    return x


def prefix_max(x: torch.Tensor, identity: float = NEG) -> torch.Tensor:
    """Inclusive prefix max over the last axis by shift-doubling."""
    k = 1
    w = x.shape[-1]
    while k < w:
        pad = x.new_full(x.shape[:-1] + (k,), identity)
        x = torch.maximum(x, torch.cat([pad, x[..., :-k]], dim=-1))
        k *= 2
    return x


def serialize_prefix_ref(free0: torch.Tensor, release: torch.Tensor,
                         dur: torch.Tensor):
    """FCFS prefix-serialization of independent resources over ordered items.

    ``free0``: (..., R) — time each resource becomes available; ``release``/
    ``dur``: (..., R, W) — per-item earliest start and occupancy duration on
    its resource, in FCFS service order along the last axis. Implements the
    queue recurrence ``f_k = max(f_{k-1}, r_k) + d_k`` (``f_0 = free0``) in
    closed form: with ``S_k = cumsum(d)`` the recurrence unrolls to
    ``f_k = S_k + max(free0, cummax_k(r_k - S_{k-1}))``. Items not on a
    resource are encoded as ``d = 0, r = -1e30``. Returns ``(finish (..., R,
    W), new_free (..., R))``.
    """
    s = prefix_sum(dur)
    g = release - (s - dur)
    run = torch.maximum(prefix_max(g), free0[..., None])
    fin = s + run
    return fin, fin[..., -1]
