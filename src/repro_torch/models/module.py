"""Minimal pure-functional parameter system (the JAX package's
`repro/models/module.py` over torch tensors).

Params are nested dicts of tensors. Every model declares a *spec tree* of
`ParamSpec(shape, dtype, axes, init)` where `axes` are the reference's
logical sharding axes (kept as layout notes: the port runs on one card);
`init_from_specs` materializes real tensors on a device.

Leaves are visited in sorted-key order, as `jax.tree.flatten` visits dicts,
so leaf `i` here is leaf `i` there.  The random streams still differ
(`torch.Generator` is not `jax.random`): parity tests carry the reference's
weights across with `repro_torch.interop.params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.vectorized import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Any = torch.bfloat16
    axes: tuple[str | None, ...] | None = None   # logical sharding per dim
    init: str = "normal"                          # normal | zeros | ones
    scale: float | None = None                    # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply `fn` to every leaf of a nested dict (dict nodes are rebuilt in
    sorted-key order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (`jax.tree.leaves`)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as `like` holding `leaves` in sorted-key order (the
    inverse of `tree_leaves`, `jax.tree.unflatten`)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init_from_specs(specs, generator_or_seed, device=None,
                    dtype_override=None):
    """Materialize a spec tree into parameter tensors on `device`.

    `generator_or_seed` is a `torch.Generator` on that device or an int seed
    for a fresh one.  Normal leaves draw float32 normals on the device, scale
    them by `spec.scale` or 1/sqrt(fan_in) and cast (`module.py:41-56` of the
    reference); zeros and ones draw nothing.  `device=None` means CUDA and
    raises without it.
    """
    dev = resolve_device(device)
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator_or_seed))

    def make(spec: ParamSpec) -> torch.Tensor:
        dtype = dtype_override or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[0] if len(spec.shape) == 1 else \
            math.prod(spec.shape[:-1])
        scale = spec.scale if spec.scale is not None else \
            1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(scale).to(dtype)

    return tree_map(make, specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in tree_leaves(specs)))


def stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """Stack a per-layer spec along a leading layer axis."""
    axes = (None,) + spec.axes if spec.axes is not None else None
    return dataclasses.replace(spec, shape=(n,) + spec.shape, axes=axes)


def stack_specs(specs, n: int):
    return tree_map(lambda s: stacked(s, n), specs)
