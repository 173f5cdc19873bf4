"""Production meshes, the JAX package's `repro/launch/mesh.py` over
`torch.distributed`: one rank is one device.

Single pod: 16x16 = 256 chips (data x model).
Multi-pod:  2x16x16 = 512 chips (pod x data x model) — the 'pod' axis is pure
data parallelism across pods (gradient all-reduce crosses the inter-pod
links once per step); 'model' carries tensor/expert parallelism inside a pod.

Defined as FUNCTIONS so importing this module never touches the process
group.  A mesh covers the world of the initialised default process group
(`torch.distributed.init_process_group`, which the caller makes: nothing
here tells a program of a cluster), or one rank when there is none.
`device_type` is "cuda" unless the caller asks for "cpu" (the gloo tests
do).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding.rules import Mesh


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def production_layout(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: (16, 16) ("data",
    "model"), or (2, 16, 16) ("pod", "data", "model") with `multi_pod`."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """The `production_layout` mesh over the world's ranks.  Raises
    ValueError when the world is not 256 (512) ranks, as the reference's
    `jax.make_mesh` does with too few devices; `Mesh.abstract` of the same
    layout needs no ranks (the dry run's)."""
    shape, axes = production_layout(multi_pod)
    n, world = 1, world_size()
    for s in shape:
        n *= s
    if world != n:
        raise ValueError(
            f"Number of devices {world} must be >= the product of "
            f"mesh_shape {shape} (one rank a device; the production mesh "
            f"takes exactly {n})")
    return Mesh(shape, axes, device_type=device_type)


def make_host_mesh(model_parallel: int = 1, *,
                   device_type: str = "cuda") -> Mesh:
    """A mesh over whatever ranks exist (smoke tests / examples)."""
    n = world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    return Mesh((n // mp, mp), ("data", "model"), device_type=device_type)
