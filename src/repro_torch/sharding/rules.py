"""Logical-axis -> mesh-axis sharding rules, the JAX package's
`repro/sharding/rules.py` over `torch.distributed`.

Models annotate params/activations with logical axes; the rules map them to
mesh axes with divisibility fallback (an axis that does not divide evenly is
replicated rather than producing an invalid sharding). Mesh axes:

  'pod'   outer data-parallel axis across pods (2 pods in the multi-pod mesh)
  'data'  data parallel within a pod
  'model' tensor/expert parallel (heads / d_ff / experts / vocab)

`DEFAULT_RULES` and `spec_for` are the reference's, line for line.  The
port has its own stand-ins for `jax.sharding`: `PartitionSpec` (a tuple of
per-dimension entries), `Mesh` (axis names and sizes over the ranks of the
default process group, one rank a device, with a `DeviceMesh` and a
process group for every set of axes) and `NamedSharding` (a mesh and a
spec; its `placements` are the `DTensor` placements, `Shard(dim)` or
`Replicate()` per mesh axis, and `shard` cuts this rank's block out of a
whole tensor).  Where JAX keeps global arrays and lets GSPMD place them,
the port's tensors are this rank's blocks: `shard_tree` cuts a whole tree
by its shardings, `gather_tree` puts it back together, and `constrain`
cuts a tensor that every rank holds whole down to its block.  A world of
one rank needs no process group: its mesh has sizes 1 and every
collective is skipped.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

# logical axis -> mesh axis (tuples = combined mesh axes)
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,            # sequence replicated by default (SP variants remap)
    "seq_model": "model",   # sequence-parallel residual stream (beyond-paper opt)
    "kv_seq": "model",      # decode KV cache sharded along sequence (split-KV)
    "embed": "data",        # FSDP/ZeRO-3: params 2D-sharded (data x model);
                            # GSPMD all-gathers weights per layer
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,       # kv heads often < TP degree; seq dim shards instead
    "mlp": "model",         # d_ff
    "expert": "model",
    "layers": None,
    "state": None,
}


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: one entry per leading tensor dimension,
    each None (replicated), a mesh axis name or a tuple of names (the dim
    split over their product, major to minor); trailing Nones are dropped.

        >>> PartitionSpec("data", None)[0], len(PartitionSpec())
        ('data', 0)
    """

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_of(entry) -> tuple[str, ...]:
    """A spec entry as a tuple of mesh axis names (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A logical mesh over the ranks of the default process group (or over
    one rank when there is none): `axis_names`, `devices` (the global
    ranks laid out in the mesh's shape, as `jax.sharding.Mesh.devices`
    holds devices) and `shape` ({axis: size}).  `device_type` is where
    this rank's tensors live ("cuda" or "cpu"); `device_mesh` is the
    `torch.distributed.device_mesh.DeviceMesh` over the same ranks (None
    without a process group).

    Every rank must build the same meshes in the same order: building one
    creates a process group for each set of two or more axes (a
    collective call over the world), besides the device mesh's one group
    per axis.  `Mesh.abstract` lays a mesh out without ranks behind it,
    for layout arithmetic alone (`spec_for`, block shapes); its collectives
    raise, except while a dry-run recorder is attached as its `recorder`
    (`repro_torch.analysis.hlo.Recorder`), which logs each one
    and returns an empty tensor of the output's shape.

        >>> m = Mesh((1, 1), ("data", "model"), device_type="cpu")
        >>> m.shape, m.size(("data", "model")), m.index("data")
        ({'data': 1, 'model': 1}, 1, 0)
    """

    def __init__(self, shape, axis_names, *, device_type: str = "cuda"):
        shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {self.axis_names}")
        n = math.prod(shape)
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        if n != world:
            raise ValueError(
                f"a {shape} mesh needs {n} ranks; the world has {world}")
        self.device_type = device_type
        self.recorder = None
        self.devices = np.arange(n).reshape(shape)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = dist.get_rank() if on else 0
        coords = np.unravel_index(self.rank, shape)
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self.device_mesh = None
        self._groups: dict[tuple[str, ...], object] = {}
        if not on:
            return
        from torch.distributed.device_mesh import DeviceMesh
        self.device_mesh = DeviceMesh(device_type, torch.as_tensor(
            self.devices), mesh_dim_names=self.axis_names)
        for name in self.axis_names:
            self._groups[(name,)] = self.device_mesh.get_group(name)
        for k in range(2, len(shape) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[axes] = self._new_groups(axes)

    @classmethod
    def abstract(cls, shape, axis_names, *, device_type: str = "cuda"):
        """A mesh of `shape` seen from rank 0, with no process group: its
        specs and block shapes are the real mesh's; it runs no
        collective.

            >>> Mesh.abstract((16, 16), ("data", "model")).size("data")
            16
        """
        self = cls.__new__(cls)
        self.axis_names = tuple(axis_names)
        self.device_type = device_type
        self.recorder = None
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = 0
        self.coords = {a: 0 for a in self.axis_names}
        self.device_mesh = None
        self._groups = {}
        return self

    def _new_groups(self, axes):
        """One process group per block of ranks that differ only along
        `axes` (each group's ranks in the axes' row-major order); returns
        the one holding this rank."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(self.devices.ndim) if d not in dims]
        blocks = np.transpose(self.devices, rest + dims).reshape(
            -1, self.size(axes))
        mine = None
        for ranks in blocks:
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = group
        return mine

    def _norm(self, axes) -> tuple[str, ...]:
        axes = _axes_of(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        """The number of ranks along `axes` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in self._norm(axes))

    def index(self, axes) -> int:
        """This rank's position along `axes`, row-major over them."""
        idx = 0
        for a in self._norm(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of this rank's block along `axes`; None when
        the block is this rank alone."""
        axes = self._norm(axes)
        if self.size(axes) == 1:
            return None
        if axes not in self._groups:
            raise RuntimeError(f"{self!r} has no process group behind it")
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def mesh_axes_of(mesh: Mesh) -> set[str]:
    return set(mesh.axis_names)


def spec_for(axes: tuple[str | None, ...] | None, shape: tuple[int, ...],
             mesh: Mesh, rules: dict | None = None) -> P:
    """PartitionSpec from logical axes, with divisibility fallback."""
    if axes is None:
        return P()
    rules = rules or DEFAULT_RULES
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    entries = []
    used: set[str] = set()
    for dim, logical in zip(shape, axes):
        if logical is None:
            entries.append(None)
            continue
        mapped = rules.get(logical)
        if mapped is None:
            entries.append(None)
            continue
        maxes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        maxes = tuple(a for a in maxes if a in sizes and a not in used)
        total = 1
        for a in maxes:
            total *= sizes[a]
        if not maxes or dim % total != 0:
            entries.append(None)  # replicate when not evenly divisible
            continue
        used.update(maxes)
        entries.append(maxes if len(maxes) > 1 else maxes[0])
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


class NamedSharding:
    """A `spec` over a `mesh` (`jax.sharding.NamedSharding`)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        """The `DTensor` placements, one per mesh axis: `Shard(dim)` where
        the spec splits tensor dim `dim` over that axis, else
        `Replicate()` (a dim over several axes is split over them in mesh
        order, as `DTensor` splits it)."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.mesh.axis_names]
        for dim, entry in enumerate(self.spec):
            for a in _axes_of(entry):
                out[self.mesh.axis_names.index(a)] = Shard(dim)
        return tuple(out)

    def dims(self) -> list[tuple[int, tuple[str, ...]]]:
        """(tensor dim, mesh axes) of every split dimension."""
        return [(d, self.mesh._norm(e)) for d, e in enumerate(self.spec)
                if self.mesh.size(e) > 1]

    def local_shape(self, shape) -> tuple[int, ...]:
        shape = list(shape)
        for d, axes in self.dims():
            shape[d] //= self.mesh.size(axes)
        return tuple(shape)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of `x`, which every rank holds whole: `x`
        itself when nothing is split, else a contiguous copy."""
        dims = self.dims()
        if not dims:
            return x
        for d, axes in dims:
            n = x.shape[d] // self.mesh.size(axes)
            x = x.narrow(d, self.mesh.index(axes) * n, n)
        return x.contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block `x` (no gradient)."""
        for d, axes in self.dims():
            x = all_gather(x, self.mesh, axes, d)
        return x

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0):
    """`x`'s blocks from every rank along `axes`, concatenated on `dim` in
    the axes' row-major order (no gradient; `x` itself along one rank)."""
    n = mesh.size(axes)
    if n > 1 and mesh.recorder is not None:
        shape = list(x.shape)
        shape[dim] *= n
        return mesh.recorder.collective("all-gather", x, shape, n)
    group = mesh.group(axes)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def sharding_for(axes, shape, mesh: Mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, shape, mesh, rules))


def tree_shardings(spec_tree, mesh: Mesh, rules=None):
    """NamedSharding tree for a ParamSpec tree."""
    from repro_torch.models.module import tree_map
    return tree_map(lambda s: sharding_for(s.axes, s.shape, mesh, rules),
                    spec_tree)


def shard_tree(tree, shardings):
    """Every leaf of a whole tree cut to this rank's block."""
    from repro_torch.models.module import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [sh.shard(x) for x, sh in zip(
        tree_leaves(tree), tree_leaves(shardings))])


@torch.no_grad()
def gather_tree(tree, shardings):
    """Every leaf put back together from the ranks' blocks."""
    from repro_torch.models.module import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [sh.gather(x) for x, sh in zip(
        tree_leaves(tree), tree_leaves(shardings))])


def local_specs(spec_tree, shardings):
    """The ParamSpec tree of this rank's blocks (`init_from_specs` of it
    allocates only the local part, for zero-initialised caches)."""
    import dataclasses

    from repro_torch.models.module import tree_leaves, tree_unflatten
    return tree_unflatten(spec_tree, [
        dataclasses.replace(s, shape=sh.local_shape(s.shape))
        for s, sh in zip(tree_leaves(spec_tree), tree_leaves(shardings))])


def batch_axes(mesh: Mesh | None, batch: int,
               dp_axes=("pod", "data")) -> tuple[str, ...]:
    """The mesh axes a batch of `batch` rows splits over: `dp_axes` present
    in the mesh, or () when their product does not divide `batch` (the
    reference's `spec_for` fallback for "batch", and `moe_ffn`'s)."""
    if mesh is None:
        return ()
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    if dp and batch % mesh.size(dp) != 0:
        return ()
    return dp


def constrain(x, mesh: Mesh | None, *axes, rules=None):
    """This rank's block of `x` (which every rank holds whole) by logical
    axes, as `with_sharding_constraint` lays a global array out.

    No-op when mesh is None (e.g. inside shard_map bodies, where axes are
    already manual and constraints are meaningless)."""
    if mesh is None:
        return x
    return sharding_for(tuple(axes), x.shape, mesh, rules).shard(x)
