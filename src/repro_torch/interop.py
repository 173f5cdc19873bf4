"""Carry a design point across from the JAX package.

Stream has no weights: the "parameters" of a design point are the workload
and the accelerator.  Both packages describe them with plain data, so the
reference's own serial forms are rebuilt here as the port's objects:

* `workload_from_dict(d)`: `d` is the reference's `Workload.to_dict()`;
* `accelerator_from_dict(d)`: `d` is `dataclasses.asdict(accelerator)`,
  nested `CoreModel`s and `TopologySpec` included.

Genome populations pass as NumPy int arrays unchanged.

Model configs and weights cross the same way, for the parity tests:

* `arch_config_from_dict(d)`: `d` is `dataclasses.asdict(arch_config)`;
* `params_from_numpy(tree, device)`: `tree` is the reference's parameter or
  cache pytree with every leaf passed through `np.asarray`.

    >>> import dataclasses
    >>> from repro_torch.hw.catalog import mc_hetero
    >>> acc = mc_hetero()
    >>> accelerator_from_dict(dataclasses.asdict(acc)) == acc
    True
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.workload import Workload
from repro_torch.hw.accelerator import Accelerator
from repro_torch.hw.core_model import CoreModel
from repro_torch.hw.topology import TopologySpec


def workload_from_dict(d: Mapping) -> Workload:
    return Workload.from_dict(d)


def _core_from_dict(d: Mapping) -> CoreModel:
    d = dict(d)
    d["dataflow"] = tuple((str(dim), int(u)) for dim, u in d["dataflow"])
    return CoreModel(**d)


def accelerator_from_dict(d: Mapping) -> Accelerator:
    d = dict(d)
    d["cores"] = tuple(_core_from_dict(c) for c in d["cores"])
    if d.get("topology") is not None:
        d["topology"] = TopologySpec.from_dict(d["topology"])
    return Accelerator(**d)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch_config_from_dict(d: Mapping) -> ArchConfig:
    """The port's `ArchConfig` from the reference's `dataclasses.asdict`;
    the working type maps by name (bfloat16, float32)."""
    d = dict(d)
    dt = d["dtype"]
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    if name not in _DTYPES:
        raise ValueError(f"no torch type for the reference's dtype {name!r}")
    d["dtype"] = _DTYPES[name]
    return ArchConfig(**d)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # 16-bit patterns across and reinterpret them, bit for bit
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device) -> dict:
    """A nested dict of numpy arrays (the reference's parameter or cache
    pytree through `np.asarray`) as torch tensors on `device`.  bfloat16
    leaves go through their 16-bit patterns (`a.view(np.uint16)`, then
    `.view(torch.bfloat16)`), so every value arrives bit-exact."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)
