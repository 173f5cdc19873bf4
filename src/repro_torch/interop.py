"""Carry a design point across from the JAX package.

Stream has no weights: the "parameters" of a design point are the workload
and the accelerator.  Both packages describe them with plain data, so the
reference's own serial forms are rebuilt here as the port's objects:

* `workload_from_dict(d)`: `d` is the reference's `Workload.to_dict()`;
* `accelerator_from_dict(d)`: `d` is `dataclasses.asdict(accelerator)`,
  nested `CoreModel`s and `TopologySpec` included.

Genome populations pass as NumPy int arrays unchanged.

    >>> import dataclasses
    >>> from repro_torch.hw.catalog import mc_hetero
    >>> acc = mc_hetero()
    >>> accelerator_from_dict(dataclasses.asdict(acc)) == acc
    True
"""
from __future__ import annotations

from typing import Mapping

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
