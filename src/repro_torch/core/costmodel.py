"""Stream Step 3: intra-core mapping cost extraction with unique-CN caching.

CNs of the same layer with equal loop extents map identically, so costs are
cached by `CN.size_signature()` x core id (the paper extracts "all unique
CN-core combinations"). The HW-model parser is modular: any object exposing
`cn_cost(dims, op, core, bits)` can replace ZigZag-lite.

`precompute()` materializes the cache as dense `(n_signatures x n_cores)`
NumPy tables plus a `cn -> signature index` map, so the scheduler's inner
loop is a pair of array indexes instead of a signature-tuple dict lookup
per CN per genome evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.cn import CN
from repro_torch.core.workload import Workload
from repro_torch.core.zigzag_lite import CNCost, cn_cost
from repro_torch.hw.accelerator import Accelerator

INFEASIBLE = None

# cross-instance memo for the default cost function (see CostModel.cost)
_GLOBAL_COST_CACHE: dict[tuple, CNCost] = {}
_GLOBAL_COST_LIMIT = 1 << 16


@dataclasses.dataclass(frozen=True)
class CostTables:
    """Dense per-(unique CN signature x core) cost tables (Step 3 output).

    Infeasible (signature, core) pairs hold 0 in the value tables and False
    in `feasible`; `e_sram` is the scheduler's `sram_act + sram_w` sum.
    """

    sig_of_cn: np.ndarray   # (n_cns,) int64: CN -> signature row
    cycles: np.ndarray      # (n_sig, n_cores) float64
    e_compute: np.ndarray   # (n_sig, n_cores) float64
    e_sram: np.ndarray      # (n_sig, n_cores) float64
    feasible: np.ndarray    # (n_sig, n_cores) bool

    @property
    def n_signatures(self) -> int:
        return self.cycles.shape[0]


class CostModel:
    def __init__(self, workload: Workload, accelerator: Accelerator, cost_fn=cn_cost):
        self.workload = workload
        self.accelerator = accelerator
        self.cost_fn = cost_fn
        self._cache: dict[tuple, CNCost | None] = {}
        # name-stripped cores for the global memo: the `name` label cannot
        # enter any cost, so "tpu0".."tpu3" with equal specs share entries
        self._core_content = [dataclasses.replace(c, name="")
                              for c in accelerator.cores]

    def cn_dims(self, cn: CN) -> Mapping[str, int]:
        layer = self.workload.layers[cn.layer]
        rd = cn.out_rect.as_dict()
        dims = {d: b - a for d, (a, b) in rd.items()}
        for d in ("C", "FY", "FX"):
            dims[d] = layer.d(d)
        if layer.op in ("dwconv", "pool", "add", "concat"):
            dims["C"] = 1
        return dims

    def cost(self, cn: CN, core_id: int) -> CNCost | None:
        key = (cn.size_signature(), core_id)
        hit = self._cache.get(key, False)
        if hit is not False:
            return hit
        layer = self.workload.layers[cn.layer]
        core = self.accelerator.cores[core_id]
        if not core.supports(layer.op):
            out = INFEASIBLE
        elif self.cost_fn is cn_cost:
            # default cost function is pure in (dims, op, core, bits): share
            # results across CostModel instances (e.g. an architecture sweep
            # re-costing the same layers on identical core models)
            dims = self.cn_dims(cn)
            gkey = (tuple(sorted(dims.items())), layer.op,
                    self._core_content[core_id], layer.bits)
            out = _GLOBAL_COST_CACHE.get(gkey, False)
            if out is False:
                out = cn_cost(dims, layer.op, core, layer.bits)
                if len(_GLOBAL_COST_CACHE) >= _GLOBAL_COST_LIMIT:
                    _GLOBAL_COST_CACHE.pop(next(iter(_GLOBAL_COST_CACHE)))
                _GLOBAL_COST_CACHE[gkey] = out
        else:
            out = self.cost_fn(self.cn_dims(cn), layer.op, core, layer.bits)
        self._cache[key] = out
        return out

    def feasible_cores(self, cn: CN) -> list[int]:
        return [i for i in range(self.accelerator.n_cores) if self.cost(cn, i) is not None]

    def precompute(self, graph, accelerator: Accelerator | None = None) -> CostTables:
        """Materialize dense cost tables for every CN of `graph`.

        Each unique `size_signature()` is costed once per core (through the
        regular cache, so repeated calls are free); the scheduler then reads
        `cycles[sig_of_cn[i], core]` instead of calling `cost()` per CN.
        `accelerator` is accepted for call-site symmetry but must equal this
        model's accelerator — the per-core costs come from `self.cost()`.
        """
        if accelerator is not None and accelerator != self.accelerator:
            raise ValueError(
                "precompute() accelerator differs from the CostModel's; "
                "build a CostModel for that accelerator instead")
        acc = self.accelerator
        sig_index: dict[tuple, int] = {}
        rep_cns: list[CN] = []          # one representative CN per signature
        sig_of_cn = np.empty(len(graph.cns), dtype=np.int64)
        for i, cn in enumerate(graph.cns):
            sig = cn.size_signature()
            s = sig_index.get(sig)
            if s is None:
                s = sig_index[sig] = len(rep_cns)
                rep_cns.append(cn)
            sig_of_cn[i] = s
        n_sig, n_cores = len(rep_cns), acc.n_cores
        cycles = np.zeros((n_sig, n_cores))
        e_compute = np.zeros((n_sig, n_cores))
        e_sram = np.zeros((n_sig, n_cores))
        feasible = np.zeros((n_sig, n_cores), dtype=bool)
        for s, cn in enumerate(rep_cns):
            for c in range(n_cores):
                cost = self.cost(cn, c)
                if cost is None:
                    continue
                feasible[s, c] = True
                cycles[s, c] = cost.cycles
                e_compute[s, c] = cost.breakdown["compute"]
                e_sram[s, c] = cost.breakdown["sram_act"] + cost.breakdown["sram_w"]
        return CostTables(sig_of_cn, cycles, e_compute, e_sram, feasible)
