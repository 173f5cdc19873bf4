"""Stream Step 4: layer-core allocation via the genetic algorithm.

The genome has one gene per layer (paper: "bit flip = allocating a layer to a
different core"). Feasibility: SIMD-only ops (pool / residual add / concat)
are pinned to the SIMD core when one exists (paper Sec. V-B); dense compute
layers may go to any compute core. Includes the two manual baselines of
paper Fig. 12: ping-pong (homogeneous) and best-spatial-fit (heterogeneous).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.costmodel import CostModel
from repro_torch.core.workload import SIMD_OPS, Workload
from repro_torch.hw.accelerator import Accelerator


def feasible_cores_per_layer(workload: Workload, accelerator: Accelerator) -> list[list[int]]:
    simd = accelerator.simd_core_id
    compute = accelerator.compute_core_ids()
    out = []
    for layer in workload.layers.values():
        if layer.op in SIMD_OPS and simd is not None:
            out.append([simd])
        else:
            ok = [c for c in compute if accelerator.cores[c].supports(layer.op)]
            out.append(ok or compute)
    return out


def manual_pingpong(workload: Workload, accelerator: Accelerator) -> np.ndarray:
    """Fig. 12 manual baseline for homogeneous multi-cores: subsequent layers
    to subsequent compute cores in a ping-pong fashion."""
    feas = feasible_cores_per_layer(workload, accelerator)
    compute = accelerator.compute_core_ids()
    alloc, k = [], 0
    for lid, layer in workload.layers.items():
        if len(feas[lid]) == 1:
            alloc.append(feas[lid][0])
        else:
            alloc.append(compute[k % len(compute)])
            k += 1
    return np.array(alloc)


def manual_best_fit(workload: Workload, accelerator: Accelerator,
                    cost_model: CostModel) -> np.ndarray:
    """Fig. 12 manual baseline for heterogeneous multi-cores: each layer to
    the core whose dataflow best fits it (highest spatial utilization)."""
    from repro_torch.core.cn import identify_cns
    feas = feasible_cores_per_layer(workload, accelerator)
    alloc = []
    for lid, layer in workload.layers.items():
        if len(feas[lid]) == 1:
            alloc.append(feas[lid][0])
            continue
        best_c, best_u = feas[lid][0], -1.0
        for c in feas[lid]:
            core = accelerator.cores[c]
            util = 1.0
            for dim, u in core.dataflow:
                ext = layer.d(dim)
                util *= min(ext, u) / u if u > 1 else 1.0
            if util > best_u:
                best_c, best_u = c, util
        alloc.append(best_c)
    return np.array(alloc)
