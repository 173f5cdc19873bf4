"""Stream core: the paper's contribution (Steps 1-5) + the TPU planner."""
from repro_torch.core.workload import Layer, Workload
from repro_torch.core.cn import CN, identify_cns, cns_by_layer
from repro_torch.core.rtree import RTree, brute_force_query
from repro_torch.core.depgraph import CNGraph, build_cn_graph
from repro_torch.core.costmodel import CostModel, CostTables
from repro_torch.core.ga import GeneticAllocator, GAResult
from repro_torch.core.scheduler import (ScheduleEngine, ScheduleResult, schedule,
                                  schedule_reference)
from repro_torch.core.memtrace import trace, peak_memory
from repro_torch.core.stream_api import StreamResult, explore, evaluate_allocation, \
    evaluate_allocations, build_graph

__all__ = [
    "Layer", "Workload", "CN", "identify_cns", "cns_by_layer",
    "RTree", "brute_force_query", "CNGraph", "build_cn_graph",
    "CostModel", "CostTables", "GeneticAllocator", "GAResult",
    "ScheduleEngine", "ScheduleResult", "schedule", "schedule_reference",
    "trace", "peak_memory", "StreamResult", "explore", "evaluate_allocation",
    "evaluate_allocations", "build_graph",
]
