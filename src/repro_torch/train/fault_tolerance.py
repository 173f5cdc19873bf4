"""Fault tolerance & elasticity for 1000+-node deployments.

Mechanisms (all exercised by tests/test_fault_tolerance.py):

1. checkpoint/restart — periodic async checkpoints (train/checkpoint.py,
   atomic rename + manifest); `resume_or_init` restores the latest step and
   the data pipeline replays deterministically from there (data.py seeds by
   (seed, step, shard), so a restart reproduces the exact global batch).

2. elastic re-mesh — checkpoints store GLOBAL arrays + the manifest, so a
   job restarted on a different device count simply builds a new mesh,
   re-derives shardings from the ParamSpec logical axes, and `restore`
   re-shards. The Stream planner then re-plans (stage allocation +
   microbatching) for the surviving topology — the same GA/scheduler that
   placed layers on cores places them on the new mesh.

3. straggler mitigation — the planner models a slow stage by scaling that
   core's `latency_overhead`; re-running the GA reallocates layers away
   from the slow slice (fewer layers -> balanced finish times). At runtime
   the launcher monitors per-step time and triggers a re-plan when the
   p99/median ratio exceeds a threshold.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import planner as planner_mod
from repro_torch.core.ga import GeneticAllocator
from repro_torch.core.scheduler import schedule
from repro_torch.core.costmodel import CostModel
from repro_torch.core.depgraph import build_cn_graph
from repro_torch.core.cn import identify_cns
from repro_torch.train import checkpoint as ckpt


def resume_or_init(ckpt_dir: str, init_fn, like_tree=None, shardings=None):
    """Restore the latest checkpoint or initialize fresh.

    Returns (tree, start_step)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return init_fn(), 0
    tree = ckpt.restore(ckpt_dir, step, like_tree=like_tree,
                        shardings=shardings)
    return tree, step


def replan_after_failure(cfg: ArchConfig, shape: ShapeConfig,
                         surviving_chips: int, *, n_stages: int = 4,
                         n_microbatches: int = 16):
    """Elastic re-mesh: plan the pipeline for the surviving device count."""
    while surviving_chips % n_stages or cfg.n_layers % n_stages:
        n_stages //= 2
        if n_stages == 1:
            break
    return planner_mod.evaluate_pipeline(
        cfg, shape, n_stages=max(n_stages, 1),
        chips_per_stage=surviving_chips // max(n_stages, 1),
        n_microbatches=n_microbatches)


def replan_with_straggler(cfg: ArchConfig, shape: ShapeConfig, *,
                          n_stages: int = 4, chips_per_stage: int = 64,
                          n_microbatches: int = 16, slow_stage: int = 0,
                          slowdown: float = 2.0, seed: int = 0):
    """Straggler mitigation: GA reallocation with one slow stage.

    Returns (baseline_plan_latency, mitigated_latency, layers_per_stage)."""
    import dataclasses as dc
    include_bwd = shape.kind == "train"
    w = planner_mod.lm_block_workload(cfg, shape, include_bwd)
    acc = planner_mod.tpu_pod_accelerator(n_stages, chips_per_stage)
    cores = list(acc.cores)
    cores[slow_stage] = dc.replace(cores[slow_stage],
                                   latency_overhead=slowdown)
    acc = dc.replace(acc, cores=tuple(cores))
    cns = identify_cns(w, ("tile", n_microbatches, 1))
    graph = build_cn_graph(w, cns)
    cm = CostModel(w, acc)

    base_alloc = planner_mod.contiguous_allocation(
        cfg.n_layers, n_stages, include_bwd)
    base = schedule(graph, cm, base_alloc, acc, "latency", segment=False)

    feas = [list(range(n_stages))] * len(w)

    def evaluate(genome):
        r = schedule(graph, cm, genome, acc, "latency", segment=False)
        return (r.latency_cc, r.energy_pj)

    ga = GeneticAllocator(len(w), feas, evaluate, pop_size=16, generations=12,
                          seed=seed)
    res = ga.run(initial=[base_alloc])
    mitigated = schedule(graph, cm, res.best_genome, acc, "latency",
                         segment=False)
    per_stage = np.bincount(res.best_genome[:cfg.n_layers],
                            minlength=n_stages)
    return base.latency_cc, mitigated.latency_cc, per_stage
