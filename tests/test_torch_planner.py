"""The port's Stream -> TPU pipeline planner (`repro_torch.core.planner`)
and its fault-tolerance re-plans (`repro_torch.train.fault_tolerance`)
against the JAX package's: twins of `tests/test_planner.py` and of the
elastic and straggler tests of `tests/test_train_substrate.py`.  The
planner is the reference's source with `repro.` rewritten over the port's
engine, which equals the reference's bit for bit, so every plan, latency,
peak, energy and per-stage count must be equal, not close.  The v5e stage
constants are the planner's model inputs, not measurements."""
import dataclasses

import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.core import planner as ref_planner
from repro.train import fault_tolerance as ref_ft

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import planner
from repro_torch.core.planner import contiguous_allocation
from repro_torch.models.zoo import active_params
from repro_torch.train import fault_tolerance as ft


def assert_same_plan(got, want):
    assert got.summary() == want.summary()
    assert np.array_equal(got.layer_to_stage, want.layer_to_stage)
    assert (got.schedule.latency_cc, got.schedule.energy_pj,
            got.schedule.act_peak_bytes) == \
        (want.schedule.latency_cc, want.schedule.energy_pj,
         want.schedule.act_peak_bytes)
    assert np.array_equal(got.schedule.utilization(),
                          want.schedule.utilization())


def both(fn_name, arch, shape, **kw):
    got = getattr(planner, fn_name)(ARCHS[arch], SHAPES[shape], **kw)
    want = getattr(ref_planner, fn_name)(REF_ARCHS[arch], REF_SHAPES[shape],
                                         **kw)
    return got, want


def test_single_stage_near_ideal_utilization():
    p, want = both("evaluate_pipeline", "deepseek-67b", "train_4k",
                   n_stages=1, chips_per_stage=256, n_microbatches=8)
    assert_same_plan(p, want)
    util = p.schedule.utilization()[0]
    assert util > 0.8  # one fused stage: almost no idle time
    # step time within 2x of the analytic compute bound
    ideal = 6 * active_params(ARCHS["deepseek-67b"]) * 4096 * 256 / \
        (256 * 197e12)
    assert p.est_step_s < 2.0 * ideal


def test_memory_priority_lowers_peak_at_latency_cost():
    """Paper Fig. 7 at pod scale: 1F1B-ish (memory) vs eager (latency)."""
    kw = dict(n_stages=4, chips_per_stage=64, n_microbatches=16)
    lat, want_lat = both("evaluate_pipeline", "deepseek-67b", "train_4k",
                         priority="latency", **kw)
    mem, want_mem = both("evaluate_pipeline", "deepseek-67b", "train_4k",
                         priority="memory", **kw)
    assert_same_plan(lat, want_lat)
    assert_same_plan(mem, want_mem)
    assert mem.est_peak_bytes < lat.est_peak_bytes
    assert lat.est_step_s < mem.est_step_s


def test_more_microbatches_shrink_bubble():
    kw = dict(n_stages=4, chips_per_stage=64)
    p4, w4 = both("evaluate_pipeline", "deepseek-67b", "train_4k",
                  n_microbatches=4, **kw)
    p32, w32 = both("evaluate_pipeline", "deepseek-67b", "train_4k",
                    n_microbatches=32, **kw)
    assert_same_plan(p4, w4)
    assert_same_plan(p32, w32)
    assert p32.est_step_s < p4.est_step_s


def test_contiguous_allocation_shape():
    a = contiguous_allocation(8, 4, include_bwd=True)
    assert a.shape == (16,)
    assert list(a[:8]) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert list(a[8:]) == [3, 3, 2, 2, 1, 1, 0, 0]  # bwd mirrors fwd
    for n, s, bwd in ((8, 4, True), (28, 4, False), (95, 8, True)):
        assert np.array_equal(contiguous_allocation(n, s, bwd),
                              ref_planner.contiguous_allocation(n, s, bwd))


def test_plan_search_returns_feasible():
    p, want = both("plan", "llama3.2-3b", "train_4k", total_chips=256,
                   stage_options=(1, 4), micro_options=(8,))
    assert_same_plan(p, want)
    assert p.n_stages * p.chips_per_stage == 256
    assert p.est_step_s > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "whisper-large-v3"])
def test_block_workloads_equal_the_reference(arch):
    """The conv-like block workload (fwd + bwd twins) and the stage cores
    the planner builds are the reference's, layer for layer."""
    w = planner.lm_block_workload(ARCHS[arch], SHAPES["train_4k"], True)
    rw = ref_planner.lm_block_workload(REF_ARCHS[arch],
                                       REF_SHAPES["train_4k"], True)
    assert w.to_dict() == rw.to_dict()
    acc = planner.tpu_pod_accelerator(4, 64)
    racc = ref_planner.tpu_pod_accelerator(4, 64)
    assert dataclasses.asdict(acc) == dataclasses.asdict(racc)


def test_elastic_replan_smaller_pod():
    cfg = ARCHS["llama3.2-3b"]
    plan_full = ft.replan_after_failure(cfg, SHAPES["train_4k"], 256,
                                        n_stages=4, n_microbatches=8)
    plan_small = ft.replan_after_failure(cfg, SHAPES["train_4k"], 192,
                                         n_stages=4, n_microbatches=8)
    assert plan_small.n_stages * plan_small.chips_per_stage == 192
    assert plan_small.est_step_s >= plan_full.est_step_s * 0.95
    for got, chips in ((plan_full, 256), (plan_small, 192)):
        assert_same_plan(got, ref_ft.replan_after_failure(
            REF_ARCHS["llama3.2-3b"], REF_SHAPES["train_4k"], chips,
            n_stages=4, n_microbatches=8))


def test_straggler_mitigation_ga_rebalances():
    cfg = ARCHS["llama3.2-3b"]
    kw = dict(n_stages=4, chips_per_stage=8, n_microbatches=8, slow_stage=0,
              slowdown=3.0)
    base, mitigated, per_stage = ft.replan_with_straggler(
        cfg, SHAPES["train_4k"], **kw)
    assert mitigated <= base * 1.001          # GA never worse
    assert per_stage.sum() == cfg.n_layers
    assert per_stage[0] <= per_stage[1:].max()  # slow stage got <= layers
    want = ref_ft.replan_with_straggler(REF_ARCHS["llama3.2-3b"],
                                        REF_SHAPES["train_4k"], **kw)
    assert (base, mitigated) == want[:2]
    assert np.array_equal(per_stage, want[2])
