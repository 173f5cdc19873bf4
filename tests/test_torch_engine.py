"""The port's Stream engine (`repro_torch`) against the JAX package's, exactly.

Every design point crosses over through `repro_torch.interop`: the
reference's `Workload.to_dict()` and `dataclasses.asdict(accelerator)`.
The engine modules are copies of the reference's NumPy code, so everything
here is compared for equality — CSR graphs, cost tables, exact schedules
and whole GA explorations.  `energy_pj` is compared with the reference's
`ScheduleEngine`, whose float64 sum order the port keeps.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs.paper_workloads as ref_workloads
import repro.hw.catalog as ref_catalog
from repro.api.session import ExplorationSession as RefSession
from repro.core import CostModel as RefCostModel
from repro.core.allocator import feasible_cores_per_layer
from repro.core.scheduler import ScheduleEngine as RefEngine
from repro.core.scheduler import schedule_reference as ref_schedule_reference

import repro_torch.configs.paper_workloads as port_workloads
import repro_torch.hw.catalog as port_catalog
from repro_torch.api.session import ExplorationSession
from repro_torch.core import CostModel
from repro_torch.core.scheduler import ScheduleEngine, schedule_reference
from repro_torch.interop import accelerator_from_dict, workload_from_dict

torch.set_num_threads(2)

WORKLOADS = ["resnet18", "mobilenetv2", "squeezenet", "tiny_yolo", "fsrcnn",
             "resnet50_segment", "resnet18_first_segment"]
ARCHS = ["SC:TPU", "SC:Eye", "SC:Env", "MC:HomTPU", "MC:HomEye",
         "MC:HomEnv", "MC:Hetero", "MC:HomTPU-chip2", "MC:HomTPU-chip4",
         "MC:Hetero-chip2", "DepFiN", "AiMC4x4", "DIANA"]
GRAN = ("tile", 8, 1)


def _registry(catalog) -> dict:
    return {**catalog.EXPLORATION_ARCHITECTURES,
            **catalog.CHIPLET_ARCHITECTURES,
            **catalog.VALIDATION_ARCHITECTURES}


def _ref_arch(name):
    return _registry(ref_catalog)[name]()


def _port_arch(name):
    return _registry(port_catalog)[name]()


def _pair(workload: str, arch: str):
    """(reference workload, reference accelerator, port workload, port
    accelerator) for one design point, crossed over through interop."""
    rw = getattr(ref_workloads, workload)()
    racc = _ref_arch(arch)
    return (rw, racc, workload_from_dict(rw.to_dict()),
            accelerator_from_dict(dataclasses.asdict(racc)))


def _population(w, acc, k, seed):
    rng = np.random.default_rng(seed)
    feas = feasible_cores_per_layer(w, acc)
    return np.stack([[f[rng.integers(len(f))] for f in feas]
                     for _ in range(k)])


@pytest.mark.parametrize("name", WORKLOADS)
def test_paper_workloads_equal(name):
    ref = getattr(ref_workloads, name)()
    port = getattr(port_workloads, name)()
    assert port.to_dict() == ref.to_dict()
    assert port.cache_key() == ref.cache_key()
    assert workload_from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert ({k: v().to_dict() for k, v in
             port_workloads.EXPLORATION_WORKLOADS.items()}
            == {k: v().to_dict() for k, v in
                ref_workloads.EXPLORATION_WORKLOADS.items()})


@pytest.mark.parametrize("name", ARCHS)
def test_catalog_accelerators_equal(name):
    assert sorted(_registry(port_catalog)) == sorted(ARCHS)
    ref, port = _ref_arch(name), _port_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert accelerator_from_dict(dataclasses.asdict(ref)) == port


@pytest.fixture(scope="module", params=[
    ("squeezenet", "MC:Hetero"), ("resnet18", "MC:HomTPU-chip4"),
    ("mobilenetv2", "MC:HomTPU")])
def engines(request):
    rw, racc, w, acc = _pair(*request.param)
    ref = RefSession().engine(rw, racc, GRAN)
    port = ExplorationSession(device="cpu").engine(w, acc, GRAN)
    return rw, racc, ref, port


def test_graph_and_cost_tables_equal(engines):
    _, _, ref, port = engines
    arrays = {k: v for k, v in vars(ref.graph).items()
              if isinstance(v, np.ndarray)}
    assert {"pred_indptr", "pred_indices", "succ_indptr"} <= set(arrays)
    for k, v in arrays.items():
        assert np.array_equal(v, getattr(port.graph, k)), k
    for f in dataclasses.fields(ref.tables):
        assert np.array_equal(getattr(ref.tables, f.name),
                              getattr(port.tables, f.name)), f.name


@pytest.mark.parametrize("priority", ["latency", "memory"])
def test_evaluate_population_equal(engines, priority):
    rw, racc, ref, port = engines
    pop = _population(rw, racc, 12, seed=4)
    assert np.array_equal(port.evaluate_population(pop, priority),
                          ref.evaluate_population(pop, priority))


def test_schedule_and_reference_scheduler_equal(engines):
    rw, racc, ref, port = engines
    alloc = _population(rw, racc, 1, seed=8)[0]
    a, b = ref.schedule(alloc), port.schedule(alloc)
    assert (b.latency_cc, b.energy_pj, b.peak_mem_bytes) == (
        a.latency_cc, a.energy_pj, a.peak_mem_bytes)
    ra = ref_schedule_reference(ref.graph, RefCostModel(rw, racc), alloc,
                                racc)
    pb = schedule_reference(port.graph, CostModel(port.cost_model.workload,
                                                  port.accelerator),
                            alloc, port.accelerator)
    assert (pb.latency_cc, pb.energy_pj) == (ra.latency_cc, ra.energy_pj)


def test_validate_runs_the_race_detector(engines):
    """`schedule(validate=True)` runs the port's race detector and returns
    the reference's result.  (`tests/test_torch_racecheck.py` holds the
    detector itself.)"""
    rw, racc, ref, port = engines
    assert isinstance(port, ScheduleEngine)
    alloc = _population(rw, racc, 1, seed=2)[0]
    a = ref.schedule(alloc, validate=True)
    b = port.schedule(alloc, validate=True)
    assert (b.latency_cc, b.energy_pj, b.peak_mem_bytes) == (
        a.latency_cc, a.energy_pj, a.peak_mem_bytes)
    assert b.mem_events == a.mem_events
    with pytest.raises(ValueError, match="record=True"):
        port.schedule(alloc, record=False, validate=True)


@pytest.mark.parametrize("arch,seed", [("MC:Hetero", 0), ("MC:Hetero", 1),
                                       ("MC:HomTPU-chip2", 0)])
def test_explore_unfiltered_bit_identical(arch, seed):
    rw, racc, w, acc = _pair("squeezenet", arch)
    kw = dict(granularity=("tile", 32, 1), objective="edp",
              priority="latency", pop_size=16, generations=8, seed=seed,
              prefilter=False)
    ref = RefSession().explore(rw, racc, **kw)
    port = ExplorationSession(device="cpu").explore(w, acc, **kw)
    assert np.array_equal(port.allocation, ref.allocation)
    assert port.latency_cc == ref.latency_cc
    assert port.energy_pj == ref.energy_pj
    assert port.peak_mem_bytes == ref.peak_mem_bytes
    assert port.ga.evaluations == ref.ga.evaluations
    # the energy is the reference ScheduleEngine's, not schedule_reference's
    eng = RefEngine(ref.graph, RefCostModel(rw, racc), racc)
    assert port.energy_pj == eng.schedule(ref.allocation).energy_pj
