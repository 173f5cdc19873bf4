"""Shared set-up of the tests that hold `repro_torch` against `repro`: the
same design point and the same numpy-made inputs for both packages."""
import dataclasses

import numpy as np
from _torch_inputs import RTOL, population

import repro.configs.paper_workloads as ref_workloads
import repro.hw.catalog as ref_catalog
from repro.core import CostModel as RefCostModel
from repro.core import build_graph as ref_build_graph
from repro.core.scheduler import ScheduleEngine as RefEngine
from repro.core.vectorized import BatchedFitness as RefBatchedFitness

from repro_torch.core import CostModel, build_graph
from repro_torch.core.scheduler import ScheduleEngine
from repro_torch.core.vectorized import BatchedFitness
from repro_torch.interop import accelerator_from_dict, workload_from_dict

def engines(arch: str, workload: str = "squeezenet",
            granularity=("tile", 8, 1)):
    """(reference engine, port engine) for one catalog architecture, the
    port's design point crossed over through `repro_torch.interop`."""
    racc = getattr(ref_catalog, arch)()
    rw = getattr(ref_workloads, workload)()
    acc = accelerator_from_dict(dataclasses.asdict(racc))
    w = workload_from_dict(rw.to_dict())
    ref = RefEngine(ref_build_graph(rw, racc, granularity),
                    RefCostModel(rw, racc), racc)
    port = ScheduleEngine(build_graph(w, acc, granularity),
                          CostModel(w, acc), acc)
    return ref, port


def check_scores(pair, priority, contention):
    """The port's scores equal the reference's on one population."""
    ref, port, pop = pair
    want = RefBatchedFitness(ref, priority=priority, contention=contention,
                             use_pallas=contention == "serialize")
    got = BatchedFitness(port, priority=priority, contention=contention,
                         device="cpu")
    assert (got.n_wavefronts, got.width) == (want.n_wavefronts, want.width)
    s = got.scores(pop)
    assert s.dtype == np.float64 and s.shape == (len(pop), 2)
    np.testing.assert_allclose(s, want.scores(pop), rtol=RTOL)


def check_lower_bound(pair):
    ref, port, pop = pair
    want = RefBatchedFitness(ref).latency_lower_bound(pop)
    got = BatchedFitness(port, device="cpu").latency_lower_bound(pop)
    assert np.array_equal(got, want)


def make_pair(arch):
    ref, port = engines(arch)
    return ref, port, population(ref.cost_model.workload, ref.accelerator, 8)
