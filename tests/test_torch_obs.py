"""The port's observability layer (`repro_torch.obs`) equals the JAX
package's: the Chrome trace of one schedule and of one serving run are the
same bytes, a traced sweep writes the same JSONL span file and counts the
same counters and histograms, `bottleneck_report` is the same (its lower
bound from the port's `BatchedFitness.latency_lower_bound`, on the CPU),
and tracing leaves the records bit-identical."""
import numpy as np
import pytest
from _torch_dse import contents, spaces

import repro.api as R
import repro.configs.paper_workloads as ref_workloads
import repro.hw.catalog as ref_catalog
import repro.obs as RO
from repro.core import CostModel as RefCostModel
from repro.core import build_graph as ref_build_graph
from repro.core.allocator import manual_pingpong as ref_pingpong
from repro.core.scheduler import ScheduleEngine as RefEngine
from repro.core.vectorized import BatchedFitness as RefBatchedFitness
from repro.serve.arrivals import poisson_trace as ref_poisson
from repro.serve.simulator import PhaseCosts as RefPhaseCosts
from repro.serve.simulator import simulate as ref_simulate

import repro_torch.api as T
import repro_torch.configs.paper_workloads as port_workloads
import repro_torch.hw.catalog as port_catalog
import repro_torch.obs as TO
from repro_torch.core import CostModel, build_graph
from repro_torch.core.allocator import manual_pingpong
from repro_torch.core.scheduler import ScheduleEngine
from repro_torch.core.vectorized import BatchedFitness
from repro_torch.serve.arrivals import poisson_trace
from repro_torch.serve.simulator import PhaseCosts, simulate

CASES = [("fsrcnn", "mc_hom_tpu_chip4", ("tile", 8, 1)),
         ("squeezenet", "mc_hetero", ("tile", 8, 1)),
         ("resnet18", "mc_hom_tpu", "layer")]
SPACE = dict(workloads=["fsrcnn", "squeezenet"],
             archs={"MC:HomTPU": "mc_hom_tpu", "MC:Hetero": "mc_hetero"},
             granularities=["layer", ("tile", 8, 1)],
             pop_size=4, generations=2)


def _engines(workload, arch, granularity):
    """(reference engine, allocation), (port engine, allocation), each
    package from its own registry and catalog."""
    out = []
    for wl, cat, build, cost, engine, pingpong in (
            (ref_workloads, ref_catalog, ref_build_graph, RefCostModel,
             RefEngine, ref_pingpong),
            (port_workloads, port_catalog, build_graph, CostModel,
             ScheduleEngine, manual_pingpong)):
        w, acc = getattr(wl, workload)(), getattr(cat, arch)()
        out.append((engine(build(w, acc, granularity), cost(w, acc), acc),
                    pingpong(w, acc)))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_schedule_chrome_trace_bytes_equal(case):
    (ref, ref_alloc), (port, alloc) = _engines(*case)
    assert alloc.tolist() == ref_alloc.tolist()
    events, result = TO.trace_schedule(port, alloc)
    want_events, want = RO.trace_schedule(ref, ref_alloc)
    assert TO.validate_trace_events(events) == []
    assert TO.chrome_trace_json(events) == RO.chrome_trace_json(want_events)
    assert (result.latency_cc, result.energy_pj) == (want.latency_cc,
                                                     want.energy_pj)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_bottleneck_report_equals_reference(case):
    (ref, ref_alloc), (port, alloc) = _engines(*case)
    lb = float(BatchedFitness(port, device="cpu").latency_lower_bound(
        np.asarray(alloc)[None, :])[0])
    ref_lb = float(RefBatchedFitness(ref).latency_lower_bound(
        np.asarray(ref_alloc)[None, :])[0])
    assert lb == ref_lb
    got = TO.bottleneck_report(port.schedule(alloc, "latency"),
                               lower_bound_cc=lb)
    want = RO.bottleneck_report(ref.schedule(ref_alloc, "latency"),
                                lower_bound_cc=ref_lb)
    assert got.to_json() == want.to_json()
    assert got.to_text() == want.to_text()


def test_serving_chrome_trace_bytes_equal():
    kw = dict(prefill_cc=100.0, prefill_pj=2.0, decode_cc=10.0,
              decode_pj=1.0)
    tracers = TO.Tracer(), RO.Tracer()
    got = simulate(poisson_trace(2000.0, 8, seed=0, decode_tokens=4),
                   PhaseCosts(**kw), batch_slots=2, tracer=tracers[0])
    want = ref_simulate(ref_poisson(2000.0, 8, seed=0, decode_tokens=4),
                        RefPhaseCosts(**kw), batch_slots=2,
                        tracer=tracers[1])
    assert TO.chrome_trace_json(TO.serving_trace_events(got)) == \
        RO.chrome_trace_json(RO.serving_trace_events(want))
    assert tracers[0].snapshot() == tracers[1].snapshot()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced serial sweep in each package, its spans in a JSONL sink."""
    path = tmp_path_factory.mktemp("traced")
    pair = spaces(**SPACE)
    out = {}
    for name, api, obs, space in (("ref", R, RO, pair[0]),
                                  ("port", T, TO, pair[1])):
        sink = str(path / f"{name}.jsonl")
        tracer = obs.Tracer(sink=obs.JsonlSink(sink))
        session = api.ExplorationSession(cache_dir=str(path / name),
                                         tracer=tracer)
        sweep = session.run(space)
        again = session.run(space)          # all store hits
        tracer.close()
        with open(sink, "rb") as f:
            out[name] = dict(sweep=sweep, again=again, tracer=tracer,
                             session=session, jsonl=f.read())
    out["plain"] = T.ExplorationSession().run(pair[1])
    return out


def test_traced_sweep_jsonl_bytes_equal(traced):
    assert traced["port"]["jsonl"] == traced["ref"]["jsonl"]
    assert traced["port"]["jsonl"].count(b"\n") > 0


def test_traced_sweep_counters_equal(traced):
    got = traced["port"]["tracer"].snapshot()
    assert got == traced["ref"]["tracer"].snapshot()
    counters = got["counters"]
    assert counters["sweep.computed"] == traced["port"]["sweep"].n_scheduled
    assert counters["sweep.store_hits"] == len(traced["port"]["again"])
    assert counters["engine.schedules"] > 0 and counters["ga.generations"] > 0
    assert traced["port"]["session"].metrics_snapshot() == \
        traced["ref"]["session"].metrics_snapshot()


def test_tracing_keeps_records_bit_identical(traced):
    assert contents(traced["port"]["sweep"].records) == \
        contents(traced["plain"].records) == \
        contents(traced["ref"]["sweep"].records)
