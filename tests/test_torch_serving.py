"""The port's analytic serving simulator equals the JAX package's: seeded
arrival traces, `simulate` on the same `PhaseCosts`, the serving workload
families and their decode phases, `run_serving`'s `ServingRecord`s for
both executors, and the `--simulate` CLI's printed curve for each family."""
import contextlib
import io

import pytest
from _torch_dse import spaces

import repro.serve as RS
from repro.launch.serve import main as ref_main

import repro_torch.api as T
import repro_torch.serve as TS
from repro_torch.launch.serve import main as port_main

COSTS = [dict(prefill_cc=100.0, prefill_pj=2.0, decode_cc=10.0,
              decode_pj=1.0),
         dict(prefill_cc=2.5e5, prefill_pj=3e7, decode_cc=0.0,
              decode_pj=0.0)]


@pytest.mark.parametrize("rate", [100.0, 2000.0, 5e5])
def test_poisson_trace_equals_reference(rate):
    kw = dict(seed=3, decode_tokens=5, prompt_tokens=48)
    got = TS.poisson_trace(rate, 32, **kw)
    assert TS.trace_to_jsonable(got) == \
        RS.trace_to_jsonable(RS.poisson_trace(rate, 32, **kw))
    assert TS.trace_to_jsonable(TS.uniform_trace(250.0, 16)) == \
        RS.trace_to_jsonable(RS.uniform_trace(250.0, 16))


@pytest.mark.parametrize("costs", COSTS, ids=["decode", "prefill-only"])
@pytest.mark.parametrize("slots", [1, 3])
def test_simulate_equals_reference(costs, slots):
    trace = dict(rate_rps=4000.0, n_requests=24, seed=1, decode_tokens=6)
    got = TS.simulate(TS.poisson_trace(**trace), TS.PhaseCosts(**costs),
                      batch_slots=slots)
    want = RS.simulate(RS.poisson_trace(**trace), RS.PhaseCosts(**costs),
                       batch_slots=slots)
    assert got.to_dict() == want.to_dict()
    assert (got.p50_latency_cc(), got.p99_latency_cc(), got.qps(),
            got.slo_attainment(5e4)) == \
        (want.p50_latency_cc(), want.p99_latency_cc(), want.qps(),
         want.slo_attainment(5e4))


@pytest.mark.parametrize("family", ["transformer", "rwkv", "ssm"])
def test_serving_workloads_equal_reference(family):
    got, want = TS.serving_workload(family), RS.serving_workload(family)
    assert got.to_dict() == want.to_dict()
    assert TS.decode_phase_of(got).to_dict() == \
        RS.decode_phase_of(want).to_dict()


@pytest.fixture(scope="module")
def serving_pair():
    wl = {"tfm": (RS.transformer_phases(d_model=32, n_layers=1, seq_len=8),
                  TS.transformer_phases(d_model=32, n_layers=1, seq_len=8)),
          "rwkv": (RS.rwkv_phases(d_model=32, n_layers=1, seq_len=8),
                   TS.rwkv_phases(d_model=32, n_layers=1, seq_len=8))}
    return spaces(wl, {"SC:TPU": "sc_tpu", "MC:HomTPU": "mc_hom_tpu"},
                  ["layer"], pop_size=4, generations=2,
                  serving=dict(rates_rps=(100.0, 1e4, 1e6),
                               slo_ms=(0.05, 50.0), n_requests=8,
                               decode_tokens=4))


@pytest.fixture(scope="module")
def ref_serving(serving_pair):
    from repro.api import ExplorationSession
    return ExplorationSession().run_serving(serving_pair[0])


@pytest.mark.parametrize("executor", ["serial", "process"])
def test_run_serving_equals_reference(serving_pair, ref_serving, executor):
    got = T.ExplorationSession().run_serving(
        serving_pair[1], executor=executor, max_workers=2)
    assert len(got) == len(ref_serving) == 2 * 2 * 3 * 2
    assert [r.to_dict() for r in got.records] == \
        [r.to_dict() for r in ref_serving.records]
    assert got.n_scheduled == ref_serving.n_scheduled == 8
    assert [r.to_dict() for r in got.curve("tfm", "SC:TPU")] == \
        [r.to_dict() for r in ref_serving.curve("tfm", "SC:TPU")]


@pytest.mark.parametrize("family", ["transformer", "rwkv", "ssm"])
def test_simulate_cli_prints_the_reference_curve(family):
    argv = ["--simulate", "--family", family, "--rate", "500",
            "--rate", "5000", "--requests", "8"]
    printed = []
    for main in (port_main, ref_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sweep = main(argv)
        printed.append((buf.getvalue(), [r.to_dict() for r in sweep.records]))
    assert printed[0] == printed[1]
    assert printed[0][0].count("rate") == 2
