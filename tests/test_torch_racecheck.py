"""The port's schedule race detector (`repro_torch.analysis.staticcheck`)
against the JAX package's, exactly.

The detector is a copy of the reference's pure-Python module with its one
import rewritten (its code equal, function docstrings included), so
everything here is compared for equality: each report
dict, and for a deliberately corrupted trace the violated invariant's name
and the whole message.  Each corruption is the one of the reference's own
racecheck tests (`tests/test_staticcheck.py`), applied to the port's trace
and to the reference's trace alike.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

import repro.configs.paper_workloads as ref_workloads
import repro.hw.catalog as ref_catalog
from repro.analysis.staticcheck import TraceValidationError as RefError
from repro.analysis.staticcheck import validate_trace as ref_validate
from repro.core import CostModel as RefCostModel
from repro.core import build_graph as ref_build_graph
from repro.core.allocator import manual_pingpong as ref_pingpong
from repro.core.scheduler import ScheduleEngine as RefEngine
from repro.core.scheduler import schedule_reference as ref_schedule_reference

import repro_torch.analysis.staticcheck as port_staticcheck
from repro_torch.analysis.staticcheck import (TraceValidationError,
                                              validate_trace)
from repro_torch.core import CostModel, build_graph
from repro_torch.core.allocator import manual_pingpong
from repro_torch.core.scheduler import ScheduleEngine, schedule_reference
from repro_torch.interop import accelerator_from_dict, workload_from_dict

ROOT = Path(__file__).resolve().parents[1]

# the setups of tests/test_engine_golden.py: bus, multi-producer concats,
# shared memory (DIANA)
SETUPS = {
    "r18-hom-bus": ("resnet18", "mc_hom_tpu", ("tile", 16, 1)),
    "sqz-het-bus": ("squeezenet", "mc_hetero", ("tile", 16, 1)),
    "fsr-diana-shmem": ("fsrcnn", "diana", ("tile", 8, 1)),
}
MODES = {"segmented": {}, "unsegmented": {"segment": False},
         "strict_layers": {"strict_layers": True}}


class Side:
    """One package's design point: workload, accelerator, graph, engine and
    the manual ping-pong allocation."""

    def __init__(self, w, acc, graph, engine, alloc):
        self.w, self.acc, self.graph = w, acc, graph
        self.engine, self.alloc = engine, alloc


def _sides(workload, arch, gran):
    rw = getattr(ref_workloads, workload)()
    racc = getattr(ref_catalog, arch)()
    w = workload_from_dict(rw.to_dict())
    acc = accelerator_from_dict(dataclasses.asdict(racc))
    rg, g = ref_build_graph(rw, racc, gran), build_graph(w, acc, gran)
    ref = Side(rw, racc, rg, RefEngine(rg, RefCostModel(rw, racc), racc),
               ref_pingpong(rw, racc))
    port = Side(w, acc, g, ScheduleEngine(g, CostModel(w, acc), acc),
                manual_pingpong(w, acc))
    assert list(port.alloc) == list(ref.alloc)
    return ref, port


@pytest.fixture(scope="module", params=sorted(SETUPS))
def golden(request):
    return _sides(*SETUPS[request.param])


@pytest.fixture(scope="module")
def sched():
    """fsrcnn on MC:HomTPU at tile 8, as the reference's racecheck tests."""
    return _sides("fsrcnn", "mc_hom_tpu", ("tile", 8, 1))


def _code(source: str) -> str:
    """The AST of a module without its docstring, `repro_torch.` imports
    read as `repro.`."""
    tree = ast.parse(source.replace("repro_torch.", "repro."))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        tree.body = body[1:]
    return ast.dump(tree)


def test_the_detector_is_the_reference_module_with_its_imports_rewritten():
    ref = (ROOT / "src/repro/analysis/staticcheck/racecheck.py").read_text()
    port = (ROOT / "src/repro_torch/analysis/staticcheck/racecheck.py"
            ).read_text()
    assert _code(port) == _code(ref)
    assert port_staticcheck.__all__ == ["TraceValidationError",
                                        "validate_trace"]
    assert issubclass(TraceValidationError, ValueError)


@pytest.mark.parametrize("priority", ["latency", "memory"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_reports_equal_the_reference_on_the_golden_traces(golden, priority,
                                                          mode):
    ref, port = golden
    kw = MODES[mode]
    want = ref_validate(ref.engine.schedule(ref.alloc, priority, **kw),
                        ref.graph, ref.acc, workload=ref.w, **kw)
    got = validate_trace(port.engine.schedule(port.alloc, priority, **kw),
                         port.graph, port.acc, workload=port.w, **kw)
    assert got == want
    assert got["cns"] == port.graph.n and not got["skipped"]
    # the preserved seed scheduler's trace validates alike
    rr = ref_schedule_reference(ref.graph, RefCostModel(ref.w, ref.acc),
                                ref.alloc, ref.acc, priority, **kw)
    pr = schedule_reference(port.graph, CostModel(port.w, port.acc),
                            port.alloc, port.acc, priority, **kw)
    assert validate_trace(pr, port.graph, port.acc, workload=port.w, **kw) \
        == ref_validate(rr, ref.graph, ref.acc, workload=ref.w, **kw)


@pytest.mark.parametrize("priority", ["latency", "memory"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_schedule_validate_returns_the_reference_result(golden, priority,
                                                        mode):
    """`schedule(validate=True)` runs the detector and returns what the
    reference's returns."""
    ref, port = golden
    kw = MODES[mode]
    want = ref.engine.schedule(ref.alloc, priority, validate=True, **kw)
    got = port.engine.schedule(port.alloc, priority, validate=True, **kw)
    assert (got.latency_cc, got.energy_pj, got.peak_mem_bytes) == (
        want.latency_cc, want.energy_pj, want.peak_mem_bytes)
    assert got.mem_events == want.mem_events
    assert got.comm_intervals == want.comm_intervals
    with pytest.raises(ValueError, match="record=True"):
        port.engine.schedule(port.alloc, priority, record=False,
                             validate=True, **kw)


def test_validate_param_smoke(sched):
    _, port = sched
    res = port.engine.schedule(port.alloc, "latency", validate=True)
    assert res.latency_cc > 0
    with pytest.raises(ValueError, match="record=True"):
        port.engine.schedule(port.alloc, "latency", record=False,
                             validate=True)


def test_unrecorded_trace_is_rejected(sched):
    ref, port = sched
    lite = port.engine.schedule(port.alloc, "latency", record=False)
    with pytest.raises(ValueError, match="record=True") as got:
        validate_trace(lite, port.graph, port.acc, workload=port.w)
    with pytest.raises(ValueError) as want:
        ref_validate(ref.engine.schedule(ref.alloc, "latency", record=False),
                     ref.graph, ref.acc, workload=ref.w)
    assert str(got.value) == str(want.value)


def _violations(sched, corrupt, **kw):
    """The same corruption of the port's and the reference's trace of one
    schedule: (port error, reference error), each raised by its package's
    detector."""
    ref, port = sched
    errors = []
    for side, check, error in ((port, validate_trace, TraceValidationError),
                               (ref, ref_validate, RefError)):
        res = side.engine.schedule(side.alloc, "latency", **kw)
        corrupt(res, side.graph)
        with pytest.raises(error) as exc:
            check(res, side.graph, side.acc, workload=side.w, **kw)
        errors.append(exc.value)
    got, want = errors
    assert (got.invariant, str(got)) == (want.invariant, str(want))
    assert str(got).startswith(f"[{got.invariant}] ")
    return got


def test_corrupt_core_overlap_named(sched):
    """Overlapping core occupancy fails as core-exclusivity, by name."""
    cores = []

    def corrupt(res, graph):
        core, ivs = next((c, iv) for c, iv in enumerate(res.core_intervals)
                         if len(iv) >= 2)
        (s0, e0, i0), (s1, e1, i1) = ivs[0], ivs[1]
        ivs[1] = ((s0 + e0) / 2, e1, i1)      # starts inside CN i0's window
        cores.append(core)

    exc = _violations(sched, corrupt, segment=False)
    assert exc.invariant == "core-exclusivity"
    assert f"core {cores[0]}" in str(exc)


def test_corrupt_reordered_dependency_named(sched):
    """A transfer landing after its consumer started fails as
    dependency-order, by name."""
    consumers = []

    def corrupt(res, graph):
        assert res.comm_intervals     # pingpong on a bus arch must transfer
        start = {i: s for ivs in res.core_intervals for s, e, i in ivs}
        s, e, u, v, b = res.comm_intervals[0]
        late = start[v] + 0.01 * res.latency_cc   # lands past the start
        res.comm_intervals[0] = (s, late, u, v, b)
        consumers.append(v)

    exc = _violations(sched, corrupt, segment=False)
    assert exc.invariant == "dependency-order"
    assert f"CN {consumers[0]}" in str(exc)


def test_corrupt_memory_overflow_named(sched):
    """An allocation past SRAM capacity fails as memory-capacity, by
    name."""
    def corrupt(res, graph):
        res.mem_events.append((res.latency_cc, 1e18, 0, "act"))

    exc = _violations(sched, corrupt)
    assert exc.invariant == "memory-capacity"
    assert "core 0" in str(exc)


def test_corrupt_negative_memory_named(sched):
    """Freeing more than was allocated fails as memory-capacity too."""
    def corrupt(res, graph):
        res.mem_events.insert(0, (0.0, -1e9, 0, "weight"))

    exc = _violations(sched, corrupt)
    assert exc.invariant == "memory-capacity"
    assert "goes negative" in str(exc)


def test_corrupt_segment_barrier_named(sched):
    """A CN starting before the previous fused stack drains fails as
    segment-monotonicity, by name."""
    def corrupt(res, graph):
        layer_of = graph.layer.tolist()
        for ivs in res.core_intervals:
            for k in range(1, len(ivs)):
                s, e, i = ivs[k]
                prev_end = ivs[k - 1][1]
                barrier = max((ee for civ in res.core_intervals
                               for ss, ee, jj in civ
                               if layer_of[jj] < layer_of[i]), default=0.0)
                # a start inside (prev core busy end, stack barrier) keeps
                # core-exclusivity intact but breaks the barrier
                if prev_end < barrier - 1e-3 * res.latency_cc:
                    ivs[k] = ((prev_end + barrier) / 2, e, i)
                    return
        raise AssertionError("no corruptible window found")

    exc = _violations(sched, corrupt, strict_layers=True)
    assert exc.invariant == "segment-monotonicity"
    assert "barrier" in str(exc)


def test_corrupt_bus_double_booking_named(sched):
    """Two transfers occupying the shared bus at once fail as
    channel-exclusivity, by name."""
    def corrupt(res, graph):
        assert res.comm_intervals
        res.comm_intervals.append(res.comm_intervals[0])

    exc = _violations(sched, corrupt, segment=False)
    assert exc.invariant == "channel-exclusivity"
    assert "shared bus" in str(exc)


def test_corrupt_dram_overlap_named(sched):
    """Two off-chip accesses on the one DRAM port at once fail as
    dram-exclusivity, by name."""
    def corrupt(res, graph):
        assert res.dram_intervals
        s, e, kind, b = res.dram_intervals[0]
        res.dram_intervals.append((s, e, kind, b))

    exc = _violations(sched, corrupt)
    assert exc.invariant == "dram-exclusivity"
    assert "DRAM port" in str(exc)


def test_report_contents(sched):
    ref, port = sched
    res = port.engine.schedule(port.alloc, "latency")
    report = validate_trace(res, port.graph, port.acc, workload=port.w)
    assert report["cns"] == port.graph.n
    assert report["edges"] > 0
    assert report["channels"] == 1         # flat bus
    assert report["skipped"] == []
    # without the workload the segment partition cannot be re-derived
    report2 = validate_trace(res, port.graph, port.acc)
    assert report2["skipped"] == ["segment-monotonicity (needs workload)"]
    want = ref.engine.schedule(ref.alloc, "latency")
    assert report == ref_validate(want, ref.graph, ref.acc, workload=ref.w)
    assert report2 == ref_validate(want, ref.graph, ref.acc)
