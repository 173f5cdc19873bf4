"""Closed-loop serving simulator: continuous batching over scheduled costs.

The Stream engine prices one inference; this module answers the load
question — "what p99 latency and energy-per-request does a topology
sustain at a given arrival rate, and what's the max QPS within an SLO?".

The model is a deliberately compact vLLM-style loop over *scheduled*
phase costs (`PhaseCosts`, produced by scheduling the prefill and decode
workloads through the ordinary Stream pipeline):

* requests arrive on a deterministic trace (`repro_torch.serve.arrivals`) and
  wait FIFO for one of `batch_slots` slots;
* admission happens at engine-step boundaries; every newly admitted
  request prefills in one batched step of `prefill_cc` cycles (prefill
  has priority over decode — the head-of-line effect is modeled);
* each decode step advances *all* active slots one token in `decode_cc`
  cycles (weights/KV are read once per step for the whole batch, so step
  latency is occupancy-independent — the continuous-batching win — while
  energy is charged per active request);
* a request completes when its `decode_tokens` are out (single-phase
  workloads complete right after prefill), freeing its slot.

Everything is a pure function of (trace, costs, batch_slots): replaying
a trace is bit-identical, and at vanishing load a request's latency
degenerates to exactly the one-shot scheduled latency
``prefill_cc + decode_tokens * decode_cc`` — the simulator's anchor to
`evaluate_allocation`, pinned by tests and the bench's inline assert.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Iterable, Mapping, Sequence

from repro_torch.serve.arrivals import RequestSpec, validate_trace
from repro_torch.serve.batching import SlotBatcher


@dataclasses.dataclass(frozen=True)
class PhaseCosts:
    """Scheduled cost of one serving phase pair on one architecture.

    `prefill_cc`/`prefill_pj` price one batched prompt pass per request;
    `decode_cc`/`decode_pj` price one token step (0.0 for single-phase
    workloads, whose requests finish at prefill).

        >>> c = PhaseCosts(prefill_cc=100.0, prefill_pj=5.0,
        ...                decode_cc=10.0, decode_pj=1.0)
        >>> c.request_latency_cc(decode_tokens=16)
        260.0
        >>> c.request_energy_pj(decode_tokens=16)
        21.0
    """

    prefill_cc: float
    prefill_pj: float
    decode_cc: float = 0.0
    decode_pj: float = 0.0

    def __post_init__(self):
        if self.prefill_cc <= 0.0:
            raise ValueError(f"prefill_cc must be > 0, got {self.prefill_cc}")
        if self.decode_cc < 0.0 or self.prefill_pj < 0.0 or self.decode_pj < 0.0:
            raise ValueError("phase costs must be non-negative")

    def request_latency_cc(self, decode_tokens: int) -> float:
        """Unloaded (zero-queueing) request latency: the one-shot anchor."""
        return self.prefill_cc + decode_tokens * self.decode_cc

    def request_energy_pj(self, decode_tokens: int) -> float:
        return self.prefill_pj + decode_tokens * self.decode_pj


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """Per-request accounting of one simulation (pure data).

        >>> o = RequestOutcome(rid=0, t_arrive_cc=0.0, t_admit_cc=0.0,
        ...                    t_done_cc=260.0, energy_pj=21.0)
        >>> o.latency_cc, o.queue_cc
        (260.0, 0.0)
    """

    rid: int
    t_arrive_cc: float
    t_admit_cc: float
    t_done_cc: float
    energy_pj: float

    @property
    def latency_cc(self) -> float:
        return self.t_done_cc - self.t_arrive_cc

    @property
    def queue_cc(self) -> float:
        return self.t_admit_cc - self.t_arrive_cc


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile over pre-sorted values (numpy's
    default method, inlined so the result is a pure float computation).

        >>> _percentile([1.0, 2.0, 3.0, 4.0], 50.0)
        2.5
        >>> _percentile([5.0], 99.0)
        5.0
    """
    n = len(sorted_vals)
    if n == 1:
        return float(sorted_vals[0])
    pos = (n - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


@dataclasses.dataclass(frozen=True)
class ServingSimResult:
    """Outcome of one closed-loop simulation: per-request outcomes plus
    the loop's occupancy/step accounting.

    Aggregates are exposed as methods so the one latency distribution
    serves every SLO cheaply (`slo_attainment` is just a count).

        >>> costs = PhaseCosts(prefill_cc=100.0, prefill_pj=2.0)
        >>> from repro_torch.serve.arrivals import uniform_trace
        >>> r = simulate(uniform_trace(0.0, 4, decode_tokens=0), costs,
        ...              batch_slots=2)   # 4 at once into 2 slots: 2 rounds
        >>> r.n_requests, r.max_active, r.p50_latency_cc()
        (4, 2, 150.0)
        >>> r.slo_attainment(slo_cc=200.0)
        1.0
        >>> r.qps(clock_hz=1e9) > 0
        True
    """

    requests: tuple[RequestOutcome, ...]
    batch_slots: int
    max_active: int          # peak slot occupancy (<= batch_slots, always)
    n_prefill_steps: int
    n_decode_steps: int
    makespan_cc: float       # first arrival -> last completion
    steps: tuple = ()        # per engine step: (t0, t1, kind, n_active)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def latencies_cc(self) -> tuple[float, ...]:
        return tuple(r.latency_cc for r in self.requests)

    def p50_latency_cc(self) -> float:
        return _percentile(sorted(self.latencies_cc()), 50.0)

    def p99_latency_cc(self) -> float:
        return _percentile(sorted(self.latencies_cc()), 99.0)

    def mean_latency_cc(self) -> float:
        lats = self.latencies_cc()
        return sum(lats) / len(lats)

    def energy_per_request_pj(self) -> float:
        return sum(r.energy_pj for r in self.requests) / len(self.requests)

    def slo_attainment(self, slo_cc: float) -> float:
        """Fraction of requests whose end-to-end latency met the SLO."""
        ok = sum(1 for r in self.requests if r.latency_cc <= slo_cc)
        return ok / len(self.requests)

    def qps(self, clock_hz: float = 1e9) -> float:
        """Sustained request throughput over the makespan, in req/s."""
        if self.makespan_cc <= 0.0:
            return float("inf")
        return len(self.requests) / (self.makespan_cc / clock_hz)

    def to_dict(self) -> dict:
        return {
            "batch_slots": self.batch_slots, "max_active": self.max_active,
            "n_prefill_steps": self.n_prefill_steps,
            "n_decode_steps": self.n_decode_steps,
            "makespan_cc": self.makespan_cc,
            "requests": [dataclasses.asdict(r) for r in self.requests],
            "steps": [list(s) for s in self.steps],
        }


def simulate(trace: Iterable[RequestSpec], costs: PhaseCosts,
             batch_slots: int = 4, tracer=None) -> ServingSimResult:
    """Run the continuous-batching loop over one arrival trace.

    Deterministic: a pure function of (trace, costs, batch_slots) — same
    inputs, bit-identical `ServingSimResult` (the trace-replay contract).
    An optional sim-time `tracer` (repro_torch.obs) observes step counts; it
    never changes the result — outputs are bit-identical with or without
    it.  Every engine step is recorded in `result.steps` as
    ``(t0, t1, kind, n_active)`` for the trace exporter's engine lane.

        >>> from repro_torch.serve.arrivals import uniform_trace
        >>> costs = PhaseCosts(prefill_cc=100.0, prefill_pj=4.0,
        ...                    decode_cc=10.0, decode_pj=1.0)
        >>> lone = simulate(uniform_trace(0.0, 1, decode_tokens=8), costs, 4)
        >>> lone.requests[0].latency_cc == costs.request_latency_cc(8)
        True
        >>> lone.requests[0].energy_pj == costs.request_energy_pj(8)
        True
    """
    trace = validate_trace(trace)
    if batch_slots < 1:
        raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
    single_phase = costs.decode_cc == 0.0
    batcher = SlotBatcher(batch_slots)
    t = 0.0
    head = 0                              # next trace index to admit
    tokens_left: dict[int, int] = {}      # rid -> decode tokens remaining
    admit_at: dict[int, float] = {}
    energy: dict[int, float] = {}
    done: dict[int, float] = {}
    n_prefill_steps = n_decode_steps = 0
    steps: list[tuple[float, float, str, int]] = []

    while head < len(trace) or batcher.active():
        if not batcher.active():
            t = max(t, trace[head].t_arrive_cc)   # idle: jump to arrival
        # admission at the step boundary: FIFO arrivals into free slots
        admitted: list[RequestSpec] = []
        while head < len(trace) and trace[head].t_arrive_cc <= t \
                and batcher.free_slots() > 0:
            req = trace[head]
            batcher.admit(req.rid)
            admitted.append(req)
            head += 1
        if admitted:
            # one batched prefill step for everything admitted this round;
            # ongoing decoders stall for it (head-of-line prefill priority)
            t_end = t + costs.prefill_cc
            n_prefill_steps += 1
            for req in admitted:
                admit_at[req.rid] = t
                energy[req.rid] = costs.prefill_pj
                left = 0 if single_phase else req.decode_tokens
                if left == 0:
                    done[req.rid] = t_end
                    batcher.release(req.rid)
                else:
                    tokens_left[req.rid] = left
            steps.append((t, t_end, "prefill", len(batcher.active())
                          + sum(1 for r in admitted if r.rid in done)))
            t = t_end
            continue   # arrivals may have landed during prefill: re-admit
        # decode step: every active slot advances one token
        t_end = t + costs.decode_cc
        n_decode_steps += 1
        active = batcher.active()
        steps.append((t, t_end, "decode", len(active)))
        for rid in active:
            energy[rid] += costs.decode_pj
            tokens_left[rid] -= 1
            if tokens_left[rid] == 0:
                del tokens_left[rid]
                done[rid] = t_end
                batcher.release(rid)
        t = t_end

    outcomes = tuple(
        RequestOutcome(rid=req.rid, t_arrive_cc=req.t_arrive_cc,
                       t_admit_cc=admit_at[req.rid], t_done_cc=done[req.rid],
                       energy_pj=energy[req.rid])
        for req in trace)
    if tracer is not None:
        tracer.count("serving.requests", len(outcomes))
        tracer.count("serving.prefill_steps", n_prefill_steps)
        tracer.count("serving.decode_steps", n_decode_steps)
        for o in outcomes:
            tracer.observe("serving.latency_cc", o.latency_cc)
    return ServingSimResult(
        requests=outcomes, batch_slots=batch_slots,
        max_active=batcher.max_active, n_prefill_steps=n_prefill_steps,
        n_decode_steps=n_decode_steps,
        makespan_cc=max(o.t_done_cc for o in outcomes)
        - min(o.t_arrive_cc for o in outcomes),
        steps=tuple(steps))


# ---------------------------------------------------------------------------
# serving sweep records: one row per (design point, arrival rate, SLO)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingRecord:
    """One point of an SLO-vs-QPS curve (serializable, content-keyed).

        >>> r = _demo_serving_record()
        >>> ServingRecord.from_dict(r.to_dict()) == r
        True
        >>> r.metric("p99_ms"), r.metric("qps")
        (0.2, 500.0)
    """

    key: str
    workload: str
    arch: str
    granularity: str
    priority: str
    rate_rps: float
    slo_ms: float
    batch_slots: int
    n_requests: int
    seed: int
    clock_ghz: float
    p50_ms: float
    p99_ms: float
    mean_ms: float
    energy_per_request_pj: float
    qps: float                  # sustained throughput over the makespan
    slo_attainment: float       # fraction of requests within slo_ms
    prefill_cc: float
    decode_cc: float
    decode_tokens: int

    def metric(self, name: str) -> float:
        return float(getattr(self, name))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServingRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _demo_serving_record() -> ServingRecord:
    return ServingRecord(
        key="k", workload="w", arch="A", granularity="layer",
        priority="latency", rate_rps=100.0, slo_ms=50.0, batch_slots=4,
        n_requests=8, seed=0, clock_ghz=1.0, p50_ms=0.1, p99_ms=0.2,
        mean_ms=0.12, energy_per_request_pj=9.0, qps=500.0,
        slo_attainment=1.0, prefill_cc=100.0, decode_cc=10.0,
        decode_tokens=16)


def serving_record_key(point_key: str, decode_key: "str | None",
                       rate_rps: float, slo_ms: float, batch_slots: int,
                       n_requests: int, seed: int, clock_ghz: float,
                       decode_tokens: int) -> str:
    """Content key of one serving-curve row: the phase-point identity plus
    every simulation parameter (identical keys => identical metrics, the
    same promise `DesignPoint.content_key` makes for one-shot records).

        >>> a = serving_record_key("p", "d", 100.0, 50.0, 4, 8, 0, 1.0, 16)
        >>> a == serving_record_key("p", "d", 100.0, 50.0, 4, 8, 0, 1.0, 16)
        True
        >>> a != serving_record_key("p", "d", 200.0, 50.0, 4, 8, 0, 1.0, 16)
        True
    """
    blob = json.dumps({
        "point": point_key, "decode": decode_key, "rate_rps": rate_rps,
        "slo_ms": slo_ms, "batch_slots": batch_slots,
        "n_requests": n_requests, "seed": seed, "clock_ghz": clock_ghz,
        "decode_tokens": decode_tokens}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


@dataclasses.dataclass
class ServingSweepResult:
    """Records of a serving sweep (walk order) plus curve queries.

        >>> rows = [_demo_serving_record()]
        >>> sweep = ServingSweepResult(records=rows, n_scheduled=2,
        ...                            n_from_store=0, wall_s=0.0)
        >>> sweep.curve("w", "A")[0].rate_rps
        100.0
        >>> sweep.max_qps_within_slo("w", "A", slo_ms=50.0)
        100.0
        >>> len(sweep)
        1
    """

    records: list[ServingRecord]
    n_scheduled: int            # phase points actually scheduled
    n_from_store: int           # phase points served from the store
    wall_s: float

    def __len__(self) -> int:
        return len(self.records)

    def curve(self, workload: str, arch: str,
              slo_ms: "float | None" = None) -> list[ServingRecord]:
        """The (rate -> metrics) rows of one workload x arch, rate-sorted."""
        rows = [r for r in self.records
                if r.workload == workload and r.arch == arch
                and (slo_ms is None or r.slo_ms == slo_ms)]
        return sorted(rows, key=lambda r: (r.rate_rps, r.slo_ms))

    def max_qps_within_slo(self, workload: str, arch: str, slo_ms: float,
                           attainment: float = 0.99) -> "float | None":
        """Highest swept arrival rate meeting the SLO for >= `attainment`
        of requests — the paper-style "max QPS within 50 ms" headline.
        None when no swept rate meets it."""
        ok = [r.rate_rps for r in self.curve(workload, arch, slo_ms)
              if r.slo_attainment >= attainment]
        return max(ok) if ok else None

    def to_dict(self) -> dict:
        return {"n_scheduled": self.n_scheduled,
                "n_from_store": self.n_from_store, "wall_s": self.wall_s,
                "records": [r.to_dict() for r in self.records]}
