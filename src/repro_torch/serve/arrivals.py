"""Deterministic request-arrival streams for the serving simulator.

A request trace is a tuple of `RequestSpec`s sorted by arrival time.  The
Poisson generator draws every interarrival gap from a pure SHA-256 hash of
``(seed, "gap", index)`` — no process-global RNG, no wall clock — so the
same ``(rate, n, seed)`` triple reproduces the identical trace in every
process, on every machine, forever (the same contract
`repro_torch.api.resilience.FaultInjector` holds for fault schedules).  Traces
round-trip through JSON (`trace_to_jsonable` / `trace_from_jsonable`), so
a recorded trace replays bit-identically.

Times are in clock cycles (the scheduler's unit); `cycles_per_second`
converts an operator-facing requests-per-second rate into the cycle
domain once, at generation time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Iterable, Mapping, Sequence


def unit_hash(*parts) -> float:
    """Deterministic uniform draw in [0, 1) from the given parts.

    A pure function of its inputs (SHA-256 over the ``|``-joined string
    forms, no process state), so arrival streams are replayable anywhere.

        >>> unit_hash(0, "gap", 3) == unit_hash(0, "gap", 3)
        True
        >>> 0.0 <= unit_hash(7, "gap", 0) < 1.0
        True
    """
    blob = "|".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One inference request of a serving trace (pure data, picklable).

    `prompt_tokens` / `decode_tokens` describe the two LLM phases; a
    single-phase workload (one-shot CNN inference) uses
    ``decode_tokens=0`` and the prefill phase *is* the whole inference.

        >>> r = RequestSpec(rid=0, t_arrive_cc=0.0, prompt_tokens=64,
        ...                 decode_tokens=16)
        >>> RequestSpec.from_dict(r.to_dict()) == r
        True
    """

    rid: int
    t_arrive_cc: float
    prompt_tokens: int = 64
    decode_tokens: int = 16

    def to_dict(self) -> dict:
        return {"rid": self.rid, "t_arrive_cc": self.t_arrive_cc,
                "prompt_tokens": self.prompt_tokens,
                "decode_tokens": self.decode_tokens}

    @classmethod
    def from_dict(cls, d: Mapping) -> "RequestSpec":
        return cls(rid=int(d["rid"]), t_arrive_cc=float(d["t_arrive_cc"]),
                   prompt_tokens=int(d["prompt_tokens"]),
                   decode_tokens=int(d["decode_tokens"]))


def poisson_trace(rate_rps: float, n_requests: int, *, seed: int = 0,
                  clock_hz: float = 1e9, prompt_tokens: int = 64,
                  decode_tokens: int = 16) -> tuple[RequestSpec, ...]:
    """Seeded Poisson arrival trace: `n_requests` requests at `rate_rps`.

    Interarrival gaps are exponential draws ``-ln(1 - u) / rate`` with
    ``u = unit_hash(seed, "gap", i)``, converted to cycles at `clock_hz`.
    The *same* seed therefore yields the same normalized gap sequence at
    every rate — arrival times scale exactly as ``1/rate``, which is what
    makes SLO-vs-QPS curves comparable across the rate axis (each rate
    replays the same workload, compressed in time).

        >>> t = poisson_trace(100.0, 3, seed=0)
        >>> t == poisson_trace(100.0, 3, seed=0)        # replayable
        True
        >>> [r.rid for r in t], t[0].t_arrive_cc == 0.0
        ([0, 1, 2], True)
        >>> all(a.t_arrive_cc <= b.t_arrive_cc for a, b in zip(t, t[1:]))
        True
        >>> fast = poisson_trace(200.0, 3, seed=0)      # 2x rate => 2x early
        >>> fast[2].t_arrive_cc * 2 == t[2].t_arrive_cc
        True
    """
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    cycles_per_req = clock_hz / rate_rps
    out, t = [], 0.0
    for i in range(n_requests):
        if i > 0:   # first request arrives at t=0: the curve's zero point
            u = unit_hash(seed, "gap", i)
            t += -math.log(1.0 - u) * cycles_per_req
        out.append(RequestSpec(rid=i, t_arrive_cc=t,
                               prompt_tokens=prompt_tokens,
                               decode_tokens=decode_tokens))
    return tuple(out)


def uniform_trace(gap_cc: float, n_requests: int, *, prompt_tokens: int = 64,
                  decode_tokens: int = 16) -> tuple[RequestSpec, ...]:
    """Fixed-gap arrival trace (closed-form QPS: one request per `gap_cc`).

        >>> [r.t_arrive_cc for r in uniform_trace(10.0, 3)]
        [0.0, 10.0, 20.0]
    """
    if gap_cc < 0.0:
        raise ValueError(f"gap_cc must be >= 0, got {gap_cc}")
    return tuple(RequestSpec(rid=i, t_arrive_cc=i * gap_cc,
                             prompt_tokens=prompt_tokens,
                             decode_tokens=decode_tokens)
                 for i in range(n_requests))


def validate_trace(trace: Sequence[RequestSpec]) -> tuple[RequestSpec, ...]:
    """Check a trace is non-empty, time-sorted, and densely id'd.

    Returns the trace as a tuple; raises `ValueError` otherwise.  The
    simulator admits requests FIFO by arrival, so a mis-sorted trace would
    silently change queueing behavior — it is rejected instead.

        >>> validate_trace(uniform_trace(5.0, 2))[1].rid
        1
        >>> validate_trace([])
        Traceback (most recent call last):
            ...
        ValueError: empty trace
    """
    trace = tuple(trace)
    if not trace:
        raise ValueError("empty trace")
    for i, req in enumerate(trace):
        if req.rid != i:
            raise ValueError(f"trace rids must be 0..n-1 in order; "
                             f"position {i} holds rid {req.rid}")
        if req.t_arrive_cc < 0 or not math.isfinite(req.t_arrive_cc):
            raise ValueError(f"request {i}: bad arrival {req.t_arrive_cc}")
        if i and req.t_arrive_cc < trace[i - 1].t_arrive_cc:
            raise ValueError(f"trace not sorted by arrival at position {i}")
        if req.decode_tokens < 0 or req.prompt_tokens < 0:
            raise ValueError(f"request {i}: negative token counts")
    return trace


def trace_to_jsonable(trace: Iterable[RequestSpec]) -> list[dict]:
    """JSON form of a trace (the replay file format).

        >>> trace_to_jsonable(uniform_trace(1.0, 1))[0]["rid"]
        0
    """
    return [r.to_dict() for r in trace]


def trace_from_jsonable(data: Iterable[Mapping]) -> tuple[RequestSpec, ...]:
    """Rebuild a trace from its JSON form, re-validated.

        >>> t = poisson_trace(50.0, 4, seed=3)
        >>> trace_from_jsonable(trace_to_jsonable(t)) == t
        True
    """
    return validate_trace([RequestSpec.from_dict(d) for d in data])
