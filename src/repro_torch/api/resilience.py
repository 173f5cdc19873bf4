"""Resilience primitives for the sweep runtime: deterministic retries,
quarantine records, and seeded fault injection.

A long design-space sweep must not lose points silently or abort on the
first worker death.  This module holds the pure pieces the executors in
`repro_torch.api.session` and the shard runtime in `repro_torch.api.distributed`
compose into a fault-tolerant pipeline:

- `RetryPolicy` — a retry budget with *seeded deterministic* backoff: the
  delay before attempt `a` of point `key` is a pure function of
  `(seed, key, a)`, never of wall-clock randomness, so a retried sweep
  replays identically.
- `FailureRecord` — the content-keyed quarantine record of a point that
  exhausted its retry budget (error type, message, traceback, attempt
  count, full spec).  Persisted to ``failures.jsonl`` beside the result
  store so no point is ever lost without a trace.
- `FaultInjector` — a seeded, stateless fault schedule: whether point
  `key` faults on attempt `a` (and how: exception, worker kill, delay,
  or store corruption) is a pure function of the injector's config, so
  every recovery path is testable and two runs under the same schedule
  quarantine exactly the same points.
- `PointOutcome` — the per-point envelope executors yield: a healthy
  `ExplorationRecord` *or* a `FailureRecord`, plus the retry count.

The invariant all of this protects (golden-tested in
`tests/test_resilience.py`): under any injected fault schedule that stays
within the retry budget, the healthy record set of a sweep — serial,
process-pool, or sharded + merged — is bit-identical to a fault-free
serial run, because every record is a deterministic function of its point
spec alone.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import time
import traceback as _traceback
from typing import Mapping


class InjectedFault(RuntimeError):
    """An exception raised on purpose by a `FaultInjector` schedule."""


class StoreCorruptionError(RuntimeError):
    """A result store file has malformed lines *before* its final line.

    A torn final line is the expected signature of a crash mid-append and
    is silently dropped (and truncated away); anything malformed earlier
    in the file means real corruption and must not be ignored — load the
    store with ``repair=True`` to quarantine the bad lines to a ``.bad``
    sidecar instead."""


class StoreLockError(RuntimeError):
    """The advisory store-file lock could not be taken."""


def _unit_hash(*parts) -> float:
    """Deterministic uniform draw in [0, 1) from the given parts.

    A pure function of its inputs (SHA-256, no process state), so every
    process — parent, pool worker, shard on another machine — agrees on
    the same draw for the same (seed, kind, key, attempt).

        >>> _unit_hash(0, "exception", "k", 0) == _unit_hash(
        ...     0, "exception", "k", 0)
        True
        >>> 0.0 <= _unit_hash(1, "kill", "k", 3) < 1.0
        True
    """
    blob = "|".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget with seeded deterministic backoff.

    `max_attempts` is the *total* number of tries per point (1 = no
    retries).  The backoff before retry attempt `a` grows geometrically
    from `backoff_s` and is jittered by a hash of `(seed, key, a)` — not
    by a wall-clock RNG — so two runs of the same sweep sleep identically
    and the retried record stream stays reproducible.

        >>> p = RetryPolicy(max_attempts=3, backoff_s=1.0, jitter=0.5, seed=7)
        >>> p.should_retry(1), p.should_retry(2), p.should_retry(3)
        (True, True, False)
        >>> p.delay_s("point", 1) == RetryPolicy(
        ...     max_attempts=3, backoff_s=1.0, jitter=0.5, seed=7
        ...     ).delay_s("point", 1)                     # pure, no wall clock
        True
        >>> RetryPolicy().max_attempts, RetryPolicy().delay_s("point", 1)
        (1, 0.0)
    """

    max_attempts: int = 1
    backoff_s: float = 0.0
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.0              # fraction of the delay, in [0, 1]
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")

    def should_retry(self, attempts_done: int) -> bool:
        """True while the budget allows another try after `attempts_done`."""
        return attempts_done < self.max_attempts

    def delay_s(self, key: str, attempt: int) -> float:
        """Backoff before retry `attempt` (1-based) of point `key`."""
        if self.backoff_s <= 0.0:
            return 0.0
        base = min(self.backoff_s * self.backoff_multiplier ** (attempt - 1),
                   self.max_backoff_s)
        if self.jitter <= 0.0:
            return base
        u = _unit_hash(self.seed, "backoff", key, attempt)
        return base * (1.0 + self.jitter * (u - 0.5))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "RetryPolicy":
        return cls(**dict(d))


NO_RETRY = RetryPolicy()


@dataclasses.dataclass(frozen=True)
class FailureRecord:
    """Quarantine record of a point that exhausted its retry budget.

    Content-keyed by the point's `content_key()` — the same key a healthy
    `ExplorationRecord` would carry — and holding everything needed to
    diagnose or re-dispatch the point: error type, message, traceback,
    how many attempts were burned, and the full point spec.

        >>> f = FailureRecord(key="k", workload="w", arch="A",
        ...                   error_type="ValueError", message="boom",
        ...                   traceback="...", attempts=3)
        >>> FailureRecord.from_dict(f.to_dict()) == f
        True
    """

    key: str
    workload: str
    arch: str
    error_type: str
    message: str
    traceback: str
    attempts: int
    spec: dict | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "FailureRecord":
        d = dict(d)
        d["attempts"] = int(d["attempts"])
        return cls(**d)

    @classmethod
    def from_exception(cls, point, exc: BaseException,
                       attempts: int) -> "FailureRecord":
        """Build a quarantine record from a `DesignPoint` and an exception."""
        return cls(
            key=point.content_key(), workload=point.workload_name,
            arch=point.arch.name, error_type=type(exc).__name__,
            message=str(exc),
            traceback="".join(_traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
            attempts=attempts, spec=point.spec_dict())


@dataclasses.dataclass
class PointOutcome:
    """What an executor yields per design point: a record *or* a failure.

    Exactly one of `record` / `failure` is set.  `n_retries` counts the
    extra attempts burned on the way (0 for a clean first try) so
    `SweepResult.n_retried` can report recovery work without polluting
    the content-keyed records themselves (a retried record must stay
    bit-identical to a first-try one).

        >>> o = PointOutcome(key="k", n_retries=1)
        >>> o.ok, PointOutcome.from_jsonable(o.to_jsonable()).n_retries
        (False, 1)
    """

    key: str
    record: "object | None" = None       # ExplorationRecord
    failure: FailureRecord | None = None
    n_retries: int = 0

    @property
    def ok(self) -> bool:
        return self.record is not None

    def to_jsonable(self) -> dict:
        return {"key": self.key,
                "record": self.record.to_dict() if self.record else None,
                "failure": self.failure.to_dict() if self.failure else None,
                "n_retries": self.n_retries}

    @classmethod
    def from_jsonable(cls, d: Mapping) -> "PointOutcome":
        from repro_torch.api.session import ExplorationRecord
        return cls(key=str(d["key"]),
                   record=ExplorationRecord.from_dict(d["record"])
                   if d.get("record") else None,
                   failure=FailureRecord.from_dict(d["failure"])
                   if d.get("failure") else None,
                   n_retries=int(d.get("n_retries", 0)))


# fault kinds checked in priority order: at most one fires per attempt
_COMPUTE_FAULTS = ("kill", "exception", "delay")


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """Seeded deterministic fault schedule at point granularity.

    Whether point `key` faults on attempt `a` — and how — is a pure
    function of the injector's config: `plan(key, a)` hashes
    `(seed, kind, key, a)` against the per-kind rate, checking kinds in
    the fixed priority order kill > exception > delay, so at most one
    compute fault fires per attempt.  Being stateless and picklable, the
    *same* schedule is visible to the parent process, every pool worker,
    and every shard — which is what lets the process executor attribute a
    dead pool to the exact point that was planned to die.

    Fault kinds:

    - ``exception`` — raise `InjectedFault` before computing the point.
    - ``kill`` — SIGKILL the executing process (pool workers only; in a
      serial executor it degrades to an `InjectedFault`, since killing
      the orchestrating process is the crash-restart test's job).
    - ``delay`` — sleep `delay_s` before computing (not a failure by
      itself; with a process-executor deadline it becomes a straggler
      that gets re-dispatched).
    - ``corrupt`` — tear the store append for the point's record
      (`plan_corrupt`), simulating a crash mid-write.

    `max_faults_per_point` gates every kind by attempt index: attempts
    ``>= max_faults_per_point`` never fault, guaranteeing recovery
    whenever the retry budget allows that many extra tries — the knob the
    golden bit-identity tests rely on.

        >>> inj = FaultInjector(seed=0, exception_rate=1.0,
        ...                     max_faults_per_point=2)
        >>> [inj.plan("p", a) for a in range(4)]
        ['exception', 'exception', None, None]
        >>> inj.plan("p", 0) == FaultInjector(
        ...     seed=0, exception_rate=1.0, max_faults_per_point=2
        ...     ).plan("p", 0)                     # pure: no process state
        True
        >>> FaultInjector(seed=0).plan("p", 0) is None   # all rates default 0
        True
    """

    seed: int = 0
    exception_rate: float = 0.0
    kill_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.05
    corrupt_rate: float = 0.0
    max_faults_per_point: int | None = None

    def _gated(self, attempt: int) -> bool:
        return (self.max_faults_per_point is not None
                and attempt >= self.max_faults_per_point)

    def plan(self, key: str, attempt: int) -> str | None:
        """The compute fault (if any) for `(key, attempt)` — pure."""
        if self._gated(attempt):
            return None
        for kind in _COMPUTE_FAULTS:
            rate = getattr(self, f"{kind}_rate")
            if rate > 0.0 and _unit_hash(self.seed, kind, key, attempt) < rate:
                return kind
        return None

    def plan_corrupt(self, key: str, attempt: int) -> bool:
        """Whether store-append `attempt` for `key`'s record is torn."""
        if self._gated(attempt):
            return False
        return (self.corrupt_rate > 0.0 and
                _unit_hash(self.seed, "corrupt", key, attempt)
                < self.corrupt_rate)

    def fire(self, key: str, attempt: int, allow_kill: bool = False) -> None:
        """Execute the planned compute fault for `(key, attempt)`, if any.

        Raises `InjectedFault` for exception faults (and for kill faults
        when `allow_kill` is False), SIGKILLs the current process for kill
        faults when `allow_kill` is True (pool workers), and sleeps for
        delay faults.  Returns normally when nothing is planned."""
        kind = self.plan(key, attempt)
        if kind is None:
            return
        if kind == "kill":
            if allow_kill:
                os.kill(os.getpid(), signal.SIGKILL)  # pragma: no cover
            raise InjectedFault(
                f"injected worker kill for {key} attempt {attempt} "
                "(degraded to an exception in the serial executor)")
        if kind == "exception":
            raise InjectedFault(f"injected exception for {key} "
                                f"attempt {attempt}")
        time.sleep(self.delay_s)       # "delay": a straggler, not a failure

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "FaultInjector":
        return cls(**dict(d))
