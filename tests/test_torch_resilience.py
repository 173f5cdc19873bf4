"""The port's fault-tolerant sweep runtime equals the JAX package's under
the same seeded fault schedules: `_unit_hash`, retry backoffs and
`FaultInjector` plans are equal; serial exception and store-corruption
schedules, process-pool worker kills and straggler deadlines give the
reference's records, retry counts and `FailureRecord`s (whose traceback
is compared by its last line, the exception's module renamed: the frames
above it name each package's own files)."""
import time

import pytest
from _torch_dse import contents, failure_content, spaces

import repro.api as R
from repro.api.resilience import _unit_hash as ref_unit_hash

import repro_torch.api as T
from repro_torch.api.resilience import _unit_hash

SPACE = dict(workloads=["fsrcnn"],
             archs={"SC:TPU": "sc_tpu", "SC:Eye": "sc_eye",
                    "MC:HomTPU": "mc_hom_tpu"},
             granularities=["layer", ("tile", 8, 1)],
             pop_size=4, generations=2)
KEYS = [f"point{i}" for i in range(64)]


@pytest.fixture(scope="module")
def pair():
    return spaces(**SPACE)


@pytest.fixture(scope="module")
def golden(pair):
    """The reference's fault-free serial records."""
    return R.ExplorationSession().run(pair[0])


def _run(api, space, executor="serial", cache_dir=None, attempts=None,
         **inj):
    sess = api.ExplorationSession(
        cache_dir=cache_dir,
        retry_policy=api.RetryPolicy(max_attempts=attempts)
        if attempts else None,
        fault_injector=api.FaultInjector(**inj))
    return sess.run(space, executor=executor, max_workers=2)


def _summary(sweep):
    return (contents(sweep.records), sweep.n_retried, sweep.n_failed,
            [failure_content(f) for f in sweep.failures])


def test_unit_hash_backoff_and_plans_equal():
    assert [_unit_hash(s, "exception", k, a) for s in (0, 7) for k in KEYS
            for a in range(3)] == \
        [ref_unit_hash(s, "exception", k, a) for s in (0, 7) for k in KEYS
         for a in range(3)]
    for kw in (dict(max_attempts=4, backoff_s=0.5, jitter=0.8, seed=11),
               dict(max_attempts=3, backoff_s=0.01, seed=2)):
        got, want = T.RetryPolicy(**kw), R.RetryPolicy(**kw)
        assert got.to_dict() == want.to_dict()
        assert [got.delay_s(k, a) for k in KEYS for a in (1, 2, 3)] == \
            [want.delay_s(k, a) for k in KEYS for a in (1, 2, 3)]
    kw = dict(seed=3, exception_rate=0.5, kill_rate=0.25, delay_rate=0.25,
              corrupt_rate=0.3, max_faults_per_point=2)
    got, want = T.FaultInjector(**kw), R.FaultInjector(**kw)
    assert [(got.plan(k, a), got.plan_corrupt(k, a)) for k in KEYS
            for a in range(4)] == \
        [(want.plan(k, a), want.plan_corrupt(k, a)) for k in KEYS
         for a in range(4)]


@pytest.mark.parametrize("schedule", [
    dict(attempts=3, seed=1, exception_rate=0.5, max_faults_per_point=2),
    dict(attempts=2, seed=9, exception_rate=0.5),
    dict(seed=0, exception_rate=1.0),
], ids=["recovered", "partial-quarantine", "all-quarantined"])
def test_serial_exception_schedule_equals_reference(pair, golden, schedule):
    got = _run(T, pair[1], **schedule)
    want = _run(R, pair[0], **schedule)
    assert _summary(got) == _summary(want)
    healthy = {r["key"]: r for r in contents(golden.records)}
    assert all(healthy[r["key"]] == r for r in contents(got.records))
    assert len(got.records) + got.n_failed == len(golden.records)


def test_store_corruption_schedule_equals_reference(pair, golden, tmp_path):
    kw = dict(attempts=3, seed=5, corrupt_rate=0.5, max_faults_per_point=2)
    got = _run(T, pair[1], cache_dir=str(tmp_path / "port"), **kw)
    want = _run(R, pair[0], cache_dir=str(tmp_path / "ref"), **kw)
    assert _summary(got) == _summary(want) and got.n_retried > 0
    assert contents(got.records) == contents(golden.records)
    assert T.ResultStore(str(tmp_path / "port")).verify() == \
        R.ResultStore(str(tmp_path / "ref")).verify()


@pytest.mark.parametrize("schedule", [
    dict(attempts=2, seed=3, kill_rate=1.0, max_faults_per_point=1),
    dict(attempts=3, seed=7, exception_rate=0.4, kill_rate=0.3,
         max_faults_per_point=2),
], ids=["kills", "mixed"])
def test_process_pool_fault_schedule_equals_reference(pair, golden,
                                                      schedule):
    got = _run(T, pair[1], executor="process", **schedule)
    assert got.n_failed == 0
    assert contents(got.records) == contents(golden.records)
    assert got.n_retried == _run(R, pair[0], executor="process",
                                 **schedule).n_retried


def test_process_pool_kill_without_budget_quarantines_as_reference(pair):
    kw = dict(seed=3, kill_rate=1.0)
    layer = spaces(**dict(SPACE, granularities=["layer"]))
    got = _run(T, layer[1], executor="process", **kw)
    want = _run(R, layer[0], executor="process", **kw)
    assert len(got.records) == 0 and got.n_failed == 3
    assert _summary(got) == _summary(want)


def test_deadline_redispatches_stragglers(golden):
    """The first attempt sleeps far past the deadline; the parent times out
    and re-dispatches to a freshly spawned worker, whose clean attempt wins.
    The deadline leaves that worker 12 s to start, import and compute, which
    holds under a loaded parallel test run; the straggler sleeps three
    deadlines, so finishing sooner shows it was not waited out."""
    one = spaces(**dict(SPACE, archs={"SC:TPU": "sc_tpu"},
                        granularities=["layer"]))
    deadline = 12.0
    sess = T.ExplorationSession(
        retry_policy=T.RetryPolicy(max_attempts=3),
        fault_injector=T.FaultInjector(seed=0, delay_rate=1.0,
                                       delay_s=3 * deadline,
                                       max_faults_per_point=1),
        deadline_s=deadline)
    t0 = time.monotonic()
    got = sess.run(one[1], executor="process", max_workers=2)
    assert got.n_failed == 0 and got.n_retried >= 1
    assert contents(got.records) == \
        contents(R.ExplorationSession().run(one[0]).records)
    assert time.monotonic() - t0 < 3 * deadline   # not waited out
