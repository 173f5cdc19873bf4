"""The port's `ExplorationSession` sweeps equal the JAX package's: a serial
`run` gives the reference's records field for field (`runtime_s`, wall
time, aside) and the same store lines byte for byte, a re-run is served
from the store, the process executor equals serial, warm-started sweeps,
`explore_granularity` and `checkpoint_stats` across engine evictions are
equal, and each package reads and merges the other's store.

The GA prefilter is held exactly on the space where the reference's
process executor drops it (ROADMAP queue 3, item 9): the port's serial
prefiltered sweep equals the reference's serial prefiltered records, and
with `executor="process"` it equals the unfiltered records, as the
reference's does.  The port's batched fitness runs on the CPU here."""
import json
import re

import pytest
from _torch_dse import content, contents, spaces

import repro.api as R
import repro.configs.paper_workloads as ref_workloads
import repro.hw.catalog as ref_catalog

import repro_torch.api as T
import repro_torch.configs.paper_workloads as port_workloads
import repro_torch.hw.catalog as port_catalog

SMALL = dict(workloads=["squeezenet", "fsrcnn"],
             archs={"SC:TPU": "sc_tpu", "MC:HomTPU": "mc_hom_tpu"},
             granularities=["layer", ("tile", 8, 1)],
             pop_size=4, generations=2)
# the space of queue 3, item 9: the prefilter changes two of its points
FAULT9 = dict(workloads=["squeezenet", "resnet18"],
              archs={"MC:Hetero": "mc_hetero", "MC:HomTPU": "mc_hom_tpu"},
              granularities=[("tile", 32, 1)],
              pop_size=16, generations=8, seed=1)
RUNTIME = re.compile(rb'"runtime_s": [^,}]+')


@pytest.fixture(scope="module")
def small():
    return spaces(**SMALL)


@pytest.fixture(scope="module")
def ref_small(small, tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_small")
    return path, R.ExplorationSession(cache_dir=str(path)).run(small[0])


def _lines(store_dir) -> list:
    with open(store_dir / "records.jsonl", "rb") as f:
        return [RUNTIME.sub(b'"runtime_s": 0', line)
                for line in f.read().splitlines()]


def test_serial_run_equals_reference(small, ref_small, tmp_path):
    ref_dir, want = ref_small
    got = T.ExplorationSession(cache_dir=str(tmp_path)).run(small[1])
    assert len(got) == 8 and got.n_scheduled == 8 and got.n_failed == 0
    assert contents(got.records) == contents(want.records)
    assert _lines(tmp_path) == _lines(ref_dir)


def test_rerun_is_served_from_the_store(small, tmp_path):
    first = T.ExplorationSession(cache_dir=str(tmp_path)).run(small[1])
    again = T.ExplorationSession(cache_dir=str(tmp_path)).run(small[1])
    assert (again.n_scheduled, again.n_from_store) == (0, len(first))
    assert all(r.from_store for r in again.records)
    assert contents(again.records) == contents(first.records)


def test_process_executor_equals_serial(small, ref_small):
    got = T.ExplorationSession().run(small[1], executor="process",
                                     max_workers=2)
    assert got.n_failed == 0
    assert contents(got.records) == contents(ref_small[1].records)


def test_explore_granularity_equals_reference():
    grans = ["layer", ("tile", 8, 1), ("tile", 32, 1)]
    kw = dict(granularities=grans, pop_size=4, generations=2)
    want = R.ExplorationSession().explore_granularity(
        ref_workloads.fsrcnn(), ref_catalog.mc_hom_tpu(), **kw)
    got = T.ExplorationSession().explore_granularity(
        port_workloads.fsrcnn(), port_catalog.mc_hom_tpu(), **kw)
    assert got.best_label == want.best_label
    assert list(got.results) == list(want.results)
    for label, res in got.items():
        ref = want.results[label]
        assert (res.latency_cc, res.energy_pj, res.edp) == \
            (ref.latency_cc, ref.energy_pj, ref.edp)
        assert res.allocation.tolist() == ref.allocation.tolist()
        assert res.ga.evaluations == ref.ga.evaluations
    from repro_torch.core.stream_api import explore_granularity
    legacy = explore_granularity(port_workloads.fsrcnn(),
                                 port_catalog.mc_hom_tpu(), **kw)
    assert legacy["best"] == want.best_label


def test_each_package_reads_and_merges_the_others_store(small, ref_small,
                                                        tmp_path):
    ref_dir, want = ref_small
    port_dir = tmp_path / "port"
    T.ExplorationSession(cache_dir=str(port_dir)).run(small[1])
    from_ref = T.ResultStore(str(ref_dir))
    from_port = R.ResultStore(str(port_dir))
    assert len(from_ref) == len(from_port) == len(want)
    for r in want.records:
        assert content(from_ref.get(r.key)) == content(r)
        assert content(from_port.get(r.key)) == content(r)
    # a port session over the reference's store schedules nothing
    rerun = T.ExplorationSession(cache_dir=str(ref_dir)).run(small[1])
    assert rerun.n_scheduled == 0
    merged_dir = tmp_path / "merged"
    merged = T.ResultStore.merge(str(ref_dir), str(port_dir),
                                 cache_dir=str(merged_dir))
    ref_merged = R.ResultStore.merge(str(port_dir), str(ref_dir))
    assert sorted(merged._records) == sorted(ref_merged._records)
    assert [content(r) for r in merged.values()] == contents(want.records)
    assert len(R.ResultStore(str(merged_dir))) == len(want)


@pytest.fixture(scope="module")
def fault9():
    return spaces(**FAULT9)


@pytest.fixture(scope="module")
def fault9_unfiltered(fault9):
    return R.ExplorationSession().run(fault9[0]).records


def test_prefiltered_serial_sweep_equals_reference(fault9, fault9_unfiltered):
    want = R.ExplorationSession(prefilter=True).run(fault9[0]).records
    got = T.ExplorationSession(prefilter=True, device="cpu").run(
        fault9[1]).records
    assert contents(got) == contents(want)
    # the prefilter steered this space: the records differ from unfiltered
    assert contents(got) != contents(fault9_unfiltered)
    assert [r.ga_evaluations for r in got] == [66, 72, 68, 67]


def test_prefilter_dropped_by_process_executor_as_in_reference(
        fault9, fault9_unfiltered):
    """Queue 3, item 9: the worker builds its session without the parent's
    prefilter, so a process sweep gives the unfiltered records."""
    got = T.ExplorationSession(prefilter=True, device="cpu").run(
        fault9[1], executor="process", max_workers=2)
    assert got.n_failed == 0
    assert contents(got.records) == contents(fault9_unfiltered)
    assert [r.ga_evaluations for r in got.records] == [72, 75, 74, 73]


def test_records_carry_no_device(small):
    got = T.ExplorationSession(device="cpu").run(small[1])
    for rec in got.records:
        assert "device" not in json.dumps(rec.to_dict())
    assert [r.key for r in got.records] == [p.content_key() for p in small[1]]


def test_warm_started_sweep_equals_reference(small):
    """Store-backed warm starts seed each GA from earlier records of the
    same sweep: the seeds, and so the records, are the reference's."""
    got = T.ExplorationSession(warm_start=True).run(small[1],
                                                    order="nearest-arch")
    want = R.ExplorationSession(warm_start=True).run(small[0],
                                                     order="nearest-arch")
    assert contents(got.records) == contents(want.records)
    assert got.n_warm_started == want.n_warm_started > 0
    assert [r.ga_warm_starts for r in got.records] == \
        [r.ga_warm_starts for r in want.records]


def test_checkpoint_stats_across_engine_evictions_equal_reference(small):
    """A cache of 2 engines evicts on this space; `checkpoint_stats` folds
    the evicted engines' counters in, as the reference's does."""
    got, want = T.ExplorationSession(cache_limit=2), \
        R.ExplorationSession(cache_limit=2)
    got.run(small[1])
    want.run(small[0])
    assert got.cache_stats == want.cache_stats
    assert got.cache_stats["engine_misses"] > 2
    assert got.checkpoint_stats() == want.checkpoint_stats()
    assert got.metrics_snapshot() == want.metrics_snapshot()
