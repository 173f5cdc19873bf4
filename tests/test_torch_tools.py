"""The port's sweep command lines (`repro_torch.tools.*`) and the parts of
its sweep runtime that only they and the crash-safe store exercise, held
against the JAX package's: each test is the twin of a reference test
(named in its docstring), run on both packages where the reference is
exact.  The reference's CLIs are loaded by path and run in this process,
as its own tests run them; the port's are imported as modules.  Records
are compared by content (`_torch_dse.content`: every stored field but the
operator's wall time), keyed by content key."""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from _torch_dse import content, contents, failure_content, spaces

import repro.api as R
import repro.api.distributed as ref_dist
from repro.api.session import _demo_records as ref_demo_records

import repro_torch.api as T
import repro_torch.api.distributed as port_dist
from repro_torch.api.session import _demo_records
from repro_torch.tools import merge_stores as port_merge_cli
from repro_torch.tools import run_shard as port_shard_cli
from repro_torch.tools import sweep_top as port_top
from repro_torch.tools import trace_export as port_trace

ROOT = Path(__file__).resolve().parents[1]

# the reference tests' spaces: test_resilience.py / test_obs.py (fsrcnn on
# three or one catalog archs) and test_distributed.py (two workloads)
RES_SPACE = dict(workloads=["fsrcnn"],
                 archs={"SC:TPU": "sc_tpu", "SC:Eye": "sc_eye",
                        "MC:HomTPU": "mc_hom_tpu"},
                 granularities=["layer", ("tile", 8, 1)],
                 pop_size=4, generations=2)
OBS_SPACE = dict(workloads=["fsrcnn"], archs={"MC:HomTPU": "mc_hom_tpu"},
                 granularities=["layer", ("tile", 8, 1)],
                 pop_size=4, generations=2)
DIST_SPACE = dict(workloads=["squeezenet", "fsrcnn"],
                  archs={"SC:TPU": "sc_tpu", "SC:Eye": "sc_eye",
                         "MC:HomTPU": "mc_hom_tpu", "MC:Hetero": "mc_hetero"},
                  granularities=["layer", ("tile", 8, 1)],
                  pop_size=4, generations=2)

# heartbeat fields that are wall-clock readings
_CLOCK = ("updated_unix", "elapsed_s", "points_per_s", "started_unix")


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_key(records) -> dict:
    return {r.key: content(r) for r in records}


def _beat(path) -> dict:
    beat = json.load(open(path))
    for k in _CLOCK:
        beat.pop(k, None)
    return beat


@pytest.fixture(scope="module")
def res_pair():
    return spaces(**RES_SPACE)


@pytest.fixture(scope="module")
def res_golden(res_pair):
    """The reference's fault-free serial records of the resilience space."""
    return R.ExplorationSession().run(res_pair[0])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_sweep_top_fleet_view(tmp_path):
    """Twin of test_obs.py::test_sweep_top_fleet_view; the rendered fleet
    view also equals the reference tool's."""
    ref_top = _ref_tool("sweep_top")
    beats, stores = [], []
    for k, status in enumerate(("running", "done")):
        shard = tmp_path / f"shard{k}"
        shard.mkdir()
        beat = {"status": status, "done": 3 + k, "failed": k, "total": 8,
                "shard_index": k, "n_shards": 2, "seq": 4,
                "updated_unix": 0.0, "points_per_s": 1.5,
                "metrics": {"store_records": 3 + k}}
        (shard / "heartbeat.json").write_text(json.dumps(beat))
        rows = [{"key": f"k{k}{i}", "edp": 10.0 * (k + 1) + i,
                 "latency_cc": 5.0 + i} for i in range(3)]
        (shard / "records.jsonl").write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n"
            + '{"torn line')          # in-flight append: must be skipped
        beats.append(str(shard / "heartbeat.json"))
        stores.append(str(shard))
    snap = port_top.fleet_snapshot(beats, stores)
    t = snap["totals"]
    assert (t["done"], t["failed"], t["total"], t["live"]) == (7, 1, 16, 2)
    assert t["records"] == 6 and t["best_edp"] == 10.0
    assert t["points_per_s"] == pytest.approx(3.0)
    text = port_top.render(snap)
    assert "fleet: 2/2 live" in text and "done 7/16" in text
    assert text == ref_top.render(ref_top.fleet_snapshot(beats, stores))
    d_beats, d_stores = port_top.discover(str(tmp_path))
    assert d_beats == sorted(beats) and d_stores == sorted(stores)
    snap2 = port_top.fleet_snapshot(beats + [str(tmp_path / "nope.json")],
                                    stores)
    assert snap2["totals"]["live"] == 2
    assert "no beat" in port_top.render(snap2)
    assert port_top.read_heartbeat(str(tmp_path / "nope.json")) is None
    assert port_top.tail_store(str(tmp_path / "empty")) == {
        "records": 0, "best_edp": None, "best_latency_cc": None}


def test_sweep_top_once_prints_one_snapshot(tmp_path, capsys):
    """`--once` over `--dir` prints the reference tool's snapshot and
    exits 0; no heartbeat at all is a usage error (exit 2)."""
    shard = tmp_path / "shard0"
    shard.mkdir()
    (shard / "heartbeat.json").write_text(json.dumps(
        {"status": "done", "done": 2, "failed": 0, "total": 2,
         "shard_index": 0, "points_per_s": 0.5}))
    assert port_top.main(["--dir", str(tmp_path), "--once"]) == 0
    got = capsys.readouterr().out
    assert _ref_tool("sweep_top").main(["--dir", str(tmp_path),
                                        "--once"]) == 0
    assert got == capsys.readouterr().out and "fleet: 1/1 live" in got
    with pytest.raises(SystemExit) as exc:
        port_top.main(["--once"])
    assert exc.value.code == 2


def test_trace_export_tool_is_deterministic(tmp_path):
    """Twin of test_obs.py::test_trace_export_tool_is_deterministic; the
    four files also equal the reference tool's byte for byte."""
    blobs = []
    for sub in ("a", "b"):
        paths = port_trace.export_all(str(tmp_path / sub), device="cpu")
        blobs.append({name: open(p, "rb").read()
                      for name, p in paths.items()})
    assert blobs[0] == blobs[1]
    assert sorted(blobs[0]) == ["report_json", "report_text", "schedule",
                                "serving"]
    for name in ("schedule", "serving"):
        doc = json.loads(blobs[0][name])
        assert doc["traceEvents"]
    report = json.loads(blobs[0]["report_json"])
    assert report["slack_cc"] >= 0.0
    ref = _ref_tool("trace_export").export_all(str(tmp_path / "ref"))
    assert {name: open(p, "rb").read() for name, p in ref.items()} == \
        blobs[0]


def test_trace_export_main_prints_paths_and_report(tmp_path, capsys):
    out = str(tmp_path / "t")
    assert port_trace.main(["--out", out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "schedule" in text and os.path.join(out, "bottleneck.txt") in text
    assert open(os.path.join(out, "bottleneck.txt")).read() in text


def test_run_shard_cli_exit_3_on_quarantine(tmp_path, monkeypatch, capsys,
                                            res_pair):
    """Twin of test_resilience.py::test_run_shard_cli_exit_3_on_quarantine;
    the quarantined failures equal the reference CLI's."""
    out = {}
    for name, dist, cli, space in (
            ("ref", ref_dist, _ref_tool("run_shard"), res_pair[0]),
            ("port", port_dist, port_shard_cli, res_pair[1])):
        api = R if name == "ref" else T
        mpath = str(tmp_path / f"{name}.json")
        api.build_manifest(space).save(mpath)
        real = dist.run_shard

        def faulted(*args, _real=real, _api=api, **kw):
            kw["fault_injector"] = _api.FaultInjector(seed=0,
                                                      exception_rate=1.0)
            return _real(*args, **kw)

        monkeypatch.setattr(dist, "run_shard", faulted)
        rc = cli.main([mpath, "--out", str(tmp_path / name)])
        assert rc == 3
        err = capsys.readouterr().err
        assert "QUARANTINED" in err and "InjectedFault" in err
        assert os.path.exists(tmp_path / name / "failures.jsonl")
        assert os.path.exists(tmp_path / name / "heartbeat.json")
        out[name] = [failure_content(f) for f in
                     api.ResultStore(str(tmp_path / name)).failures()]
        out[name + "_beat"] = _beat(tmp_path / name / "heartbeat.json")
    assert out["port"] == out["ref"] and len(out["port"]) == 6
    assert out["port_beat"] == out["ref_beat"]
    assert out["port_beat"]["status"] == "quarantined"


def _seeded(api, path, records):
    store = api.ResultStore(str(path))
    for r in records:
        store.put(r)
    return store


def test_merge_cli_verify_and_repair(tmp_path, capsys):
    """Twin of test_resilience.py::test_merge_cli_verify_and_repair, run on
    both packages' CLIs: the same exit codes, and the repaired merges hold
    the same records."""
    merged = {}
    for name, api, cli, recs in (
            ("ref", R, _ref_tool("merge_stores"), ref_demo_records()),
            ("port", T, port_merge_cli, _demo_records())):
        root = tmp_path / name
        _seeded(api, root / "a", recs)
        rc = cli.main([str(root / "m"), str(root / "a"), "--verify"])
        assert rc == 0
        assert "ok" in capsys.readouterr().out
        path = api.ResultStore.resolve_path(str(root / "a"))
        lines = open(path).read().splitlines(True)
        lines.insert(0, "garbage\n")
        with open(path, "w") as f:
            f.writelines(lines)
        rc = cli.main([str(root / "m2"), str(root / "a"), "--verify"])
        assert rc == 4
        assert "CORRUPT" in capsys.readouterr().err
        with pytest.warns(RuntimeWarning):
            rc = cli.main([str(root / "m3"), str(root / "a"),
                           "--verify", "--repair"])
        assert rc == 0
        merged[name] = api.ResultStore(str(root / "m3"))
        assert len(merged[name]) == 3
        assert open(path + ".bad").read() == "garbage\n"
    assert _by_key(merged["port"].values()) == _by_key(merged["ref"].values())


@pytest.fixture(scope="module")
def dist_pair():
    return spaces(**DIST_SPACE)


def test_shard_and_merge_clis_reproduce_serial(tmp_path, capsys, dist_pair):
    """Twin of test_distributed.py::test_shard_and_merge_clis_reproduce_
    serial: the port's CLIs over 2 shards merge to the reference's serial
    records, and to the reference CLIs' merged store, key for key."""
    serial = R.ExplorationSession().run(dist_pair[0])
    merged = {}
    for name, api, space, shard_cli, merge_cli in (
            ("port", T, dist_pair[1], port_shard_cli, port_merge_cli),
            ("ref", R, dist_pair[0], _ref_tool("run_shard"),
             _ref_tool("merge_stores"))):
        root = tmp_path / name
        root.mkdir()
        manifest_path = api.build_manifest(space).save(
            str(root / "sweep.json"))
        dirs = []
        for k in range(2):
            out = str(root / f"shard{k}")
            assert shard_cli.main([manifest_path, "--shard", f"{k}/2",
                                   "--out", out]) == 0
            dirs.append(out)
        assert merge_cli.main([str(root / "merged")] + dirs) == 0
        out = capsys.readouterr().out
        assert "shard done" in out and "merged 2 stores" in out
        merged[name] = _by_key(api.ResultStore(str(root / "merged"))
                               .values())
    assert merged["port"] == _by_key(serial.records)
    assert merged["port"] == merged["ref"]


def test_merge_cli_fails_on_missing_source(tmp_path, capsys):
    """Twin of test_distributed.py::test_merge_cli_fails_on_missing_source,
    with `--allow-missing` skipping the source instead."""
    for cli in (port_merge_cli, _ref_tool("merge_stores")):
        assert cli.main([str(tmp_path / "out"),
                         str(tmp_path / "missing")]) == 2
        assert "no shard store" in capsys.readouterr().err
        assert cli.main([str(tmp_path / "out"), str(tmp_path / "missing"),
                         "--allow-missing"]) == 0
        assert "skipped missing" in capsys.readouterr().out


def test_run_shard_cli_rejects_bad_shard_spec(tmp_path):
    """Twin of test_distributed.py::test_run_shard_cli_rejects_bad_shard_
    spec; `parse_shard` gives the reference's pairs."""
    path = T.build_manifest(spaces(**OBS_SPACE)[1]).save(
        str(tmp_path / "m.json"))
    for bad in ("8/8", "nope", "-1/2"):
        with pytest.raises(SystemExit) as exc:
            port_shard_cli.main([path, "--shard", bad])
        assert exc.value.code == 2
    ref = _ref_tool("run_shard")
    assert [port_shard_cli.parse_shard(s) for s in ("0/1", "2/8")] == \
        [ref.parse_shard(s) for s in ("0/1", "2/8")] == [(0, 1), (2, 8)]


def test_run_shard_cli_runs_as_a_module(tmp_path):
    """`python -m repro_torch.tools.run_shard` runs a one-point manifest in
    a fresh interpreter with `src` on the path and nothing else."""
    space = spaces(workloads=["fsrcnn"], archs={"SC:TPU": "sc_tpu"},
                   granularities=["layer"], pop_size=4, generations=2)[1]
    mpath = T.build_manifest(space).save(str(tmp_path / "m.json"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.run_shard", mpath,
         "--out", str(tmp_path / "s"), "--heartbeat", "none"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "shard done: 1 points (1 scheduled" in proc.stdout
    assert not os.path.exists(tmp_path / "s" / "heartbeat.json")
    assert len(T.ResultStore(str(tmp_path / "s"))) == 1


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def test_heartbeat_monitor_counts_and_finalizes(tmp_path, res_pair):
    """Twin of test_resilience.py::test_heartbeat_monitor_counts_and_
    finalizes; the beats equal the reference's under the same faults."""
    beats = {}
    for name, api, space in (("ref", R, res_pair[0]),
                             ("port", T, res_pair[1])):
        hb_path = str(tmp_path / f"{name}.json")
        monitor = api.HeartbeatMonitor(hb_path, total=4)
        sess = api.ExplorationSession(
            retry_policy=api.RetryPolicy(max_attempts=2),
            fault_injector=api.FaultInjector(seed=9, exception_rate=0.5))
        sweep = sess.run(space, policies=[monitor])
        beat = json.load(open(hb_path))
        assert beat["done"] == len(sweep.records)
        assert beat["failed"] == sweep.n_failed > 0
        monitor.finalize("done")
        assert json.load(open(hb_path))["status"] == "done"
        beats[name] = _beat(hb_path)
    assert beats["port"] == beats["ref"]


def test_heartbeat_embeds_metrics_snapshot(tmp_path):
    """Twin of test_obs.py::test_heartbeat_embeds_metrics_snapshot."""
    beats = {}
    for name, api in (("ref", R), ("port", T)):
        path = str(tmp_path / f"{name}.json")
        hb = api.HeartbeatMonitor(path, total=3,
                                  metrics=lambda: {"store_records": 2,
                                                   "sweep.computed": 2.0})
        hb.update_failure("boom")
        beat = json.load(open(path))
        assert beat["metrics"] == {"store_records": 2, "sweep.computed": 2.0}
        assert beat["points_per_s"] >= 0.0
        hb.finalize("done")
        assert json.load(open(path))["status"] == "done"
        beats[name] = _beat(path)
    assert beats["port"] == beats["ref"]


@pytest.fixture(scope="module")
def obs_pair():
    return spaces(**OBS_SPACE)


def test_run_shard_heartbeat_has_metrics(tmp_path, obs_pair):
    """Twin of test_obs.py::test_run_shard_heartbeat_has_metrics."""
    beats = {}
    for name, api, space in (("ref", R, obs_pair[0]),
                             ("port", T, obs_pair[1])):
        sweep = api.run_shard(api.build_manifest(space),
                              cache_dir=str(tmp_path / name / "store"),
                              heartbeat=str(tmp_path / name / "hb.json"))
        beat = json.load(open(tmp_path / name / "hb.json"))
        assert beat["status"] == "done"
        assert beat["metrics"]["store_records"] == len(sweep)
        assert beat["metrics"]["store_failures"] == 0
        assert "points_per_s" in beat
        beats[name] = _beat(tmp_path / name / "hb.json")
    # the embedded metrics hold the tracer's wall-time histograms; compare
    # the counts and statuses
    for b in beats.values():
        b["metrics"] = {k: v for k, v in b["metrics"].items()
                        if not isinstance(v, dict)}
    assert beats["port"] == beats["ref"]


def test_run_shard_quarantine_exit_stamps_heartbeat(tmp_path, obs_pair):
    """Twin of test_obs.py::test_run_shard_quarantine_exit_stamps_
    heartbeat."""
    out = {}
    for name, api, space in (("ref", R, obs_pair[0]),
                             ("port", T, obs_pair[1])):
        sweep = api.run_shard(
            api.build_manifest(space),
            cache_dir=str(tmp_path / name / "store"),
            fault_injector=api.FaultInjector(seed=0, exception_rate=1.0),
            heartbeat=str(tmp_path / name / "hb.json"))
        assert len(sweep.records) == 0 and sweep.n_failed > 0
        beat = json.load(open(tmp_path / name / "hb.json"))
        assert beat["status"] == "quarantined"
        assert beat["failed"] == sweep.n_failed
        assert beat["metrics"]["store_failures"] == sweep.n_failed
        out[name] = [failure_content(f) for f in sweep.failures]
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# crash-safe stores: torn tails, mid-file corruption, verify, locking
# ---------------------------------------------------------------------------

def test_torn_tail_is_dropped_and_truncated(tmp_path):
    """Twin of test_resilience.py::test_torn_tail_is_dropped_and_truncated;
    the truncated file equals the reference's byte for byte."""
    blobs = {}
    for name, api, recs in (("ref", R, ref_demo_records()),
                            ("port", T, _demo_records())):
        store = _seeded(api, tmp_path / name, recs)
        store.append_torn(json.dumps(recs[0].to_dict()) + "\n")
        size_torn = os.path.getsize(store.path)
        reloaded = api.ResultStore(str(tmp_path / name))
        assert len(reloaded) == 3
        assert os.path.getsize(store.path) < size_torn
        reloaded.put(recs[0])
        assert api.ResultStore(str(tmp_path / name)).verify()[
            "torn_tail"] == 0
        blobs[name] = open(store.path, "rb").read()
    assert blobs["port"] == blobs["ref"]


def test_midfile_corruption_raises_unless_repaired(tmp_path):
    """Twin of test_resilience.py::test_midfile_corruption_raises_unless_
    repaired; the `.bad` sidecar and the rewritten store equal the
    reference's."""
    blobs = {}
    for name, api, recs in (("ref", R, ref_demo_records()),
                            ("port", T, _demo_records())):
        store = _seeded(api, tmp_path / name, recs)
        lines = open(store.path).read().splitlines(True)
        lines.insert(1, "NOT JSON {{{\n")
        lines.insert(3, '{"valid_json": "but not a record"}\n')
        with open(store.path, "w") as f:
            f.writelines(lines)
        with pytest.raises(api.StoreCorruptionError, match="malformed"):
            api.ResultStore(str(tmp_path / name))
        with pytest.raises(api.StoreCorruptionError):
            api.ResultStore.verify_path(str(tmp_path / name))
        with pytest.warns(RuntimeWarning, match="quarantined 2"):
            repaired = api.ResultStore(str(tmp_path / name), repair=True)
        assert len(repaired) == 3
        bad = open(store.path + ".bad").read()
        assert "NOT JSON" in bad and "valid_json" in bad
        assert len(api.ResultStore(str(tmp_path / name))) == 3
        blobs[name] = (open(store.path, "rb").read(),
                       open(store.path + ".bad", "rb").read())
    assert blobs["port"] == blobs["ref"]


def test_verify_reports_counts_and_torn_tail(tmp_path):
    """Twin of test_resilience.py::test_verify_reports_counts_and_torn_
    tail."""
    for name, api, recs in (("ref", R, ref_demo_records()),
                            ("port", T, _demo_records())):
        store = _seeded(api, tmp_path / name, recs)
        store.put_failure(api.FailureRecord(
            key="zz", workload="w", arch="A", error_type="X", message="m",
            traceback="t", attempts=1))
        assert store.verify() == {"n_records": 3, "n_failures": 1,
                                  "torn_tail": 0}
        store.append_torn("garbage-without-newline")
        assert api.ResultStore.verify_path(str(tmp_path / name))[
            "torn_tail"] == 1


def test_concurrent_appends_do_not_interleave(tmp_path):
    """Twin of test_resilience.py::test_concurrent_appends_do_not_
    interleave."""
    a = T.ResultStore(str(tmp_path / "s"))
    b = T.ResultStore(str(tmp_path / "s"))
    r0, r1, r2 = _demo_records()
    for rec in (r0, r1, r2):
        a.put(rec)
        b.put(rec)
    report = T.ResultStore.verify_path(str(tmp_path / "s"))
    assert report == {"n_records": 6, "n_failures": 0, "torn_tail": 0}
    assert len(T.ResultStore(str(tmp_path / "s"))) == 3


def test_lock_failure_errors_loudly(tmp_path, monkeypatch):
    """Twin of test_resilience.py::test_lock_failure_errors_loudly."""
    import repro_torch.api.session as session_mod

    def deny(fd, op):
        raise OSError("lock denied")

    store = _seeded(T, tmp_path / "s", _demo_records())
    monkeypatch.setattr(session_mod.fcntl, "flock", deny)
    with pytest.raises(T.StoreLockError, match="lock"):
        store.put(_demo_records()[0])


def test_failures_sidecar_round_trip_and_supersession(tmp_path):
    """Twin of test_resilience.py::test_failures_sidecar_round_trip_and_
    supersession."""
    store = T.ResultStore(str(tmp_path / "s"))
    r0, r1, _ = _demo_records()
    fail_r1 = T.FailureRecord(key=r1.key, workload=r1.workload,
                              arch=r1.arch, error_type="InjectedFault",
                              message="boom", traceback="tb", attempts=2)
    store.put(r0)
    store.put_failure(fail_r1)
    store.put_failure(T.FailureRecord(
        key=r0.key, workload=r0.workload, arch=r0.arch, error_type="X",
        message="m", traceback="t", attempts=1))
    assert [f.key for f in store.failures()] == [r1.key]
    reloaded = T.ResultStore(str(tmp_path / "s"))
    assert [f.key for f in reloaded.failures()] == [r1.key]
    reloaded.put(r1)
    assert reloaded.failures() == []
    assert T.ResultStore(str(tmp_path / "s")).failures() == []


def _fail(api, rec, error_type, message, attempts):
    return api.FailureRecord(key=rec.key, workload=rec.workload,
                             arch=rec.arch, error_type=error_type,
                             message=message, traceback="t",
                             attempts=attempts)


def test_merge_folds_failures_first_wins(tmp_path):
    """Twin of test_resilience.py::test_merge_folds_failures_first_wins,
    on both packages: the same merged records and failures."""
    got = {}
    for name, api, recs in (("ref", R, ref_demo_records()),
                            ("port", T, _demo_records())):
        r0, r1, r2 = recs
        a = api.ResultStore(str(tmp_path / name / "a"))
        a.put(r0)
        a.put_failure(_fail(api, r1, "A", "first", 1))
        b = api.ResultStore(str(tmp_path / name / "b"))
        b.put(r2)
        b.put_failure(_fail(api, r1, "B", "second", 3))
        merged = api.ResultStore.merge(a, b)
        assert {r.key for r in merged.values()} == {r0.key, r2.key}
        assert [f.message for f in merged.failures()] == ["first"]
        c = api.ResultStore(str(tmp_path / name / "c"))
        c.put(r1)
        healthy = api.ResultStore.merge(a, b, c)
        assert len(healthy) == 3 and healthy.failures() == []
        got[name] = ([f.to_dict() for f in merged.failures()],
                     _by_key(healthy.values()))
    assert got["port"] == got["ref"]


def test_merge_accepts_failures_only_shard(tmp_path):
    """Twin of test_resilience.py::test_merge_accepts_failures_only_
    shard."""
    a = T.ResultStore(str(tmp_path / "a"))
    r0, _, _ = _demo_records()
    a.put_failure(_fail(T, r0, "X", "m", 1))
    merged = T.merge_stores(None, str(tmp_path / "a"))
    assert len(merged) == 0 and len(merged.failures()) == 1


def test_run_shard_retries_and_heartbeat(tmp_path, res_pair, res_golden):
    """Twin of test_resilience.py::test_run_shard_retries_and_heartbeat:
    faults within the retry budget, 2 shards, merged equal to the
    reference's fault-free serial records, with the reference's retry
    counts shard by shard."""
    inj = dict(seed=2, exception_rate=0.6, max_faults_per_point=2)
    stores = []
    for k in range(2):
        retried = []
        for name, api, space in (("ref", R, res_pair[0]),
                                 ("port", T, res_pair[1])):
            out = str(tmp_path / name / f"shard{k}")
            sweep = api.run_shard(api.build_manifest(space), cache_dir=out,
                                  shard=(k, 2), retries=2,
                                  fault_injector=api.FaultInjector(**inj),
                                  heartbeat=str(tmp_path / name /
                                                f"hb{k}.json"))
            assert sweep.n_failed == 0
            beat = json.load(open(tmp_path / name / f"hb{k}.json"))
            assert beat["status"] == "done" and beat["done"] == len(sweep)
            assert (beat["shard_index"], beat["n_shards"]) == (k, 2)
            retried.append(sweep.n_retried)
        assert retried[0] == retried[1]
        stores.append(str(tmp_path / "port" / f"shard{k}"))
    merged = T.merge_stores(str(tmp_path / "merged"), *stores)
    assert _by_key(merged.values()) == _by_key(res_golden.records)


_DRIVER = """
import sys
from repro_torch.api import FaultInjector, run_shard
# delay every point so the parent can reliably kill us mid-sweep
inj = FaultInjector(seed=0, delay_rate=1.0, delay_s=0.5)
run_shard(sys.argv[1], cache_dir=sys.argv[2],
          fault_injector=inj, heartbeat=sys.argv[3])
"""


def test_sigkill_crash_restart_is_bit_identical(tmp_path, res_pair,
                                                res_golden):
    """Twin of test_resilience.py::test_sigkill_crash_restart_is_bit_
    identical: a port shard in a subprocess (neither `jax` nor `repro`
    importable there) is SIGKILLed mid-sweep, restarted, and ends with the
    reference's serial records."""
    mpath = str(tmp_path / "sweep.json")
    T.build_manifest(res_pair[1]).save(mpath)
    out = str(tmp_path / "shard")
    hb_path = str(tmp_path / "hb.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    driver = "import sys; sys.modules['jax'] = sys.modules['repro'] = None\n"
    proc = subprocess.Popen([sys.executable, "-c", driver + _DRIVER, mpath,
                             out, hb_path], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            try:
                if json.load(open(hb_path))["done"] >= 1:
                    break
            except (FileNotFoundError, json.JSONDecodeError, KeyError):
                pass
            time.sleep(0.02)
        killed = proc.poll() is None
        if killed:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert killed, "shard finished before it could be killed"
    partial = T.ResultStore(out)
    assert 1 <= len(partial) < len(res_golden.records)
    sweep = T.run_shard(mpath, cache_dir=out)
    assert sweep.n_from_store == len(partial)
    assert sweep.n_failed == 0
    merged = T.ResultStore(out)
    assert _by_key(merged.values()) == _by_key(res_golden.records)
    assert merged.verify()["n_records"] >= len(res_golden.records)
    assert contents(sorted(merged.values(), key=lambda r: r.key)) == \
        contents(sorted(res_golden.records, key=lambda r: r.key))
