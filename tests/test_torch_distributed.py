"""The port's distributed sweep runtime equals the JAX package's: manifests
and their shards serialize to the same bytes, `run_shard` on 2 shards then
`merge_stores` gives the serial run's records (which equal the
reference's), a pre-sliced manifest rebuilds the same points, and
`run_async` under each stop policy stops at the same prefix, with the
same reason, as the reference's."""
import json

import pytest
from _torch_dse import contents, spaces

import repro.api as R

import repro_torch.api as T

SPACE = dict(workloads=["squeezenet", "fsrcnn"],
             archs={"SC:TPU": "sc_tpu", "SC:Eye": "sc_eye",
                    "MC:HomTPU": "mc_hom_tpu", "MC:Hetero": "mc_hetero"},
             granularities=["layer", ("tile", 8, 1)],
             pop_size=4, generations=2)


@pytest.fixture(scope="module")
def pair():
    return spaces(**SPACE)


@pytest.fixture(scope="module")
def ref_serial(pair):
    return R.ExplorationSession().run(pair[0])


@pytest.mark.parametrize("order", ["declared", "nearest-arch"])
def test_manifests_byte_equal(pair, order, tmp_path):
    want = R.build_manifest(pair[0], order=order)
    got = T.build_manifest(pair[1], order=order)
    assert got.to_json() == want.to_json()
    for k in range(3):
        assert T.shard(pair[1], 3, k, order=order).to_json() == \
            R.shard(pair[0], 3, k, order=order).to_json()
    path = got.save(str(tmp_path / "m.json"))
    with open(path, "rb") as f:
        blob = f.read()
    assert blob == open(want.save(str(tmp_path / "r.json")), "rb").read()
    # each package rebuilds the other's manifest to the same points
    assert [p.content_key() for p in R.SweepManifest.load(path)
            .design_points()] == \
        [p.content_key() for p in R.order_points(pair[0], order)]
    assert [p.content_key() for p in T.SweepManifest.from_json(
        want.to_json()).design_points()] == \
        [e["key"] for e in json.loads(want.to_json())["points"]]


def test_two_shards_merged_equal_serial(pair, ref_serial, tmp_path):
    manifest = T.build_manifest(pair[1]).save(str(tmp_path / "sweep.json"))
    dirs = []
    for k in range(2):
        d = str(tmp_path / f"shard{k}")
        sweep = T.run_shard(manifest, cache_dir=d, shard=(k, 2))
        assert sweep.n_failed == 0 and sweep.n_scheduled == len(sweep)
        dirs.append(d)
    merged = T.merge_stores(str(tmp_path / "merged"), *dirs)
    serial = T.ExplorationSession().run(pair[1])
    assert contents(serial.records) == contents(ref_serial.records)
    by_key = {r.key: r for r in merged.values()}
    assert sorted(by_key) == sorted(r.key for r in serial.records)
    assert contents(by_key[r.key] for r in serial.records) == \
        contents(serial.records)
    # the reference merges the port's shard stores to the same set
    ref_merged = R.merge_stores(None, *dirs)
    assert sorted(r.key for r in ref_merged.values()) == sorted(by_key)


def test_pre_sliced_shards_rebuild_the_reference_points(pair, tmp_path):
    for k in range(2):
        got = T.shard(pair[1], 2, k).design_points()
        want = R.shard(pair[0], 2, k).design_points()
        assert [p.content_key() for p in got] == \
            [p.content_key() for p in want]
        assert [p.spec_dict() for p in got] == [p.spec_dict() for p in want]


@pytest.mark.parametrize("policy", [
    ("PlateauPolicy", dict(metric="edp", patience=2)),
    ("BudgetPolicy", dict(max_records=5)),
    ("ParetoStagnationPolicy", dict(patience=3)),
    ("TargetMetricPolicy", dict(metric="edp", target=2e15)),
], ids=lambda p: p[0])
def test_run_async_stops_at_the_reference_prefix(pair, policy):
    name, kw = policy
    streams = []
    for api, space in ((R, pair[0]), (T, pair[1])):
        stop = getattr(api, name)(**kw)
        recs = list(api.ExplorationSession().run_async(
            space, order="nearest-arch", policies=[stop]))
        streams.append((contents(recs), stop.reason))
    assert streams[1] == streams[0]
    assert 0 < len(streams[1][0]) < len(pair[1])
