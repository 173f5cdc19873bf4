"""Cells over several cards, on the CPU: ranks on gloo, spawned as the
benchmark spawns them on the cards (`harness/ranks.py`), each rank's
blocks of the seeded weights, and a run that never hangs."""
import hashlib
import json
import multiprocessing
import shutil
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from harness import ranks, serve, spec, train
from harness.cell_run import run_once
from harness.small import small_cell
from harness.weights import (layout_of, leaf, leaves, model_weights, piece,
                             rank_blocks, spec_at, tensors)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 77
LIMIT_S = 240


def meshed(name: str, model: int, dtype: str | None = None):
    """The small cell `name` with its configuration laid over a mesh of
    `model` ranks."""
    c = small_cell(name, dtype)
    c.config["mesh"] = {"data": 1, "model": model}
    c.chips = model
    return c


def served(cell, seed, seconds, traced, device, t_start, mesh):
    """A rank's body that hands back the line and the served tokens."""
    line, run = run_once(cell, seed, seconds, traced, device, t_start, mesh)
    return line and {"line": line, "out": [w["out"] for w in run.waves]}


def served_in_float32(cell, seed, seconds, traced, device, t_start, mesh):
    """`served` with every leaf drawn in float32, so that the ranks' sums
    over "model" and one rank's sums differ by float32 rounding alone."""
    from harness import weights
    weights.DTYPES = dict.fromkeys(weights.DTYPES, torch.float32)
    return served(cell, seed, seconds, traced, device, t_start, mesh)


def fails_on_rank_1(cell, seed, seconds, traced, device, t_start, mesh):
    if mesh.rank == 1:
        raise RuntimeError("a planted fault on rank 1")
    return served(cell, seed, seconds, traced, device, t_start, mesh)


def hangs_on_rank_1(cell, seed, seconds, traced, device, t_start, mesh):
    if mesh.rank == 1:
        time.sleep(3600)
    return served(cell, seed, seconds, traced, device, t_start, mesh)


def launch(cell, body=None, traced=False, limit_s=LIMIT_S, seconds=0.6):
    t0 = time.perf_counter()
    code, got = ranks.launch(cell, SEED, seconds, traced, t0,
                             device_type="cpu", body=body, limit_s=limit_s)
    return code, got, time.perf_counter() - t0


def test_two_ranks_serve_the_tokens_of_one():
    code1, one, _ = launch(meshed("dsmoe-prefill-2k", 1, "float32"),
                           served_in_float32, seconds=2.0)
    code2, two, seconds = launch(meshed("dsmoe-prefill-2k", 2, "float32"),
                                 served_in_float32, seconds=2.0)
    assert code1 == code2 == 0
    for got in (one, two):
        assert got["line"]["correct"] is True, got["line"]["checks"]
        assert got["line"]["failed"] == 0
    n = min(len(one["out"]), len(two["out"]))
    assert n >= 2
    assert one["out"][:n] == two["out"][:n]
    line = two["line"]
    assert line["device"]["count"] == 2
    # set-up is timed from the launching process's clock: the ranks'
    # start and their group are inside it
    assert 0 < line["metrics"]["setup_s"]["value"] < seconds
    assert list(line)[-1] == "checks"


def test_a_traced_run_over_two_ranks():
    code, line, _ = launch(meshed("rwkv6-prefill-4k", 2), traced=True)
    assert code == 0
    json.dumps(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 2
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "breakdown" in line
    want = {m["name"] for m in spec.cell("rwkv6-prefill-4k").per_layer}
    assert set(line["metrics"]) <= want and "prefill_wave_ms" in \
        line["metrics"]


def test_a_failing_rank_ends_the_run_within_seconds():
    code, got, seconds = launch(meshed("dsmoe-prefill-2k", 2),
                                fails_on_rank_1)
    assert code != 0 and got is None
    assert seconds < 60
    assert multiprocessing.active_children() == []


def test_a_hanging_rank_is_stopped_at_the_limit():
    code, got, seconds = launch(meshed("dsmoe-prefill-2k", 2),
                                hangs_on_rank_1, limit_s=15)
    assert code != 0 and got is None
    assert seconds < 15 + ranks.GRACE_S + 10
    assert multiprocessing.active_children() == []


def _abstract_rank(model: int, rank: int):
    from repro_torch.sharding.rules import Mesh
    mesh = Mesh.abstract((1, model), ("data", "model"), device_type="cpu")
    mesh.rank, mesh.coords = rank, {"data": 0, "model": rank}
    return mesh


@pytest.mark.parametrize("name", ("dsmoe-prefill-2k", "rwkv6-prefill-4k"))
def test_blocks_are_the_slices_of_each_leaf_drawn_whole(name):
    from repro_torch.models.transformer import param_shardings
    cell = meshed(name, 2)
    arch = spec.arch_config(cell.config)
    whole = model_weights(cell.config, "cpu")
    split = 0
    for rank in (0, 1):
        shardings = param_shardings(arch, _abstract_rank(2, rank))
        blocks = rank_blocks(cell.config, shardings, "cpu")
        for path, _ in leaves(layout_of(cell.config)):
            sh = spec_at(shardings, path)
            got, want = spec_at(blocks, path), spec_at(whole, path)
            assert torch.equal(got, sh.shard(want)), path
            split += got.shape != want.shape
    assert split > 0        # the mesh cuts some leaves


def test_the_reference_draws_any_leaf_again_bit_for_bit():
    cell = meshed("dsmoe-prefill-2k", 2)
    layout = layout_of(cell.config)
    seen = set()
    for path, s in leaves(layout):
        a, b = leaf(cell.config, path, "cpu"), leaf(cell.config, path, "cpu")
        assert torch.equal(a, b), path
        if s.get("stacked"):
            last = s["shape"][0] - 1
            assert torch.equal(piece(cell.config, path, "cpu", last), a[last])
            if last and s["init"] == "normal":
                assert not torch.equal(a[0], a[last])
        if s["init"] == "normal":
            seen.add(a.flatten()[:8].float().numpy().tobytes())
    # every normal leaf from a stream of its own
    assert len(seen) == sum(s["init"] == "normal" for _, s in leaves(layout))
    with pytest.raises(ValueError):
        piece(cell.config, ("layers", "mixer", "wq"), "cpu")


# sha256 of the small cells' weights drawn by `make_weights` before the
# cells over several cards came in
DIGESTS = {
    "dsmoe-prefill-2k":
        "f5babd6d8fceb806e7fd49ab55289c152a4402869ebfb40aa74e515f437ebd1f",
    "rwkv6-prefill-4k":
        "b0924da6cb61b4ae96ae38a97c30daf6148642353fc4ed02c128e9b264ebd861",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_weights_without_a_mesh_are_the_single_draw_of_before(name):
    h = hashlib.sha256()
    for t in tensors(model_weights(small_cell(name).config, "cpu")):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[name]


def _root_with(tmp_path, cell: str, chips: int, mesh) -> Path:
    """A checkout's manifest and files with cell `cell` asking for `chips`
    and its configuration laid over `mesh` (None: no key)."""
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = [w for w in man["workloads"] if w["name"] == cell][0]
    w["chips"] = chips
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    f = [c for c in man["configs"] if c["name"] == w["config"]][0]["file"]
    config = json.loads((ROOT / f).read_text())
    if mesh is not None:
        config["mesh"] = mesh
    (tmp_path / f).write_text(json.dumps(config))
    return tmp_path


@pytest.mark.parametrize("chips,mesh,ok", (
    (1, None, True), (4, None, False), (4, {"data": 1, "model": 4}, True),
    (1, {"data": 1, "model": 4}, False), (4, {"data": 2, "model": 1}, False),
    (2, {"data": 2, "model": 1}, True), (4, {"model": 4, "pipe": 1}, False),
    (4, {"model": 0}, False)))
def test_a_cell_asks_for_the_chips_of_its_mesh(tmp_path, chips, mesh, ok):
    root = _root_with(tmp_path, "dsmoe-prefill-2k", chips, mesh)
    if ok:
        assert spec.cell("dsmoe-prefill-2k", root).chips == chips
        return
    with pytest.raises(ValueError, match="mesh"):
        spec.cell("dsmoe-prefill-2k", root)


def test_training_refuses_a_mesh():
    cell = meshed("dsmoe-train-4k", 2)
    with pytest.raises(ValueError, match="several cards"):
        train.Program(cell, 1, "cpu", False)


def test_a_reference_may_draw_its_own_pieces(monkeypatch):
    """A reference with `serve_logits_by_leaf` gets a piece drawer and the
    cell's devices, and reads what the whole tree reads."""
    from reference import moe_decoder
    from repro_torch.sharding.rules import Mesh
    calls = []

    def by_leaf(cfg, draw, tokens, prompt_len, prec, devices):
        calls.append(list(devices))
        tree: dict = {}
        for path, s in leaves(moe_decoder.param_layout(cfg)):
            t = torch.stack([draw(path, devices[0], i) for i in range(
                s["shape"][0])]) if s.get("stacked") else \
                draw(path, devices[0])
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        return moe_decoder.serve_logits(cfg, tree, tokens, prompt_len, prec)

    streamed = types.ModuleType("reference.streamed_moe")
    streamed.param_layout = moe_decoder.param_layout
    streamed.serve_logits_by_leaf = by_leaf
    monkeypatch.setitem(sys.modules, "reference.streamed_moe", streamed)
    cell = meshed("dsmoe-prefill-2k", 1, "float32")
    mesh = Mesh((1, 1), ("data", "model"), device_type="cpu")
    program = serve.Program(cell, SEED, "cpu", False, mesh)
    run = program.window(0.3, time.perf_counter())
    program.close()
    whole = serve.readings(cell, SEED, run, ["cpu"], control=True)
    cell.config["reference"] = "streamed_moe"
    assert serve.streamed(cell)
    drawn = serve.readings(cell, SEED, run, ["cpu"], control=True)
    assert drawn == whole and calls


@pytest.mark.parametrize("name", ("mfu.prefill", "moe_gemm_roofline",
                                  "rwkv6_scan_roofline"))
def test_shares_of_the_card_count_one_rank_s_part_of_the_work(name):
    """Over a mesh of n cards rank 0 does 1/n of the work: its shares of
    a card's peak are 1/n of the whole cell's work over its times."""
    from test_chipbench_stats import serve_run, synthetic_trace
    run = serve_run(trace=synthetic_trace())
    if name.startswith("rwkv6"):
        run.config = spec.cell("rwkv6-prefill-4k").config
        run.trace.device[0] = ("rwkv6_scan_kernel_tiled", 1_000_000,
                               3_000_000)
    whole = spec.reader(name).read(run)
    run.config = dict(run.config, mesh={"data": 1, "model": 4})
    assert whole > 0
    assert spec.reader(name).read(run) == pytest.approx(whole / 4)


def test_calibrate_reads_a_cell_over_two_ranks():
    from calibrate import serve_readings
    got = serve_readings(meshed("dsmoe-prefill-2k", 2), SEED, 0.6, True,
                         "cpu")
    assert {"served_gap_mean", "control_gap_mean"} <= set(got)
    assert got["control_gap_mean"] > got["served_gap_mean"]
    assert multiprocessing.active_children() == []
