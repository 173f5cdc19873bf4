"""`run.py` refuses without a card, and the rest of a run works end to end
on the CPU at a small size."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness.cell_run import run_cell
from harness.small import small_cell

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--workload", "dsmoe-prefill-2k", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def run_py(cwd):
    return subprocess.run([sys.executable, "chipbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ("dsmoe-prefill-2k", "rwkv6-prefill-4k",
                                  "dsmoe-train-4k", "rwkv6-train-4k"))
@pytest.mark.parametrize("traced", (False, True))
def test_a_small_run_on_the_cpu(name, traced):
    cell = small_cell(name)
    line = run_cell(cell, 2 ** 31 + 11, 0.5, traced, torch.device("cpu"),
                    time.perf_counter())
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in (cell.per_layer if traced
                                else cell.end_to_end)}
    got = set(line["metrics"])
    assert got <= want
    if not traced:      # on the CPU: no allocator peak to read
        assert got == want - {"peak_mem_gib"}
    else:
        assert "breakdown" in line and "busy_s" in line["device"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    from harness import serve
    tr = small_cell("dsmoe-prefill-2k").traffic
    a = serve.Feed(tr, 512, 2 ** 33 + 1).wave(8)
    b = serve.Feed(tr, 512, 2 ** 33 + 1).wave(8)
    c = serve.Feed(tr, 512, 2 ** 33 + 2).wave(8)
    assert all((x == y).all() for x, y in zip(a, b))
    assert [len(x) for x in a] != [len(x) for x in c] or \
        any((x != y).any() for x, y in zip(a, c))
    # every seed deals from the same set of lengths
    pool = sorted(serve.length_pool(tr))
    d = serve.Feed(tr, 512, 5)
    assert sorted(len(p) for p in d.wave(len(pool))) == pool
