"""BENCHMARK.json against the rules its manifest keeps (names, units,
bounds, the cells' metrics), and every file it names present."""
import json
import math
import re
from pathlib import Path

import pytest

from harness import spec

ROOT = Path(__file__).resolve().parents[1]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|d_model|d_ff|expert|top_k|expand)")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "chipbench/run.py"]
    assert MAN["paths"] == ["chipbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_check_fits_the_day_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"].startswith("chipbench/configs/")
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data and not WIDTH.search(key)
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])
    assert (ROOT / "chipbench" / "reference" /
            f"{data['reference']}.py").exists()


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    cell = spec.cell(w["name"], ROOT)
    assert w["chips"] in (1, 4)
    assert NAME.match(w["traffic"])
    assert cell.traffic["kind"] in ("serve", "train")
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, math.floor(0.25 * len(MAN["workloads"])))


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in MAN["end_to_end"]]
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    moved = [e for e in MAN["end_to_end"] if e["name"] == m["moves"]][0]
    for w in m["workloads"]:
        assert w in moved.get("workloads", [w])
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(m):
    assert callable(spec.reader(m["name"], ROOT).read)


def test_files_are_named_from_name_characters():
    for f in (ROOT / "chipbench").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$",
                        str(f.relative_to(ROOT))), f
