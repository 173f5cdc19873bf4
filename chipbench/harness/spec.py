"""What a run needs, found by name: `BENCHMARK.json` at the checkout's root
names the cell, and the cell names its configuration file, its traffic
file (`chipbench/traffic/<traffic>.json`), its correctness limits
(`chipbench/limits/<workload>.json`) and its metrics, each read by
`chipbench/metrics/<metric>.py`.  The configuration file names its plain
reference (`chipbench/reference/<reference>.py`).  A new cell, mix,
configuration or metric is a new file and a new entry; nothing here
changes.

A configuration's optional `mesh` ({"data": d, "model": m}) lays its
model out over d x m cards, one rank a card (`harness/ranks.py`); a cell
of it asks for exactly that many `chips`.  Without the key a cell runs on
one rank and asks for one chip.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path

MESH_AXES = ("data", "model")

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    limits: dict            # number -> {"limit", ...}
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported(entries: list, workload: str) -> list:
    return [m for m in entries if workload in m.get("workloads", [workload])]


def mesh_size(config: dict) -> int:
    """The ranks of the configuration's `mesh` (1 without one)."""
    mesh = config.get("mesh")
    if mesh is None:
        return 1
    if not mesh or set(mesh) - set(MESH_AXES) or not all(
            isinstance(n, int) and n >= 1 for n in mesh.values()):
        raise ValueError(f"{config.get('name')}: mesh {mesh} is not a "
                         f"positive size over {MESH_AXES}")
    return math.prod(mesh.values())


def cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in man["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / cfg_entry["file"]).read_text())
    if w["chips"] != mesh_size(config):
        raise ValueError(
            f"{name} asks for {w['chips']} chips, but its configuration "
            f"{w['config']} lays its model over {mesh_size(config)} "
            f"(mesh {config.get('mesh', 'absent: one rank')})")
    traffic = json.loads(
        (root / "chipbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "chipbench" / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits, end_to_end=_reported(man["end_to_end"], name),
                per_layer=_reported(man["per_layer"], name))


def load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The module `chipbench/metrics/<metric>.py` (its `read(run)`)."""
    return load_file(root / "chipbench" / "metrics" / f"{metric}.py",
                     "chipbench_metric_" + metric.replace(".", "_")
                     .replace("-", "_"))


def reference(config: dict):
    """The plain reference module the configuration file names."""
    return importlib.import_module(f"reference.{config['reference']}")


def arch_config(config: dict):
    """The program's `ArchConfig` with exactly the file's values of its
    fields (the file's other keys describe the configuration)."""
    import torch

    from repro_torch.configs.base import ArchConfig
    fields = {f.name: config[f.name] for f in dataclasses.fields(ArchConfig)
              if f.name in config}
    fields["dtype"] = getattr(torch, fields["dtype"])
    if "mrope_sections" in fields:
        fields["mrope_sections"] = tuple(fields["mrope_sections"])
    return ArchConfig(**fields)
