"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
`jax` nor anything of the JAX package `repro`.  With both blocked, every
module of the port imports (the scan and expert-GEMM kernels' wrappers and
the Mamba2, RWKV6 and MoE layers among them), `explore(prefilter=True)`
runs, a tiny `ServeEngine` serves each decoder family (M-RoPE and MLA
among them), a tiny whisper runs `zoo.prefill` and `zoo.decode_step`,
`schedule(validate=True)` runs the port's race detector, the DSE
runtime (`repro_torch.api`, `repro_torch.obs`, `repro_torch.serve.
simulator`) runs a small traced serial sweep, and the training entry point
(`repro_torch.launch.train`) takes two steps, with the planner's and the
fault-tolerance modules imported, the sweep CLIs (`repro_torch.tools`)
run, and the multi-device layer (`repro_torch.sharding`,
`repro_torch.launch.mesh`, `repro_torch.train.pipeline`) serves and takes
a pipeline step on a one-rank mesh, the dry run counts an MoE train step
on an abstract (2, 2) mesh and the port's linter passes it.  Each new
module of the CLIs, the multi-device layer, the dry run and the gates,
imported alone, loads neither, and an abstract mesh's collectives raise
without a dry-run recorder.  `import repro_torch.
api.session` and the sweep CLIs load no torch, so a spawned sweep worker
does not pay for it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}

BLOCKED_RUN = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
sys.modules["repro"] = None
import torch
torch.set_num_threads(2)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.configs.paper_workloads import squeezenet
from repro_torch.core import explore
from repro_torch.hw.catalog import mc_hetero
r = explore(squeezenet(), mc_hetero(), ("tile", 32, 1), pop_size=16,
            generations=4, prefilter=True, device="cpu")
assert r.latency_cc > 0 and r.ga.prefilter_screened > 0
import numpy as np
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.models.module import init_from_specs
from repro_torch.models.zoo import build_param_specs
from repro_torch.serve.engine import Request, ServeEngine
for arch in ("llama3.2-3b", "zamba2-2.7b", "rwkv6-3b", "deepseek-moe-16b",
             "qwen2-vl-72b", "deepseek-v2-236b"):
    cfg = reduce_config(ARCHS[arch], n_layers=2, d_model=64, d_ff=128,
                        vocab=128)
    params = init_from_specs(build_param_specs(cfg), 0, device="cpu")
    engine = ServeEngine(cfg, params, batch_slots=2, max_len=12,
                         prompt_len=8, device="cpu")
    reqs = engine.serve([Request(prompt=np.arange(1, 9), max_new_tokens=3)
                         for _ in range(3)])
    assert all(len(r.out_tokens) == 3 for r in reqs), arch
import torch
from repro_torch.models import encdec, zoo
cfg = reduce_config(ARCHS["whisper-large-v3"], n_layers=2, d_model=64,
                    d_ff=128, vocab=128)
params = init_from_specs(build_param_specs(cfg), 0, device="cpu")
caches = init_from_specs(zoo.build_cache_specs(cfg, 2, 12), 0, device="cpu")
frames = torch.randn(2, cfg.enc["enc_len"], cfg.d_model).to(cfg.dtype)
batch = {"tokens": torch.ones(2, 8, dtype=torch.long), "enc_embeds": frames}
logits, caches = zoo.prefill(cfg, params, batch, caches)
logits, caches = zoo.decode_step(cfg, params, logits.argmax(-1)[:, None],
                                 caches, 8,
                                 enc_out=encdec.encode(cfg, params, frames))
assert bool(torch.isfinite(logits).all())
from repro_torch.core import ScheduleEngine
from repro_torch.core.allocator import manual_pingpong
from repro_torch.configs.paper_workloads import fsrcnn
from repro_torch.core import CostModel, build_graph
from repro_torch.hw.catalog import mc_hom_tpu
w, acc = fsrcnn(), mc_hom_tpu()
eng = ScheduleEngine(build_graph(w, acc, ("tile", 8, 1)), CostModel(w, acc),
                     acc)
assert eng.schedule(manual_pingpong(w, acc), validate=True).latency_cc > 0
for mod in ("ssd_scan", "rwkv6_scan", "moe_gemm"):
    assert f"repro_torch.kernels.{mod}" in names
import repro_torch.api, repro_torch.obs, repro_torch.serve.simulator
from repro_torch.api import DesignSpace, ExplorationSession, GAConfig
from repro_torch.obs import Tracer
from repro_torch.hw.catalog import sc_tpu
tracer = Tracer()
sweep = ExplorationSession(tracer=tracer).run(DesignSpace(
    workloads=["fsrcnn"], archs={"SC:TPU": sc_tpu, "MC:HomTPU": mc_hom_tpu},
    granularities=["layer", ("tile", 8, 1)],
    ga=GAConfig(pop_size=4, generations=2)))
assert len(sweep) == sweep.n_scheduled == 4 and sweep.n_failed == 0
assert tracer.snapshot()["counters"]["sweep.computed"] == 4
from repro_torch.launch import train
params = train.main(["--smoke", "--steps", "2", "--layers", "2", "--d-model",
                     "64", "--seq", "16", "--batch", "2", "--device", "cpu"])
assert bool(torch.isfinite(params["embed"]).all())
for mod in ("core.planner", "train.fault_tolerance", "train.checkpoint",
            "train.optimizer", "train.train_step", "train.data"):
    assert f"repro_torch.{mod}" in names
for mod in ("tools.run_shard", "tools.merge_stores", "tools.sweep_top",
            "tools.trace_export", "sharding.rules", "sharding.collectives",
            "launch.mesh", "train.pipeline"):
    assert f"repro_torch.{mod}" in names
import tempfile
from repro_torch.tools import sweep_top, trace_export
with tempfile.TemporaryDirectory() as d:
    assert trace_export.main(["--out", d, "--device", "cpu"]) == 0
    assert "fleet: 0/0 live" in sweep_top.render(
        sweep_top.fleet_snapshot([], []))
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.pipeline import make_pipeline_loss
mesh = make_host_mesh(device_type="cpu")
cfg = reduce_config(ARCHS["llama3.2-3b"], n_layers=2, d_model=64, d_ff=128,
                    vocab=128)
params = init_from_specs(build_param_specs(cfg), 0, device="cpu")
engine = ServeEngine(cfg, params, mesh=mesh, batch_slots=2, max_len=12,
                     prompt_len=8, device="cpu")
reqs = engine.serve([Request(prompt=np.arange(1, 9), max_new_tokens=3)])
assert len(reqs[0].out_tokens) == 3
from repro_torch.models.module import tree_map
from repro_torch.sharding.rules import Mesh
pipe = Mesh((1, 1), ("pipe", "data"), device_type="cpu")
p1 = dict(params, layers=tree_map(lambda a: a[None], params["layers"]))
toks = torch.ones(2, 8, dtype=torch.long)
loss = make_pipeline_loss(cfg, pipe, n_stages=1, n_microbatches=2)(
    p1, {"tokens": toks, "labels": toks})
assert bool(torch.isfinite(loss))
for mod in ("analysis.hlo", "analysis.roofline", "analysis.probe",
            "launch.dryrun", "analysis.staticcheck.linter",
            "analysis.staticcheck.tiers", "tools.check_static",
            "tools.check_docs"):
    assert f"repro_torch.{mod}" in names
from repro_torch.launch import dryrun
small = reduce_config(ARCHS["deepseek-moe-16b"], n_layers=2, d_model=64,
                      d_ff=128, vocab=128)
ARCHS["moe-small"] = small
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs import SHAPES
SHAPES["train-small"] = ShapeConfig("train-small", "train", 32, 4)
_, rep = dryrun.lower_cell("moe-small", "train-small", multi_pod=False,
                           mesh=Mesh.abstract((2, 2), ("data", "model"),
                                              device_type="cpu"),
                           device="cpu")
assert rep["roofline"]["flops"] > 0 and rep["roofline"]["collective_bytes"]
from repro_torch.tools import check_static
assert check_static.main(["--strict"]) == 0
assert sys.modules["jax"] is None and sys.modules["repro"] is None
print(len(names), "modules")
"""


def _imported_roots(tree: ast.AST):
    """(line, top-level module) of every import, including the string
    arguments of `importlib.import_module` and `__import__`."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files
           for line, mod in _imported_roots(ast.parse(f.read_text()))
           if mod in FORBIDDEN]
    assert not bad, bad


def test_port_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "modules" in out.stdout


def test_abstract_mesh_collectives_raise_without_a_recorder():
    """An abstract mesh has no process group: with no dry-run recorder
    attached its collectives raise, so no real run can skip one."""
    import torch

    from repro_torch.sharding.collectives import all_reduce
    from repro_torch.sharding.rules import Mesh, all_gather
    mesh = Mesh.abstract((2, 4), ("data", "model"), device_type="cpu")
    x = torch.ones(4)
    for call in (lambda: all_gather(x, mesh, "data"),
                 lambda: all_reduce(x, mesh, "model")):
        with pytest.raises(RuntimeError, match="no process group"):
            call()
    # along an axis of one rank there is nothing to do, recorder or not
    one = Mesh.abstract((1, 4), ("data", "model"), device_type="cpu")
    assert all_gather(x, one, "data") is x and all_reduce(x, one, "data") is x


def test_sweep_runtime_imports_no_torch():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys; import repro_torch.api.session, repro_torch.api, "
            "repro_torch.obs, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.tools.run_shard, repro_torch.tools.merge_stores, "
            "repro_torch.tools.sweep_top, repro_torch.tools.trace_export; "
            "print(sorted(m for m in ('torch', 'jax', 'repro') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("mods", [
    ("tools.run_shard", "tools.merge_stores", "tools.sweep_top",
     "tools.trace_export"),
    ("sharding.rules", "sharding.collectives"),
    ("launch.mesh",),
    ("train.pipeline",),
    ("analysis.hlo", "analysis.roofline", "analysis.probe"),
    ("launch.dryrun",),
    ("analysis.staticcheck.linter", "analysis.staticcheck.tiers"),
    ("tools.check_static", "tools.check_docs")],
    ids=["tools", "sharding", "mesh", "pipeline", "analysis", "dryrun",
         "staticcheck", "gates"])
def test_new_modules_alone_load_neither_jax_nor_repro(mods):
    """Each module of the CLIs, the multi-device layer, the dry run and
    the port's gates, imported by itself into a fresh interpreter, leaves
    `jax` and `repro` unloaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import importlib, sys\n"
            f"for m in {list(mods)!r}:\n"
            "    importlib.import_module('repro_torch.' + m)\n"
            "    bad = [k for k in ('jax', 'jaxlib', 'repro') "
            "if k in sys.modules]\n"
            "    assert not bad, (m, bad)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
