"""The port's dry-run analysis (`repro_torch.analysis.{hlo,roofline,probe}`)
against the JAX package's (`tests/test_analysis.py:13-62` there): the
recorder counts a Python loop of matmuls exactly (the port's loops are
unrolled: no trip counts), an abstract mesh's collectives in exact ring
bytes by kind, the roofline's terms exactly with the H100 constants, and
the per-device dot FLOPs of reduced llama, zamba2 and deepseek-moe at
train, prefill and decode on an (8, 1) data-only mesh against the
reference walker over the reference's compiled program on 8 host devices.

The reference's programs are built here as its `launch/dryrun.py` builds
them, without importing that module (it sets 512 host devices on
import)."""
import dataclasses

import jax
import pytest
import torch

from repro.analysis.hlo import analyze as ref_analyze
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.configs.base import ShapeConfig as RefShape
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import zoo as ref_zoo
from repro.models.module import abstract_from_specs as ref_abstract
from repro.sharding.rules import sharding_for as ref_sharding_for
from repro.sharding.rules import tree_shardings as ref_tree_shardings
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.train_step import TrainStepConfig as RefStepConfig
from repro.train.train_step import make_train_step as ref_make_train_step
from repro.train.train_step import train_state_specs as ref_state_specs

from repro_torch.analysis import hlo, probe
from repro_torch.analysis.roofline import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                           Roofline)
from repro_torch.configs import ARCHS, SHAPES, reduce_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.rules import Mesh, all_gather

# the reference's `launch/dryrun.py` batch layouts
_BATCH_AXES = {"tokens": ("batch", None), "labels": ("batch", None),
               "enc_embeds": ("batch", None, None),
               "mrope_positions": (None, "batch", None), "cur_len": None}


def test_recorder_counts_python_loop_dot_flops():
    """A loop of L matmul pairs counts exactly L x the pair's FLOPs: the
    loop is unrolled, so no trip count is needed or recorded."""
    L, M, K, N = 7, 32, 48, 16
    W = torch.ones(L, K, N)
    back = torch.ones(N, K)

    def f(x):
        for i in range(L):
            x = x @ W[i] @ back
        return x

    a = hlo.analyze(f, torch.ones(M, K))
    assert a.flops == L * (2 * M * K * N + 2 * M * N * K)
    assert a.while_trip_counts == {}
    # operands and output of every dot, float32, towards HBM
    per_pair = 4 * (M * K + K * N + M * N) + 4 * (M * N + N * K + M * K)
    assert a.hbm_bytes == L * per_pair


def test_recorder_counts_collective_ring_bytes_exactly():
    """One all_gather over 4 ranks and one all_reduce over 8 on an abstract
    (4, 8) mesh: the outputs have the true shapes, and the wire bytes are
    the reference's ring formulas in the tensor's dtype."""
    mesh = Mesh.abstract((4, 8), ("data", "model"), device_type="cpu")
    x = torch.ones(3, 5, dtype=torch.bfloat16)
    with hlo.Recorder(mesh) as rec:
        g = all_gather(x, mesh, "data", dim=1)
        r = all_reduce(torch.ones(6, dtype=torch.float32), mesh, "model")
    assert g.shape == (3, 20) and g.dtype == torch.bfloat16
    assert r.shape == (6,)
    a = rec.analysis()
    assert a.collective_bytes == {"all-gather": 3 * 20 * 2 * 3 / 4,
                                  "all-reduce": 2 * 6 * 4 * 7 / 8}
    assert a.n_collectives == {"all-gather": 1, "all-reduce": 1}
    assert a.total_collective_bytes == 90.0 + 42.0
    assert a.hbm_bytes == 2 * (3 * 20 * 2) + 2 * (6 * 4)
    assert [k for k, *_ in rec.log] == ["all-gather", "all-reduce"]
    # outside the recorder the abstract mesh is bare again
    assert mesh.recorder is None


def test_probe_blames_collectives_by_source():
    mesh = Mesh.abstract((2,), ("data",), device_type="cpu")
    with hlo.Recorder(mesh) as rec:
        for _ in range(3):
            all_gather(torch.ones(4), mesh, "data")
        all_reduce(torch.ones(64), mesh, "data")
    rows, a = probe.collective_blame(rec)
    assert [(kind, count) for _, (kind, _), count, _ in rows] == [
        ("all-reduce", 1), ("all-gather", 3)]
    assert rows[0][0] == 2 * 64 * 4 / 2 and rows[1][0] == 3 * 8 * 4 / 2
    assert all("test_torch_analysis.py" in where for _, (_, where), _, _
               in rows)
    lines = []
    probe.print_blame(rec, report=lines.append)
    assert lines[0].startswith("total collective bytes/device: 3.040e+02")


def test_recorder_refuses_nothing_but_abstract_meshes():
    class Real:                     # a mesh with a process group behind it
        device_mesh = object()
    with pytest.raises(ValueError, match="abstract"):
        hlo.Recorder(Real())


def test_roofline_terms_and_bottleneck():
    """The reference's test with the H100 constants: each term exact."""
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 50e9)
    r = Roofline(chips=256, flops=989e12, hbm_bytes=10e9,
                 attn_tile_bytes=0.0,
                 collective_bytes=100e9, collective_breakdown={},
                 model_flops=989e12 * 256 * 0.5, xla_flops=0, xla_bytes=0)
    assert r.t_compute == 1.0
    assert r.t_memory == 10e9 / 3.35e12
    assert r.t_collective == 2.0
    assert r.bottleneck == "collective"
    assert r.step_time_s == 2.0
    assert r.useful_flops_ratio == 0.5
    assert r.mfu == 0.25
    fused = dataclasses.replace(r, attn_tile_bytes=4e9)
    assert fused.t_memory == 6e9 / 3.35e12
    assert fused.t_memory_unfused == 10e9 / 3.35e12


# ---------------------------------------------------------------------------
# against the reference walker on the reference's compiled program
# ---------------------------------------------------------------------------

B, S = 8, 64
MESH = (8, 1)


def _ref_program_flops(arch: str, kind: str) -> float:
    """Per-device dot FLOPs of the reference's compiled cell (the reduced
    config at B x S on an (8, 1) mesh), by the reference walker."""
    cfg = ref_reduce(REF_ARCHS[arch])
    shape = RefShape("cell", kind, S, B)
    mesh = compat_make_mesh(MESH, ("data", "model"))
    pspecs = ref_zoo.build_param_specs(cfg)
    params_abs = ref_abstract(pspecs)
    params_sh = ref_tree_shardings(pspecs, mesh)
    data = ref_zoo.input_specs(cfg, shape)
    data_sh = {k: ref_sharding_for(_BATCH_AXES[k], v.shape, mesh)
               for k, v in data.items()}
    with compat_set_mesh(mesh):
        if kind == "train":
            step_cfg = RefStepConfig(remat=True, opt=RefAdamW())
            sspecs = ref_state_specs(pspecs, step_cfg)
            state_sh = ref_tree_shardings(sspecs, mesh)
            lowered = jax.jit(
                ref_make_train_step(cfg, mesh, step_cfg),
                in_shardings=(params_sh, state_sh, data_sh),
                out_shardings=(params_sh, state_sh, None)).lower(
                    params_abs, ref_abstract(sspecs), data)
        else:
            cspecs = ref_zoo.build_cache_specs(cfg, B, S)
            caches_sh = ref_tree_shardings(cspecs, mesh)
            if kind == "prefill":
                def fn(p, b, c):
                    return ref_zoo.prefill(cfg, p, b, c, mesh=mesh)
                in_sh = (params_sh, data_sh, caches_sh)
                args = (params_abs, data, ref_abstract(cspecs))
            else:
                def fn(p, t, c, n):
                    return ref_zoo.decode_step(cfg, p, t, c, n, mesh=mesh)
                in_sh = (params_sh, data_sh["tokens"], caches_sh,
                         data_sh["cur_len"])
                args = (params_abs, data["tokens"], ref_abstract(cspecs),
                        data["cur_len"])
            lowered = jax.jit(fn, in_shardings=in_sh,
                              out_shardings=(None, caches_sh)).lower(*args)
        compiled = lowered.compile()
    return ref_analyze(compiled.as_text()).flops


def _port_cell(monkeypatch, arch: str, kind: str, mesh_shape=MESH):
    monkeypatch.setitem(ARCHS, "cell", reduce_config(ARCHS[arch]))
    monkeypatch.setitem(SHAPES, "cell", ShapeConfig("cell", kind, S, B))
    mesh = Mesh.abstract(mesh_shape, ("data", "model"), device_type="cpu")
    return dryrun.lower_cell("cell", "cell", multi_pod=False, mesh=mesh,
                             device="cpu")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_port_flops_match_the_reference_walker(monkeypatch, arch, kind):
    """Prefill and decode: the same dots (exact to float rounding of the
    sums).  Train: the port's chunked cross entropy runs each block under
    a checkpoint, so its head product runs once more than in the
    reference's compiled step (4 passes against 3: 2 * tokens * D * V a
    device; measured gaps 4.17%, 1.94% and 4.75% at this size); without
    that product the two agree within 1% (measured 0.0%, 0.13% and 0.53%:
    zamba2's reference has 16 small SSD dots the port computes
    elementwise, deepseek-moe's compiled step one fewer shared-expert
    product; PERF.md)."""
    _, rep = _port_cell(monkeypatch, arch, kind)
    port = rep["roofline"]["flops"]
    want = _ref_program_flops(arch, kind)
    assert rep["roofline"]["xla_flops"] == port
    if kind != "train":
        assert port == pytest.approx(want, rel=1e-9)
        return
    cfg = ARCHS["cell"]
    extra_head = 2.0 * (B // MESH[0]) * S * cfg.d_model * cfg.vocab
    assert port == pytest.approx(want, rel=0.05)
    assert port - extra_head == pytest.approx(want, rel=0.01)


def test_model_axis_replicates_the_dense_work(monkeypatch):
    """At (2, 4) every model rank gathers whole weights and runs its data
    rank's rows, so reduced llama's per-device FLOPs equal its own at
    (2, 1): the gathered-weight design the production numbers rest on."""
    flops = {}
    for shape in ((2, 4), (2, 1)):
        _, rep = _port_cell(monkeypatch, "llama3.2-3b", "train", shape)
        flops[shape] = rep["roofline"]["flops"]
    assert flops[(2, 4)] == flops[(2, 1)]
