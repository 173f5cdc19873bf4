"""The port's meshes (`repro_torch.launch.mesh`) and the two regions that
run on 8 gloo ranks: `make_production_mesh` refuses a world of 8, as the
reference refuses 8 devices, and so do `launch.serve` and `launch.train`
under `--production-mesh`; `make_host_mesh` keeps the reference's
model-parallel fallback; split-KV decode over 8 ranks and the
expert-parallel MoE on a (4, 2) (data, model) mesh equal the reference's
on a mesh of the same shape.  One spawn of 8 ranks runs all of it.

Tolerances: split-KV decode 1e-5 in float32 and 2e-2 in bfloat16
(`tests/test_kernels.py:17-19`); the MoE layer the port's MoE tolerances
(`_torch_inputs.TOL`), `aux` 1e-6 relative."""
import jax
import numpy as np
import pytest
from _torch_mesh_worker import results, run
from _torch_mesh_cases import kv_cases, kv_reference, moe_cases, check_moe

from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.mesh import make_production_mesh as ref_production

from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     world_size)

KV_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    d = tmp_path_factory.mktemp("eight")
    inputs = {"kv_cases": kv_cases(8), "moe_cases": moe_cases([(4, 2)])}
    out = run(8, ["production_mesh_raises", "kv_sharded", "moe_mesh"], d,
              inputs)
    out["inputs"] = inputs
    return out


def test_host_mesh_without_a_process_group():
    """One process, no process group: a (1, 1) mesh, as the reference's
    host mesh over one device; the model-parallel fallback keeps 1."""
    assert world_size() == 1
    for mp in (1, 2):
        mesh = make_host_mesh(mp, device_type="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.device_type == "cpu" and mesh.rank == 0


def test_production_mesh_raises_in_one_process():
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="must be >= the product"):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_production_mesh_raises_at_world_8_as_the_reference(eight):
    """At a world of 8 the production meshes raise the reference's error at
    8 devices (`jax.make_mesh`'s words) and the host meshes have the
    reference's shapes at 8 devices.  The live reference is asked where
    this process holds the suite's 8 JAX host devices (a worker that
    imported `repro.launch.dryrun` holds 512)."""
    want = {mp: "Number of devices 8 must be >= the product of mesh_shape "
                f"{shape}" for mp, shape in ((False, (16, 16)),
                                             (True, (2, 16, 16)))}
    shapes = {1: {"data": 8, "model": 1}, 2: {"data": 4, "model": 2},
              3: {"data": 8, "model": 1}}
    if len(jax.devices()) == 8:
        for multi_pod in (False, True):
            with pytest.raises(ValueError) as exc:
                ref_production(multi_pod=multi_pod)
            assert str(exc.value).startswith(want[multi_pod])
        assert {mp: dict(ref_host_mesh(mp).shape) for mp in shapes} == \
            shapes
    for r in results(eight, "production_mesh_raises"):
        for multi_pod in (False, True):
            assert r[multi_pod].startswith(want[multi_pod]), r[multi_pod]
        assert (r["host"], r["host_mp2"], r["host_mp3"]) == \
            (shapes[1], shapes[2], shapes[3])


def test_launch_production_mesh_raises_at_world_8(eight):
    for r in results(eight, "production_mesh_raises"):
        for mod in ("serve", "train"):
            assert r[mod] is not None and "(16, 16)" in r[mod]


def test_gloo_ranks_import_neither_jax_nor_repro(eight):
    assert eight["imports"] == [[]] * 8


@pytest.mark.parametrize("i", range(len(kv_cases(8))))
def test_kv_sharded_decode_at_8_ranks(eight, i):
    case = eight["inputs"]["kv_cases"][i]
    want, plain = kv_reference(case, 8)
    for got in results(eight, "kv_sharded"):
        np.testing.assert_allclose(got[i], want, **KV_TOL[case["dtype"]])
        np.testing.assert_allclose(got[i], plain, **KV_TOL[case["dtype"]])


@pytest.mark.parametrize("i", range(len(moe_cases([(4, 2)]))))
def test_moe_ffn_on_a_4_by_2_mesh(eight, i):
    check_moe(eight["inputs"]["moe_cases"][i],
              [r[i] for r in results(eight, "moe_mesh")])
