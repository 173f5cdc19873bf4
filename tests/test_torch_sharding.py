"""The port's sharding rules (`repro_torch.sharding.rules`) against the JAX
package's: `spec_for` equals the reference's exactly over a property of
shapes, logical axes and mesh shapes (and the twin of
`test_sharding_rules_divisibility_fallback`); `tree_shardings` gives the
reference's specs for every config's parameters; and on 4 gloo ranks the
mesh's process groups, the cut and gather of a whole tree, the collectives'
backward passes and `checkpoint.restore(shardings=)` onto a (2, 2) mesh."""
import math

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_mesh_worker import results, run, to_wire

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh
from repro.models.module import init_from_specs as ref_init
from repro.models.zoo import build_param_specs as ref_param_specs
from repro.sharding import rules as ref_rules

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.models.module import tree_leaves
from repro_torch.models.zoo import build_param_specs
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (DEFAULT_RULES, Mesh, NamedSharding,
                                        P, batch_axes, constrain, spec_for,
                                        tree_shardings)

LOGICAL = [None, "batch", "seq", "kv_seq", "embed", "vocab", "heads",
           "kv_heads", "mlp", "expert", "layers", "seq_model"]
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((8,), ("data",)), ((2, 2, 2), ("pod", "data", "model")),
          ((1, 8), ("data", "model")), ((2, 2), ("pipe", "data"))]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 510, 512]


def _ref_mesh(shape, axes):
    return compat_make_mesh(shape, axes)


def _same(got, want):
    """A port spec against a reference `PartitionSpec`, entry by entry."""
    return tuple(got) == tuple(want)


def test_default_rules_equal_reference():
    assert DEFAULT_RULES == ref_rules.DEFAULT_RULES


@settings(max_examples=300, deadline=None)
@given(st.sampled_from(range(len(MESHES))), st.integers(1, 4),
       st.integers(0, 10 ** 9))
def test_spec_for_equals_reference(mesh_i, rank, seed):
    shape, axes = MESHES[mesh_i]
    rng = np.random.default_rng(seed)
    dims = tuple(int(rng.choice(DIMS)) for _ in range(rank))
    logical = tuple(LOGICAL[i] for i in rng.integers(len(LOGICAL),
                                                      size=rank))
    got = spec_for(logical, dims, Mesh.abstract(shape, axes))
    want = ref_rules.spec_for(logical, dims, _ref_mesh(shape, axes))
    assert _same(got, want), (logical, dims, shape, got, want)
    assert spec_for(None, dims, Mesh.abstract(shape, axes)) == P()


def test_sharding_rules_divisibility_fallback():
    """Twin of test_analysis.py::test_sharding_rules_divisibility_fallback."""
    mesh = Mesh.abstract((2, 4), ("data", "model"))
    assert spec_for(("vocab", None), (512, 16), mesh)[0] == "model"
    s = spec_for(("vocab", None), (510, 16), mesh)
    assert len(s) == 0 or s[0] is None
    s = spec_for(("batch", None), (8, 16), mesh)
    assert s[0] == ("data",) or s[0] == "data"
    # each mesh axis is used once: a second dim mapped to it replicates
    assert spec_for(("mlp", "heads"), (8, 8), mesh) == P("model")
    # combined axes split major to minor
    mesh3 = Mesh.abstract((2, 2, 2), ("pod", "data", "model"))
    assert spec_for(("batch", "mlp"), (8, 8), mesh3) == \
        P(("pod", "data"), "model")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "whisper-large-v3"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_tree_shardings_equal_reference(arch, shape):
    """Every parameter leaf's spec on a (data, model) mesh equals the
    reference's `tree_shardings` spec, leaf for leaf."""
    cfg = reduce_config(ARCHS[arch])
    ref = jax.tree.leaves(ref_rules.tree_shardings(
        ref_param_specs(ref_reduce(REF_ARCHS[arch])),
        _ref_mesh(shape, ("data", "model"))))
    got = tree_leaves(tree_shardings(
        build_param_specs(cfg), Mesh.abstract(shape, ("data", "model"))))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _same(g.spec, r.spec)


def test_named_sharding_placements_and_blocks():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh.abstract((2, 2, 2), ("pod", "data", "model"))
    sh = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.local_shape((8, 3, 6)) == (2, 3, 3)
    assert NamedSharding(mesh, P()).placements == (Replicate(),) * 3
    x = torch.arange(48.).reshape(8, 3, 2)
    assert NamedSharding(mesh, P()).shard(x) is x
    assert torch.equal(sh.shard(x)[..., :1], x[:2, :, :1])
    assert batch_axes(mesh, 8) == ("pod", "data")
    assert batch_axes(mesh, 6) == ()
    assert batch_axes(None, 8) == ()


def test_one_rank_mesh_is_the_identity():
    """Without a process group the host mesh has one rank: `constrain`,
    the shard and every collective hand their input back untouched."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    x = torch.randn(4, 3, requires_grad=True)
    assert constrain(x, None, "batch", None) is x
    assert constrain(x, mesh, "batch", None) is x
    sh = NamedSharding(mesh, P("data", "model"))
    assert C.gather_param(x, sh, ("data",)) is x
    for fn in (C.copy_to, C.reduce_from, C.mean_over):
        assert fn(x, mesh, ("data", "model")) is x
    assert C.shift(x, mesh, "data") is x
    assert C.rows(x, mesh, ("data",)) is x


def test_abstract_mesh_refuses_collectives():
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="no process group"):
        C.all_reduce(torch.ones(2), mesh, "data")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        Mesh((2, 2), ("data", "model"), device_type="cpu")


# ---------------------------------------------------------------------------
# on 4 gloo ranks
# ---------------------------------------------------------------------------

CFG = ("llama3.2-3b", dict(n_layers=2), "bfloat16")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """One spawn of 4 gloo ranks running every scenario of this file."""
    from repro_torch.train import checkpoint as ckpt
    d = tmp_path_factory.mktemp("four")
    cfg = reduce_config(ARCHS[CFG[0]], **CFG[1])
    params = ref_init(ref_param_specs(ref_reduce(REF_ARCHS[CFG[0]],
                                                 **CFG[1])),
                      jax.random.PRNGKey(0))
    wire = to_wire(jax.tree.map(np.asarray, params))
    inputs = {"cfg": CFG, "mesh_shape": (2, 2),
              "mesh_axes": ("data", "model"), "params": wire,
              "ckpt_dir": str(d / "ckpt")}
    if ckpt.zstandard is not None:
        from _torch_mesh_worker import from_wire
        ckpt.save(str(d / "ckpt"), 1, from_wire(wire))
    scen = ["mesh_groups", "shard_gather_roundtrip", "collective_grads"]
    if ckpt.zstandard is not None:
        scen.append("restore_sharded")
    out = run(4, scen, d / "run", inputs)
    out["cfg"] = cfg
    return out


def test_gloo_ranks_import_neither_jax_nor_repro(four):
    assert four["imports"] == [[]] * 4


def test_mesh_groups_on_four_ranks(four):
    res = results(four, "mesh_groups")
    for rank, r in enumerate(res):
        assert r["coords"] == {"data": rank // 2, "model": rank % 2}
        assert r[("data",)] == (2, rank // 2, [rank % 2, rank % 2 + 2])
        assert r[("model",)] == (2, rank % 2,
                                 [rank - rank % 2, rank - rank % 2 + 1])
        assert r[("data", "model")] == (4, rank, [0, 1, 2, 3])
        assert "data=2, model=2" in r["dm"]


def test_shard_and_gather_tree_on_four_ranks(four):
    res = results(four, "shard_gather_roundtrip")
    assert all(r["equal"] for r in res)
    # the embedding (vocab, D) splits vocab over "model"; wq (L, D, H)
    # splits D over "data" and the heads over "model"
    specs = build_param_specs(four["cfg"])
    want = [NamedSharding(Mesh.abstract((2, 2), ("data", "model")),
                          spec_for(s.axes, s.shape, Mesh.abstract(
                              (2, 2), ("data", "model")))).local_shape(
                                  s.shape) for s in tree_leaves(specs)]
    assert res[0]["shapes"] == want
    assert sum(math.prod(s) for s in want) < sum(
        math.prod(s.shape) for s in tree_leaves(specs))


def test_collective_backward_passes_on_four_ranks(four):
    """`gather_param`'s backward sums over the batch's ranks and keeps
    this rank's block; `copy_to` sums, `reduce_from` passes through,
    `mean_over` divides, `shift` sends the gradient back a rank: each
    against the gradient of the same function on one process."""
    res = results(four, "collective_grads")
    for r in res:
        for name, (got, want) in r.items():
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def test_restore_onto_a_two_by_two_mesh(four):
    from repro_torch.train import checkpoint as ckpt
    if ckpt.zstandard is None:
        pytest.skip("optional 'zstandard' not installed")
    res = results(four, "restore_sharded")
    assert all(r["equal"] for r in res)
    assert all(r["split"] > 0 and r["split"] < r["n"] for r in res)
