"""The port's GPipe pipeline (`repro_torch.train.pipeline`) on 4 gloo
ranks as a (pipe 2, data 2) mesh, the twin of
`test_train_substrate.py::test_pipeline_loss_matches_reference`: the
reduced llama3.2-3b at 4 layers, 2 stages, 2 microbatches.

- bfloat16 (the reference test's config): the loss within 1e-3 of the
  reference's `train_loss` and of its pipeline loss on the same mesh.
- float32: the loss within 1e-5 relative of the reference's pipeline
  loss, and every gradient (each rank's stage of the layers, the whole
  embedding and final norm) within 1e-4 of its leaf's largest magnitude
  of the reference's `jax.grad` of its pipeline loss (the port's
  `train_loss` gradients' tolerance, `test_torch_train.py`), a stronger
  hold than the reference's finite, nonzero norm.

`stage_stacked_specs` gives the reference's intended specs: the
reference's own raises (one axis name too few; ROADMAP §3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_worker import results, run, to_wire

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models.module import init_from_specs as ref_init
from repro.models.zoo import build_param_specs as ref_param_specs
from repro.models.zoo import train_loss as ref_train_loss
from repro.train.pipeline import make_pipeline_loss as ref_pipeline_loss
from repro.train.pipeline import stage_stacked_specs as ref_stage_specs

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.models.module import tree_leaves
from repro_torch.train.pipeline import stage_stacked_specs

CASES = {"bfloat16": ("llama3.2-3b", dict(n_layers=4), "bfloat16"),
         "float32": ("llama3.2-3b", dict(n_layers=4), "float32")}


def _ref(case):
    name, kw, dtype = case
    rc = dataclasses.replace(ref_reduce(REF_ARCHS[name], **kw),
                             dtype=getattr(jnp, dtype))
    params = ref_init(ref_param_specs(rc), jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    batch = {"tokens": jax.random.randint(key, (4, 32), 0, rc.vocab),
             "labels": jax.random.randint(key, (4, 32), 0, rc.vocab)}
    return rc, params, batch


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    cases = []
    for dtype, case in CASES.items():
        _, params, batch = _ref(case)
        cases.append({"cfg": case,
                      "params": to_wire(jax.tree.map(np.asarray, params)),
                      "batch": {k: np.asarray(v) for k, v in batch.items()}})
    return run(4, ["pipeline_mesh"], tmp_path_factory.mktemp("pipe"),
               {"pipe_cases": cases})


def _reference(case, grad=False):
    """(the reference's train_loss, its pipeline loss on a (pipe 2, data 2)
    mesh, and that loss's `jax.grad` if `grad`)."""
    rc, params, batch = _ref(case)
    mesh = compat_make_mesh((2, 2), ("pipe", "data"))
    with compat_set_mesh(mesh):
        ref = ref_train_loss(rc, params, batch, mesh=mesh, remat=False)
        p2 = dict(params)
        p2["layers"] = jax.tree.map(
            lambda a: a.reshape((2, 2) + a.shape[1:]), params["layers"])
        loss_fn = ref_pipeline_loss(rc, mesh, n_stages=2, n_microbatches=2)
        if not grad:
            return float(ref), float(jax.jit(loss_fn)(p2, batch)), None
        lp, grads = jax.jit(jax.value_and_grad(loss_fn))(p2, batch)
    return float(ref), float(lp), grads


def test_gloo_ranks_import_neither_jax_nor_repro(pipe):
    assert pipe["imports"] == [[]] * 4


def test_pipeline_loss_matches_reference(pipe):
    ref, lp, _ = _reference(CASES["bfloat16"])
    assert abs(ref - lp) < 1e-3
    for r in results(pipe, "pipeline_mesh"):
        assert abs(r[0]["loss"] - ref) < 1e-3
        assert abs(r[0]["loss"] - lp) < 1e-3


def test_pipeline_gradients_match_reference_grad(pipe):
    _, lp, grads = _reference(CASES["float32"], grad=True)
    want = jax.tree.leaves(grads)
    names = [k for k in sorted(grads)]
    assert names == ["embed", "final_norm", "layers"]
    res = results(pipe, "pipeline_mesh")
    assert sorted(r[1]["stage"] for r in res) == [0, 0, 1, 1]
    for r in res:
        got = r[1]
        np.testing.assert_allclose(got["loss"], lp, rtol=1e-5)
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            w = np.asarray(w, np.float32)
            if g.shape != w.shape:          # a layer leaf: this stage's block
                w = w[got["stage"]:got["stage"] + 1]
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))
        assert sum(float(np.abs(g).sum()) for g in got["grads"]) > 0


def test_stage_stacked_specs():
    cfg = reduce_config(ARCHS["llama3.2-3b"], n_layers=4)
    specs = stage_stacked_specs(cfg, 2)
    wq = specs["layers"]["mixer"]["wq"]
    assert wq.shape == (2, 2, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert wq.axes == ("pipe", None, "embed", "heads")
    assert all(s.axes[:2] == ("pipe", None)
               for s in tree_leaves(specs["layers"]))
    with pytest.raises(ValueError, match="rank"):
        ref_stage_specs(ref_reduce(REF_ARCHS["llama3.2-3b"], n_layers=4), 2)
