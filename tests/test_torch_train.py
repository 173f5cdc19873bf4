"""The port's training objective (`repro_torch.models.zoo.train_loss`,
`transformer.chunked_ce_loss`, the remat policies and the MoE aux loss)
against the JAX package's, on weights initialised in the reference and
carried across with `repro_torch.interop`.

All ten configs, reduced (`reduce_config`) and in float32: the loss to
1e-5 relative (the same float32 arithmetic, sums in another order), every
gradient leaf to 1e-4 relative to the leaf's largest magnitude (a backward
pass sums more terms, in another order, than the forward).  The remat
policies recompute the same float32 ops, so they agree to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import normal

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import transformer as ref_tfm
from repro.models import zoo as ref_zoo
from repro.models.module import init_from_specs as ref_init

from repro_torch.interop import arch_config_from_dict, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models import zoo
from repro_torch.models.module import (init_from_specs, tree_leaves,
                                       tree_unflatten)

B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
REMAT_RTOL = 1e-6
MESH = compat_make_mesh((1, 1), ("data", "model"))


def _configs(name):
    rc = dataclasses.replace(ref_reduce(REF_ARCHS[name]), dtype=jnp.float32)
    return rc, arch_config_from_dict(dataclasses.asdict(rc))


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = normal((B, cfg.enc["enc_len"], cfg.d_model),
                                     seed)
    if cfg.rope == "mrope":      # three different position streams
        batch["mrope_positions"] = np.stack(
            [np.broadcast_to(np.arange(S), (B, S)),
             rng.integers(0, S, (B, S)), rng.integers(0, S, (B, S))]
        ).astype(np.int32)
    return batch


def _grads(cfg, params, batch, remat):
    """(loss, grads) of the port's train_loss through autograd."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = zoo.train_loss(cfg, tree_unflatten(params, leaves), batch,
                          remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


def _params(cfg):
    return init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0))


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_train_loss_and_grads_match_the_reference(name):
    rc, pc = _configs(name)
    rparams = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(0))
    batch = _batch(rc)
    with compat_set_mesh(MESH):
        loss_fn = jax.jit(jax.value_and_grad(
            lambda p, b: ref_zoo.train_loss(rc, p, b, mesh=MESH,
                                            remat=False)))
        want, want_g = loss_fn(rparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    loss, grads = _grads(pc, params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, False)
    assert np.isfinite(loss) and 3.0 < loss < 12.0
    np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL)
    want_leaves = jax.tree.leaves(want_g)
    assert len(grads) == len(want_leaves)
    for got, w in zip(grads, want_leaves):
        assert got.shape == w.shape
        _close(got, w, GRAD_RTOL)


@pytest.mark.parametrize("name", ["llama3.2-3b", "zamba2-2.7b",
                                  "deepseek-moe-16b", "whisper-large-v3"])
def test_remat_policies_agree(name):
    """False, True, "full", "dots" and "names" compute the same loss and
    gradients: the policies choose what the backward pass recomputes."""
    _, pc = _configs(name)
    params = _params(pc)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pc).items()}
    base_loss, base = _grads(pc, params, batch, False)
    for remat in (True, "full", "dots", "names"):
        loss, grads = _grads(pc, params, batch, remat)
        np.testing.assert_allclose(loss, base_loss, rtol=REMAT_RTOL)
        for got, want in zip(grads, base):
            _close(got, want, REMAT_RTOL)


def _ops_in_backward(cfg, params, batch, remat) -> dict:
    """How often each op runs in the backward pass (recomputation
    included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = zoo.train_loss(cfg, tree_unflatten(params, leaves), batch,
                          remat=remat)
    with Count() as count:
        loss.backward()
    return count.n


def test_remat_policies_recompute_what_they_do_not_save():
    """"full" recomputes every layer op in the backward pass, "dots" all
    but the products without batch dimensions (aten.mm), "names" all but
    the tagged block outputs; without remat nothing is recomputed."""
    _, pc = _configs("llama3.2-3b")
    params = _params(pc)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pc).items()}
    mm, tag = torch.ops.aten.mm.default, \
        torch.ops.repro_torch.checkpoint_name.default
    n = {r: _ops_in_backward(pc, params, batch, r)
         for r in (False, "full", "dots", "names")}
    bmm = torch.ops.aten.bmm.default
    # the layers' weight GEMMs run again under "full", not under "dots";
    # the attention einsums (batched products) run again under both
    assert n["full"][mm] > n["dots"][mm] == n[False][mm]
    assert n["full"][bmm] == n["dots"][bmm] > n[False][bmm]
    assert n["names"].get(mm, 0) == n["full"].get(mm, 0)
    assert n["names"].get(tag, 0) == 0 and tag not in n["full"]
    exp = torch.ops.aten.exp.default
    assert n["full"][exp] == n["dots"][exp] == n["names"][exp] > \
        n[False].get(exp, 0)
    with pytest.raises(KeyError):
        tfm.remat_layer(lambda x: x, "everything")


@pytest.mark.parametrize("seq", [600, 1100])
def test_chunked_ce_loss_matches_the_reference(seq):
    """S not a multiple of 512: one block of 600, two blocks of 550."""
    Bc, D, V = 2, 16, 64
    x = normal((Bc, seq, D), 1)
    embed = normal((V, D), 2, 0.3)
    labels = np.random.default_rng(3).integers(0, V, (Bc, seq)).astype(
        np.int32)
    want, (gx, ge) = jax.value_and_grad(
        lambda a, e: ref_tfm.chunked_ce_loss(a, e, jnp.asarray(labels)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(embed))
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(embed).requires_grad_()
    got = tfm.chunked_ce_loss(xt, et, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    _close(xt.grad.numpy(), gx, GRAD_RTOL)
    _close(et.grad.numpy(), ge, GRAD_RTOL)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_moe_aux_loss_matches_the_reference(name):
    """`decoder_forward` sums the MoE layers' load-balance loss, as the
    reference's does, and `train_loss` adds 0.01 of it."""
    rc, pc = _configs(name)
    rparams = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(1))
    toks = _batch(rc)["tokens"]
    with compat_set_mesh(MESH):
        _, _, want = ref_tfm.decoder_forward(rc, rparams, jnp.asarray(toks),
                                             mesh=MESH)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    _, _, aux = tfm.decoder_forward(pc, params, torch.from_numpy(toks))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want), rtol=LOSS_RTOL)
    # a model without MoE layers gives a float32 zero
    _, lc = _configs("llama3.2-3b")
    _, _, zero = tfm.decoder_forward(lc, _params(lc),
                                     torch.from_numpy(toks % lc.vocab))
    assert zero.dtype == torch.float32 and float(zero) == 0.0
