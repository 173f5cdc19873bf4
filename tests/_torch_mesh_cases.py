"""Inputs and reference results of the multi-device tests
(`test_torch_{mesh,multidevice,tensor_parallel}.py`), computed in the
pytest process with the JAX package on its host devices; the gloo ranks
get only the numpy inputs (`_torch_mesh_worker`)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_inputs import TOL, normal
from _torch_mesh_worker import to_wire

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import layers as ref_layers
from repro.models import zoo as ref_zoo
from repro.models.module import init_from_specs as ref_init
from repro.sharding.rules import sharding_for as ref_sharding_for
from repro.sharding.rules import tree_shardings as ref_tree_shardings

from repro_torch.models import layers


def kv_cases(n: int) -> list:
    """q (2, 1, 4, 16) against a cache of T 32 (2 KV heads), in float32
    and bfloat16; a `cur_len` of 32, and one that leaves the shards past
    the first wholly masked at n >= 4."""
    short = 5 if n >= 4 else 9
    out = []
    for i, (dtype, cur_len) in enumerate([("float32", 32), ("float32", short),
                                          ("bfloat16", 32),
                                          ("bfloat16", short)]):
        out.append({"q": normal((2, 1, 4, 16), 10 * n + i),
                    "k": normal((2, 32, 2, 16), 10 * n + i + 100),
                    "v": normal((2, 32, 2, 16), 10 * n + i + 200),
                    "cur_len": cur_len, "dtype": dtype})
    return out


def kv_reference(case, n: int):
    """(the reference's split-KV decode on an (n,) "data" mesh, the port's
    one-device `decode_attention`), as float32 numpy."""
    jd = getattr(jnp, case["dtype"])
    q, k, v = (jnp.asarray(case[x]).astype(jd) for x in ("q", "k", "v"))
    mesh = compat_make_mesh((n,), ("data",))
    with compat_set_mesh(mesh):
        want = ref_layers.decode_attention_kv_sharded(
            q, k, v, jnp.int32(case["cur_len"]), mesh)
    td = getattr(torch, case["dtype"])
    plain = layers.decode_attention(
        *(torch.as_tensor(case[x]).to(td) for x in ("q", "k", "v")),
        case["cur_len"])
    return np.asarray(want, np.float32), plain.float().numpy()


def _moe_params(dtype: str):
    specs = ref_layers.moe_specs(32, 24, n_routed=8, n_shared=1,
                                 dtype=getattr(jnp, dtype))
    rp = ref_init(specs, jax.random.PRNGKey(0))
    # a wide router makes the top-k choice and its weights count
    return dict(rp, router=jnp.asarray(normal((32, 8), 1, 0.5)))


def moe_cases(meshes) -> list:
    """For each (data, model) mesh: float32 at capacity factor 1.25,
    bfloat16 at 0.5 (tokens drop, and which depends on the data split),
    and a batch of 3 that no data axis divides (dp = ())."""
    out = []
    for mesh in meshes:
        for dtype, cf, B in (("float32", 1.25, 4), ("bfloat16", 0.5, 4),
                             ("bfloat16", 1.25, 3)):
            rp = _moe_params(dtype)
            out.append({"id": f"{mesh}-{dtype}-{cf}-{B}", "mesh": mesh,
                        "dtype": dtype, "cf": cf,
                        "x": normal((B, 16, 32), 2),
                        "params": to_wire(jax.tree.map(np.asarray, rp))})
    return out


def check_moe(case, got: list):
    """Every rank's `moe_ffn(mesh=)` output and aux against the reference's
    on a mesh of the same shape; at capacity factor 0.5 with more than
    one data rank, also unlike the one-device result (the capacity comes
    from each rank's own tokens, as in the reference)."""
    rp = _moe_params(case["dtype"])
    jd = getattr(jnp, case["dtype"])
    mesh = compat_make_mesh(case["mesh"], ("data", "model"))
    fn = jax.jit(functools.partial(ref_layers.moe_ffn, top_k=2, mesh=mesh,
                                   dp_axes=("data",),
                                   capacity_factor=case["cf"]))
    with compat_set_mesh(mesh):
        want, want_aux = fn(rp, jnp.asarray(case["x"]).astype(jd))
    want = np.asarray(want, np.float32)
    for r in got:
        assert r["id"] == case["id"]
        np.testing.assert_allclose(r["out"], want, **TOL[case["dtype"]])
        np.testing.assert_allclose(r["aux"], float(want_aux), rtol=1e-6)
    if case["cf"] < 1 and case["mesh"][0] > 1:
        from repro_torch.interop import params_from_numpy
        one, _ = layers.moe_ffn(
            params_from_numpy(jax.tree.map(np.asarray, rp), "cpu"),
            torch.as_tensor(case["x"]).to(getattr(torch, case["dtype"])),
            top_k=2, capacity_factor=case["cf"])
        assert not np.allclose(one.float().numpy(), want,
                               **TOL[case["dtype"]])


# ---------------------------------------------------------------------------
# tensor-parallel dense layers: reduced configs on (data, model) meshes
# ---------------------------------------------------------------------------

TP_B, TP_S, TP_STEPS, TP_MAX_LEN = 4, 8, 4, 16
_BATCH_AXES = {"tokens": ("batch", None), "labels": ("batch", None),
               "enc_embeds": ("batch", None, None),
               "mrope_positions": (None, "batch", None)}


def ref_cfg(spec):
    """The reference's config of a case's `cfg` spec (arch, reduce_config
    keywords, dtype name[, fields to replace])."""
    name, kw, dtype, *over = spec
    rc = dataclasses.replace(ref_reduce(REF_ARCHS[name], **kw),
                             dtype=getattr(jnp, dtype))
    return dataclasses.replace(rc, **over[0]) if over else rc


def tp_case(case_id: str, spec, mesh, *, train=False, kv=False,
            seed=0, waves=1, mutate=None) -> dict:
    """A case's inputs: the reference's seeded weights, B x S tokens (and
    labels, whisper's frames, three distinct M-RoPE streams) from numpy,
    and TP_STEPS decode tokens; `waves` - 1 more prompts, each served
    after the last wave's steps from the caches it left; `mutate`: see
    `_torch_mesh_worker.tp_train`."""
    rc = ref_cfg(spec)
    params = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, rc.vocab, (TP_B, TP_S))}
    if train:
        batch["labels"] = rng.integers(0, rc.vocab, (TP_B, TP_S))
    if rc.family == "encdec":
        batch["enc_embeds"] = normal((TP_B, rc.enc["enc_len"], rc.d_model),
                                     seed + 1)
    if rc.rope == "mrope":
        t = np.arange(TP_S)
        batch["mrope_positions"] = np.stack(
            [np.broadcast_to(t, (TP_B, TP_S)),
             np.broadcast_to(t // 2, (TP_B, TP_S)),
             np.broadcast_to(t % 3, (TP_B, TP_S))])
    return {"id": case_id, "mesh": tuple(mesh), "cfg": spec,
            "params": to_wire(jax.tree.map(np.asarray, params)),
            "batch": batch, "max_len": TP_MAX_LEN, "kv": kv,
            "steps": rng.integers(1, rc.vocab, (TP_STEPS, TP_B)),
            "waves": [rng.integers(1, rc.vocab, (TP_B, TP_S))
                      for _ in range(waves - 1)],
            "mutate": mutate}


def _ref_placed(case):
    """(reference config, mesh, params placed by its `tree_shardings`,
    batch placed by the dry run's batch layouts)."""
    rc = ref_cfg(case["cfg"])
    mesh = compat_make_mesh(case["mesh"], ("data", "model"))
    pspecs = ref_zoo.build_param_specs(rc)
    params = jax.device_put(ref_init(pspecs, jax.random.PRNGKey(0)),
                            ref_tree_shardings(pspecs, mesh))
    batch = {}
    for k, v in case["batch"].items():
        v = jnp.asarray(v, rc.dtype if k == "enc_embeds" else jnp.int32)
        batch[k] = jax.device_put(v, ref_sharding_for(_BATCH_AXES[k],
                                                      v.shape, mesh))
    return rc, mesh, params, batch


def tp_serve_reference(case):
    """The reference's jitted `zoo.prefill` and `decode_step`s of a case on
    a JAX host mesh of its shape, wave after wave on the same caches:
    (every step's float32 logits, the recurrent state (L, B, H, ...) the
    last wave left, or None)."""
    rc, mesh, params, batch = _ref_placed(case)
    cspecs = ref_zoo.build_cache_specs(rc, TP_B, case["max_len"])
    caches = jax.device_put(ref_init(cspecs, jax.random.PRNGKey(0)),
                            ref_tree_shardings(cspecs, mesh))
    enc = None
    if rc.family == "encdec":
        enc = jnp.zeros((TP_B, rc.enc["enc_len"], rc.d_model), rc.dtype)
    waves = [batch] + [dict(batch, tokens=jax.device_put(
        jnp.asarray(t, jnp.int32), batch["tokens"].sharding))
        for t in case["waves"]]
    out = []
    with compat_set_mesh(mesh):
        prefill = jax.jit(functools.partial(ref_zoo.prefill, rc, mesh=mesh))
        step = jax.jit(lambda p, t, c, n, e: ref_zoo.decode_step(
            rc, p, t, c, n, mesh=mesh, enc_out=e))
        for wave in waves:
            logits, caches = prefill(params, wave, caches)
            out.append(np.asarray(logits, np.float32))
            for t, tok in enumerate(case["steps"]):
                logits, caches = step(params,
                                      jnp.asarray(tok, jnp.int32)[:, None],
                                      caches, jnp.int32(TP_S + t), enc)
                out.append(np.asarray(logits, np.float32))
    state = caches.get("layers", {}).get("state")
    return out, None if state is None else np.asarray(state, np.float32)


def tp_train_reference(case):
    """The reference's jitted `zoo.train_loss` (remat on) and its gradient
    on a JAX host mesh of the case's shape: (loss, [whole gradients])."""
    rc, mesh, params, batch = _ref_placed(case)
    with compat_set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_zoo.train_loss(rc, p, b, mesh=mesh,
                                            remat=True)))(params, batch)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]
