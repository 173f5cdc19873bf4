"""Spawned gloo ranks for the port's multi-device tests.

`run(world, scenarios, tmp_path)` starts `world` processes with
`torch.multiprocessing.spawn`; they join one gloo process group through a
`file://` store in `tmp_path` (no network) and each runs the named
scenarios of this module in order, every rank the same ones, as SPMD
programs do.  Inputs go in and results come out as pickled dicts of numpy
arrays and plain values: the reference's numbers are computed in the
pytest process, which has the JAX host devices; the children import
neither `jax` nor `repro` (each checks so before it writes its results).
A scenario that raises records its traceback, which the test reports.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

TIMEOUT_S = 300          # a spawn's whole run; a collective's own limit
COLLECTIVE_S = 120       # is shorter, so a mismatched one raises first


def run(world: int, scenarios: list, tmp_path, inputs=None) -> dict:
    """{scenario name: [rank 0's result, rank 1's, ...]}."""
    import torch.multiprocessing as mp
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump({"scenarios": scenarios, "inputs": inputs or {}}, f)
    ctx = mp.start_processes(_child, args=(world, d), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks ran past {TIMEOUT_S} s")
    out = {}
    for r in range(world):
        with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        for name, value in res.items():
            out.setdefault(name, []).append(value)
    return out


def results(out: dict, name: str) -> list:
    """Every rank's result of scenario `name`, failing with the first
    rank's traceback if one raised."""
    for r, value in enumerate(out[name]):
        if isinstance(value, dict) and "__error__" in value:
            raise AssertionError(f"rank {r} of {name!r}:\n"
                                 f"{value['__error__']}")
    return out[name]


def _child(rank: int, world: int, d: str):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", init_method="file://" +
                            os.path.join(d, "store"), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    res = {}
    for name in spec["scenarios"]:
        try:
            res[name] = SCENARIOS[name](rank, world, spec["inputs"])
        except Exception:
            res[name] = {"__error__": traceback.format_exc()}
        dist.barrier()
    res["imports"] = sorted(m for m in ("jax", "jaxlib", "repro")
                            if m in sys.modules)
    dist.destroy_process_group()
    with open(os.path.join(d, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _np(t):
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _tensor(a, dtype=None):
    import torch
    t = torch.as_tensor(a)
    return t if dtype is None else t.to(dtype)


def _mesh(shape, axes):
    from repro_torch.sharding.rules import Mesh
    return Mesh(shape, axes, device_type="cpu")


def to_wire(tree):
    """A numpy tree (the reference's arrays) with bfloat16 leaves as their
    16-bit patterns, so the children need no `ml_dtypes` to unpickle."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: to_wire(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return {"__bf16__": a.view(np.uint16)}
    return a


def from_wire(tree):
    import torch
    if isinstance(tree, dict) and "__bf16__" in tree:
        return torch.from_numpy(tree["__bf16__"].copy()).view(torch.bfloat16)
    if isinstance(tree, dict):
        return {k: from_wire(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _params(inputs, key="params"):
    return from_wire(inputs[key])


def _cfg(inputs):
    """The reduced config of `inputs["cfg"]`: (arch, `reduce_config`
    keywords, dtype name[, fields to replace])."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, reduce_config
    name, kw, dtype, *over = inputs["cfg"]
    cfg = reduce_config(ARCHS[name], **kw)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return dataclasses.replace(cfg, **over[0]) if over else cfg


# ---------------------------------------------------------------------------
# sharding and meshes
# ---------------------------------------------------------------------------

@scenario
def mesh_groups(rank, world, inputs):
    """Each axis set's group: its size, this rank's index, and an
    all-gather of the ranks along it."""
    import torch

    from repro_torch.sharding.rules import all_gather
    mesh = _mesh(inputs["mesh_shape"], inputs["mesh_axes"])
    out = {"coords": mesh.coords, "dm": str(mesh.device_mesh)}
    for axes in (("data",), ("model",), ("data", "model")):
        out[axes] = (mesh.size(axes), mesh.index(axes),
                     all_gather(torch.tensor([rank]), mesh, axes).tolist())
    return out


@scenario
def shard_gather_roundtrip(rank, world, inputs):
    """A seeded whole tree cut by `tree_shardings`, put back by
    `gather_tree`; the blocks' shapes and placements."""
    from repro_torch.models.module import init_from_specs, tree_leaves
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import gather_tree, shard_tree
    mesh = _mesh(inputs["mesh_shape"], inputs["mesh_axes"])
    cfg = _cfg(inputs)
    from repro_torch.models.zoo import build_param_specs
    whole = init_from_specs(build_param_specs(cfg), 0, device="cpu")
    sh = param_shardings(cfg, mesh)
    local = shard_tree(whole, sh)
    back = gather_tree(local, sh)
    import torch
    return {"equal": all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(whole), tree_leaves(back))),
            "shapes": [tuple(x.shape) for x in tree_leaves(local)],
            "placements": [str(s.placements) for s in tree_leaves(sh)][:6]}


@scenario
def collective_grads(rank, world, inputs):
    """Gradients through each collective on a (2, 2) (data, model) mesh
    against the same function of whole tensors on one process:
    {name: (this rank's gradient, the one-process gradient's part)}."""
    import torch

    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import P, NamedSharding
    mesh = _mesh((2, 2), ("data", "model"))
    dp, d, m = ("data",), mesh.index("data"), mesh.index("model")
    g = torch.Generator().manual_seed(0)
    W = torch.randn(8, 6, generator=g, dtype=torch.float64)
    X = torch.randn(4, 8, generator=g, dtype=torch.float64)
    c = torch.randn(2, 8, generator=g, dtype=torch.float64)
    out = {}
    # FSDP gather: W split (data, model); rows of X split over data
    sh = NamedSharding(mesh, P("data", "model"))
    w = sh.shard(W).requires_grad_()
    l_r = torch.sum((C.rows(X, mesh, dp) @ C.gather_param(w, sh, dp)) ** 2)
    loss = C.mean_over(l_r, mesh, dp)
    (gw,) = torch.autograd.grad(loss, [w])
    Wf = W.clone().requires_grad_()
    ref = sum(torch.sum((X[2 * i:2 * i + 2] @ Wf) ** 2) for i in (0, 1)) / 2
    (gref,) = torch.autograd.grad(ref, [Wf])
    out["gather_param"] = (gw.numpy(), sh.shard(gref).numpy())
    out["mean_over_value"] = (loss.detach().numpy(), ref.detach().numpy())
    # Megatron f / g: y = sum over model ranks of c_m * x
    x = X[0].clone().requires_grad_()
    y = C.reduce_from(C.copy_to(x, mesh, "model") * c[m], mesh, "model")
    (gx,) = torch.autograd.grad(torch.sum(y ** 2), [x])
    xf = X[0].clone().requires_grad_()
    (gxf,) = torch.autograd.grad(torch.sum(((c[0] + c[1]) * xf) ** 2), [xf])
    out["copy_to_reduce_from"] = (gx.numpy(), gxf.numpy())
    # ring shift over "model": rank m receives rank m-1's a
    x = X[1].clone().requires_grad_()
    a = C.copy_to(x, mesh, "model") * (m + 1)
    b = C.shift(a, mesh, "model")
    loss = C.reduce_from(torch.sum(b * c[m]), mesh, "model")
    (gx,) = torch.autograd.grad(loss, [x])
    xf = X[1].clone().requires_grad_()
    ref = sum(torch.sum(xf * ((j - 1) % 2 + 1) * c[j]) for j in (0, 1))
    (gxf,) = torch.autograd.grad(ref, [xf])
    out["shift"] = (gx.numpy(), gxf.numpy())
    del d
    return out


@scenario
def restore_sharded(rank, world, inputs):
    """`checkpoint.restore(shardings=)` onto the mesh: each leaf this
    rank's block of the unsharded restore."""
    import torch

    from repro_torch.models.module import tree_leaves
    from repro_torch.models.transformer import param_shardings
    from repro_torch.train import checkpoint as ckpt
    mesh = _mesh(inputs["mesh_shape"], inputs["mesh_axes"])
    cfg = _cfg(inputs)
    like = _params(inputs)
    sh = param_shardings(cfg, mesh)
    got = ckpt.restore(inputs["ckpt_dir"], 1, like_tree=like, shardings=sh)
    whole = ckpt.restore(inputs["ckpt_dir"], 1, like_tree=like)
    return {"equal": all(torch.equal(g, s.shard(w)) for g, w, s in zip(
                tree_leaves(got), tree_leaves(whole), tree_leaves(sh))),
            "split": sum(g.numel() < w.numel() for g, w in zip(
                tree_leaves(got), tree_leaves(whole))),
            "n": len(tree_leaves(got))}


@scenario
def production_mesh_raises(rank, world, inputs):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    out = {}
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            out[multi_pod] = None
        except ValueError as e:
            out[multi_pod] = str(e)
    out["host"] = make_host_mesh(device_type="cpu").shape
    out["host_mp2"] = make_host_mesh(2, device_type="cpu").shape
    out["host_mp3"] = make_host_mesh(3, device_type="cpu").shape
    for argv, mod in ((["--production-mesh", "--device", "cpu"], "serve"),
                      (["--production-mesh", "--smoke", "--device", "cpu",
                        "--steps", "1"], "train")):
        import importlib
        main = importlib.import_module(f"repro_torch.launch.{mod}").main
        try:
            main(argv)
            out[mod] = None
        except ValueError as e:
            out[mod] = str(e)
    return out


# ---------------------------------------------------------------------------
# split-KV decode and the expert-parallel MoE
# ---------------------------------------------------------------------------

@scenario
def kv_sharded(rank, world, inputs):
    """`decode_attention_kv_sharded` over every rank on "data", each rank
    given its block of the cache, for each case of the inputs."""
    import torch

    from repro_torch.models.layers import decode_attention_kv_sharded
    mesh = _mesh((world,), ("data",))
    out = []
    for case in inputs["kv_cases"]:
        dtype = getattr(torch, case["dtype"])
        q = _tensor(case["q"]).to(dtype)
        k, v = (_tensor(case[n]).to(dtype) for n in ("k", "v"))
        Tl = k.shape[1] // world
        kl, vl = (t[:, rank * Tl:(rank + 1) * Tl] for t in (k, v))
        got = decode_attention_kv_sharded(q, kl, vl, case["cur_len"], mesh)
        out.append(_np(got))
    return out


@scenario
def moe_mesh(rank, world, inputs):
    """`moe_ffn(mesh=)` over whole inputs for each case whose (data,
    model) mesh covers the world."""
    import torch

    from repro_torch.models.layers import moe_ffn
    out = []
    for case in inputs["moe_cases"]:
        if case["mesh"][0] * case["mesh"][1] != world:
            continue
        mesh = _mesh(case["mesh"], ("data", "model"))
        params = _params(case)
        x = _tensor(case["x"]).to(getattr(torch, case["dtype"]))
        y, aux = moe_ffn(params, x, top_k=2, mesh=mesh, dp_axes=("data",),
                         capacity_factor=case["cf"])
        out.append({"id": case["id"], "out": _np(y), "aux": float(aux)})
    return out


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@scenario
def serve_mesh(rank, world, inputs):
    """`ServeEngine(mesh=)` on a (2, 2) mesh serving the seeded requests;
    the same on one device in the same process for its tokens; both again
    on the weights cast to float32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.module import tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = _cfg({"cfg": inputs["serve_cfg"]})
    params = _params(inputs, "serve_params")
    mesh = _mesh((2, 2), ("data", "model"))
    out = {}
    for suffix, c, p in (("", cfg, params), ("_f32", dataclasses.replace(
            cfg, dtype=torch.float32), tree_map(lambda x: x.float(),
                                                params))):
        for name, m in (("mesh", mesh), ("plain", None)):
            engine = ServeEngine(c, p, mesh=m, batch_slots=2, max_len=48,
                                 prompt_len=16, device="cpu")
            reqs = [Request(prompt=np.asarray(q), max_new_tokens=4)
                    for q in inputs["prompts"]]
            engine.serve(reqs)
            out[name + suffix] = [(r.done, list(r.out_tokens))
                                  for r in reqs]
            out[name + suffix + "_cache"] = tuple(
                engine.caches["layers"]["k"].shape)
    return out


@scenario
def decode_kv_mesh(rank, world, inputs):
    """`zoo.prefill` + `decode_step(kv_seq_shard=True)` on a (world, 1)
    host mesh against the one-device steps, on whole float32 weights."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import local_specs, shard_tree
    cfg = _cfg(inputs)
    params = _params(inputs)
    mesh = make_host_mesh(device_type="cpu")
    B, T = 4, 16
    prompt = torch.as_tensor(inputs["prompt"])
    out = {}
    for name, m, kv in (("kv", mesh, True), ("rows", mesh, False),
                        ("plain", None, False)):
        cspecs = zoo.build_cache_specs(cfg, B, T)
        p = params
        if m is not None:
            cspecs = local_specs(cspecs, zoo.cache_shardings(cfg, B, T, m,
                                                             kv))
            p = shard_tree(params, param_shardings(cfg, m))
        caches = init_from_specs(cspecs, 0, device="cpu")
        logits, caches = zoo.prefill(cfg, p, {"tokens": prompt}, caches,
                                     mesh=m, kv_seq_shard=kv)
        steps = [_np(logits)]
        for t in range(3):
            tok = torch.as_tensor(inputs["tokens"][t])[:, None]
            logits, caches = zoo.decode_step(cfg, p, tok, caches, 8 + t,
                                             mesh=m, kv_seq_shard=kv)
            steps.append(_np(logits))
        out[name] = steps
        out[name + "_cache"] = tuple(caches["layers"]["k"].shape)
    return out


@scenario
def families_mesh(rank, world, inputs):
    """Every other decoder family and whisper at a tiny float32 size:
    `zoo.prefill` and two `decode_step`s on the (world, 1) host mesh
    against the one-device steps (the same seeded weights), and for the
    MoE `zoo.train_loss` and its gradients on a (1, world) mesh (the
    experts' d_ff split over "model") against one device."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.models.module import (init_from_specs, tree_leaves,
                                           tree_unflatten)
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import (gather_tree, local_specs,
                                            shard_tree)
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    for arch in inputs["families"]:
        cfg = dataclasses.replace(
            reduce_config(ARCHS[arch], n_layers=2, d_model=64, d_ff=128,
                          vocab=128), dtype=torch.float32)
        if cfg.ffn == "moe":
            # a capacity no expert can overflow: with the rows split over
            # "data" each rank's capacity comes from its own tokens, so
            # where it binds other tokens drop than on one device (the
            # reference's semantics, held in test_moe_ffn_on_a_*_mesh)
            cfg = dataclasses.replace(cfg, moe=dict(
                cfg.moe, capacity_factor=float(cfg.moe["n_routed"])))
        params = init_from_specs(zoo.build_param_specs(cfg), 0,
                                 device="cpu")
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(1, cfg.vocab, (4, 8), generator=g)}
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.randn(4, cfg.enc["enc_len"],
                                              cfg.d_model, generator=g)
        steps = []
        for m in (None, mesh):
            cspecs = zoo.build_cache_specs(cfg, 4, 16)
            p = params
            if m is not None:
                cspecs = local_specs(cspecs, zoo.cache_shardings(cfg, 4, 16,
                                                                 m))
                p = shard_tree(params, param_shardings(cfg, m))
            caches = init_from_specs(cspecs, 0, device="cpu")
            logits, caches = zoo.prefill(cfg, p, batch, caches, mesh=m)
            got = [_np(logits)]
            enc = None
            if cfg.family == "encdec":
                from repro_torch.models import encdec
                enc = encdec.encode(cfg, p, batch["enc_embeds"], mesh=m)
            for t in range(2):
                tok = torch.as_tensor(inputs["tokens"][t] % cfg.vocab)
                logits, caches = zoo.decode_step(cfg, p, tok[:, None], caches,
                                                 8 + t, mesh=m, enc_out=enc)
                got.append(_np(logits))
            steps.append(got)
        out[arch] = steps
    # the MoE's gradients with the experts' d_ff split over "model"
    from repro_torch.sharding.rules import Mesh
    tp = Mesh((1, world), ("data", "model"), device_type="cpu")
    cfg = dataclasses.replace(
        reduce_config(ARCHS["deepseek-moe-16b"], n_layers=2, d_model=64,
                      d_ff=128, vocab=128), dtype=torch.float32)
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab, (4, 8), generator=g)
    batch = {"tokens": toks, "labels": toks.roll(1, 1)}
    res = []
    for m in (None, tp):
        sh = None if m is None else param_shardings(cfg, m)
        p = params if m is None else shard_tree(params, sh)
        leaves = [x.detach().clone().requires_grad_() for x in
                  tree_leaves(p)]
        loss = zoo.train_loss(cfg, tree_unflatten(p, leaves), batch, mesh=m,
                              remat=False)
        grads = tree_unflatten(p, list(torch.autograd.grad(loss, leaves)))
        if m is not None:
            grads = gather_tree(grads, sh)
        res.append((float(loss.detach()),
                    [_np(x) for x in tree_leaves(grads)]))
    out["moe_tp_grads"] = res
    return out


@scenario
def train_step_mesh(rank, world, inputs):
    """One `make_train_step(cfg, mesh, ...)` step on the (world, 1) host
    mesh from the reference's weights: the loss, the grad norm and this
    rank's blocks of the new parameters, put back whole."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import gather_tree, shard_tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    cfg = _cfg(inputs)
    mesh = make_host_mesh(device_type="cpu")
    sh = param_shardings(cfg, mesh)
    out = {}
    for name, kw in inputs["step_cfgs"].items():
        params = shard_tree(_params(inputs), sh)
        scfg = TrainStepConfig(opt=AdamWConfig(**inputs["opt"]), **kw)
        state = init_train_state(cfg, params, scfg)
        step = make_train_step(cfg, mesh, scfg)
        metrics = []
        for b in inputs["batches"]:
            batch = {k: torch.as_tensor(v) for k, v in b.items()}
            params, state, m = step(params, state, batch)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                     "lr")})
        whole = gather_tree(params, sh)
        from repro_torch.models.module import tree_leaves
        out[name] = {"metrics": metrics, "step": int(state["step"]),
                     "params": [_np(p) for p in tree_leaves(whole)],
                     "local": sum(p.numel() for p in tree_leaves(params))}
    return out


@scenario
def launch_train_mesh(rank, world, inputs):
    """`launch.train.main` for two smoke steps on the host mesh of every
    rank (with a checkpoint), its parameters put back whole."""
    import contextlib
    import io

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import main
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import gather_tree
    argv = inputs["train_argv"] + ["--ckpt-dir", inputs["ckpt_dir"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params = main(argv)
    mesh = make_host_mesh(device_type="cpu")
    cfg = _cfg(inputs)
    whole = gather_tree(params, param_shardings(cfg, mesh))
    return {"log": buf.getvalue(),
            "params": [_np(p) for p in tree_leaves(whole)]}


@scenario
def pipeline_mesh(rank, world, inputs):
    """The GPipe loss on a (pipe 2, data 2) mesh and its gradients, for
    each case: this rank's stage block of the layers' gradients and the
    whole leaves' gradients."""
    import torch

    from repro_torch.models.module import (tree_leaves, tree_map,
                                           tree_unflatten)
    from repro_torch.train.pipeline import make_pipeline_loss
    mesh = _mesh((2, 2), ("pipe", "data"))
    stage = mesh.index("pipe")
    out = []
    for case in inputs["pipe_cases"]:
        cfg = _cfg(case)
        params = _params(case)
        params["layers"] = tree_map(
            lambda a: a.reshape((2, -1) + a.shape[1:])[stage:stage + 1]
            .clone(), params["layers"])
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        loss_fn = make_pipeline_loss(cfg, mesh, n_stages=2,
                                     n_microbatches=2)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        out.append({"loss": float(loss.detach()), "stage": stage,
                    "grads": [_np(g) for g in grads]})
    return out


# ---------------------------------------------------------------------------
# tensor-parallel dense layers
# ---------------------------------------------------------------------------

def _tp_setup(case, world):
    """(cfg, mesh, this rank's parameter blocks, their shardings, batch)
    of a tensor-parallel case, or None when its mesh is not this world."""
    import torch

    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import shard_tree
    if case["mesh"][0] * case["mesh"][1] != world:
        return None
    cfg = _cfg(case)
    mesh = _mesh(case["mesh"], ("data", "model"))
    sh = param_shardings(cfg, mesh)
    batch = {k: _tensor(v, cfg.dtype if k == "enc_embeds" else None)
             for k, v in case["batch"].items()}
    return cfg, mesh, shard_tree(_params(case), sh), sh, batch


def _tp_split(cfg, mesh, sh) -> dict:
    """{stacked group: its tensor-parallel blocks}, zamba2's shared
    block's, and "vocab"."""
    from repro_torch.models import transformer as tfm
    out = {g: sorted(tfm.split_blocks(cfg, tfm.layer_shardings(sh[g])))
           for g in ("layers", "dense_layers", "enc_layers", "dec_layers")
           if g in sh}
    if "shared_attn" in sh:
        out["shared_attn"] = sorted(tfm.split_blocks(cfg, sh["shared_attn"]))
    out["vocab"] = tfm.vocab_tp(cfg, mesh) is not None
    return out


def _local_state(cfg, mesh, sh, caches):
    """(first head, this rank's heads of the recurrent state (L, B, H,
    ...)) of a Mamba2 or RWKV6 cache, or None: the heads a rank of a
    split mixer reads and writes (every head where the mixer is
    gathered)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.collectives import rows
    if cfg.mixer not in ("mamba2", "rwkv6"):
        return None
    state = caches["layers"]["state"]
    if "mixer" not in tfm.split_blocks(cfg, tfm.layer_shardings(
            sh["layers"])):
        return 0, _np(state)
    local = rows(state, mesh, "model", 2)
    return mesh.index("model") * local.shape[2], _np(local)


@scenario
def tp_serve(rank, world, inputs):
    """`zoo.prefill` and `decode_step`s (the case's tokens) on each case's
    (data, model) mesh that covers the world, the parameters and caches
    this rank's blocks, split-KV where the case asks: every step's
    logits, the tensor-parallel blocks, and the cache block's shape."""
    from repro_torch.models import encdec, zoo
    from repro_torch.models.module import init_from_specs
    from repro_torch.sharding.rules import local_specs
    out = []
    for case in inputs["tp_serve"]:
        setup = _tp_setup(case, world)
        if setup is None:
            continue
        cfg, mesh, p, sh, batch = setup
        B, S = batch["tokens"].shape
        T, kv = case["max_len"], case.get("kv", False)
        caches = init_from_specs(local_specs(
            zoo.build_cache_specs(cfg, B, T),
            zoo.cache_shardings(cfg, B, T, mesh, kv)), 0, device="cpu")
        enc = None
        if cfg.family == "encdec":
            enc = encdec.encode(cfg, p, batch["enc_embeds"], mesh=mesh)
        steps = []
        for wave in [batch] + [{"tokens": _tensor(t)}
                               for t in case.get("waves", [])]:
            # a later wave starts from the state the last one left, as
            # the reference's engine does
            logits, caches = zoo.prefill(cfg, p, wave, caches, mesh=mesh,
                                         kv_seq_shard=kv)
            steps.append(_np(logits))
            for t, tok in enumerate(case["steps"]):
                logits, caches = zoo.decode_step(
                    cfg, p, _tensor(tok)[:, None], caches, S + t,
                    mesh=mesh, kv_seq_shard=kv, enc_out=enc)
                steps.append(_np(logits))
        k = caches["self_k"] if cfg.family == "encdec" else \
            next(iter(caches["layers"].values()))
        out.append({"id": case["id"], "logits": steps,
                    "split": _tp_split(cfg, mesh, sh),
                    "cache": tuple(k.shape),
                    "state": _local_state(cfg, mesh, sh, caches)})
    return out


@scenario
def tp_train(rank, world, inputs):
    """`zoo.train_loss` (remat on) and its gradients on each case's mesh
    that covers the world: the loss, every gradient leaf put back whole
    from the ranks' blocks, and this rank's block shapes.  A case's
    `mutate` (block kind, "drop" or "add", leaf) takes the leaf out of
    that kind's `transformer.PART_LEAVES` or puts it in, for that case
    only: a gradient left unsummed over "model", or summed twice."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models import zoo
    from repro_torch.models.module import tree_leaves, tree_unflatten
    from repro_torch.sharding.rules import gather_tree
    out = []
    for case in inputs["tp_train"]:
        setup = _tp_setup(case, world)
        if setup is None:
            continue
        cfg, mesh, p, sh, batch = setup
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        parts = dict(tfm.PART_LEAVES)
        if case.get("mutate"):
            kind, how, leaf = case["mutate"]
            tfm.PART_LEAVES[kind] = (parts[kind] - {leaf} if how == "drop"
                                     else parts[kind] | {leaf})
        try:
            loss = zoo.train_loss(cfg, tree_unflatten(p, leaves), batch,
                                  mesh=mesh, remat=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            tfm.PART_LEAVES.update(parts)
        whole = gather_tree(tree_unflatten(p, list(grads)), sh)
        out.append({"id": case["id"], "loss": float(loss.detach()),
                    "grads": [_np(g) for g in tree_leaves(whole)],
                    "split": _tp_split(cfg, mesh, sh),
                    "local": [tuple(g.shape) for g in grads]})
    return out


@scenario
def tp_collectives(rank, world, inputs):
    """`gather_from` and `max_over` over "model" on a (1, world) mesh, and
    `embed_lookup` of a vocabulary split over it, with their gradients,
    against the same functions of whole tensors in one process:
    {name: (this rank's result, the one-process result's part)}."""
    import torch

    from repro_torch.models.transformer import embed_lookup
    from repro_torch.sharding import collectives as C
    mesh = _mesh((1, world), ("data", "model"))
    m = mesh.index("model")
    g = torch.Generator().manual_seed(0)
    X = torch.randn(3, 4 * world, generator=g, dtype=torch.float64)
    c = torch.randn(3, 4 * world, generator=g, dtype=torch.float64)
    out = {}
    # gather_from: each rank's columns back whole; backward keeps the slice
    x = C.rows(X, mesh, "model", 1).clone().requires_grad_()
    y = C.gather_from(x, mesh, "model", -1)
    (gx,) = torch.autograd.grad(torch.sum(y * y * c), [x])
    out["gather_from"] = ((y.detach().numpy(), gx.numpy()),
                          (X.numpy(), C.rows(2 * X * c, mesh, "model",
                                             1).numpy()))
    # max_over: the max of every rank's block, no gradient
    mx = C.max_over(x.amax(dim=-1), mesh, "model")
    out["max_over"] = ((mx.numpy(), mx.requires_grad),
                       (X.amax(dim=-1).numpy(), False))
    # the vocab-parallel lookup and its table gradient
    table = C.rows(X.t().contiguous(), mesh, "model").clone()
    table.requires_grad_()
    ids = torch.tensor([[0, 4 * world - 1, 5], [2, 2, 4 * world - 2]])
    e = embed_lookup(table, ids, mesh)
    (gt,) = torch.autograd.grad(torch.sum(e * e), [table])
    whole = X.t().contiguous().requires_grad_()
    (gw,) = torch.autograd.grad(torch.sum(whole[ids] ** 2), [whole])
    out["embed_lookup"] = ((e.detach().numpy(), gt.numpy()),
                           (whole[ids].detach().numpy(),
                            C.rows(gw, mesh, "model").numpy()))
    del m
    return out


# ---------------------------------------------------------------------------
# DeepSeek-V2 at its published mechanisms (low-rank queries, YaRN,
# group-limited routing), tensor-parallel
# ---------------------------------------------------------------------------

def _dsv2(inputs):
    """(the ArchConfig of `inputs["cfg"]`, a dict of its fields with the
    dtype's name; the (1, world) mesh's whole float32 parameters)."""
    import torch

    from repro_torch.configs.base import ArchConfig
    fields = dict(inputs["cfg"], dtype=getattr(torch, inputs["cfg"]["dtype"]))
    return ArchConfig(**fields), _params(inputs)


@scenario
def dsv2_serve(rank, world, inputs):
    """`ServeEngine(mesh=)` on a (1, world) mesh over the whole parameters
    it cuts itself, serving the prompts: every step's logits (prefill,
    then each decode step through the cache), the served tokens and the
    tensor-parallel blocks."""
    import numpy as np

    from repro_torch.models import zoo
    from repro_torch.models.transformer import param_shardings
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = _dsv2(inputs["dsv2"])
    mesh = _mesh((1, world), ("data", "model"))
    engine = ServeEngine(cfg, params, mesh=mesh, batch_slots=len(
        inputs["dsv2"]["prompts"]), max_len=inputs["dsv2"]["max_len"],
        prompt_len=inputs["dsv2"]["prompt_len"], device="cpu")
    caught, saved = [], (zoo.prefill, zoo.decode_step)

    def keep(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            caught.append(_np(out[0]))
            return out
        return call
    zoo.prefill, zoo.decode_step = keep(saved[0]), keep(saved[1])
    try:
        reqs = [Request(prompt=np.asarray(p), max_new_tokens=inputs["dsv2"][
            "new_tokens"]) for p in inputs["dsv2"]["prompts"]]
        engine.serve(reqs)
    finally:
        zoo.prefill, zoo.decode_step = saved
    return {"logits": caught, "out": [list(r.out_tokens) for r in reqs],
            "split": _tp_split(cfg, mesh, param_shardings(cfg, mesh))}


@scenario
def dsv2_grads(rank, world, inputs):
    """`zoo.train_loss` (remat on) on a (1, world) mesh: the loss and the
    whole gradients of the low-rank query leaves, with `PART_LEAVES` as it
    is and with `wq_a` and `q_norm` taken out of the "mla_lora" kind."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models import zoo
    from repro_torch.models.module import tree_leaves, tree_unflatten
    from repro_torch.sharding.rules import gather_tree, shard_tree
    cfg, whole = _dsv2(inputs["dsv2"])
    mesh = _mesh((1, world), ("data", "model"))
    sh = tfm.param_shardings(cfg, mesh)
    p = shard_tree(whole, sh)
    batch = {k: _tensor(v) for k, v in inputs["dsv2"]["batch"].items()}
    names = inputs["dsv2"]["grad_leaves"]
    out = {}
    parts = dict(tfm.PART_LEAVES)
    for case, drop in (("summed", frozenset()),
                       ("unsummed", frozenset({"wq_a", "q_norm"}))):
        tfm.PART_LEAVES["mla_lora"] = parts["mla_lora"] - drop
        try:
            leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
            loss = zoo.train_loss(cfg, tree_unflatten(p, leaves), batch,
                                  mesh=mesh, remat=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            tfm.PART_LEAVES.update(parts)
        g = gather_tree(tree_unflatten(p, list(grads)), sh)
        out[case] = {"loss": float(loss.detach()),
                     "grads": {n: _np(_at(g, n)) for n in names}}
    return out


def _at(tree, dotted: str):
    for k in dotted.split("."):
        tree = tree[k]
    return tree
