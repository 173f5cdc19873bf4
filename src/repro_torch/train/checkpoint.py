"""Checkpoints in the JAX package's on-disk format (`repro/train/
checkpoint.py`), so that either package restores what the other saved.

Layout: one directory per step:
    step_00000100/
      manifest.json         # step; per leaf: path, key, file, shape, dtype
      group_00000.npz.zst   # zstd-compressed npz of up to 64 MiB of leaves
A tree is a nested dict of tensors (or numpy values); leaves are visited
in sorted-key order (`jax.tree.flatten`'s order for dicts) and their
paths print as `jax.tree.flatten_with_path`'s
(`"['params']/['embed']"`); bfloat16 is stored as a uint16 view with
`"dtype": "bfloat16"` in the manifest.  Writes are atomic (a `.tmp`
directory, then a rename) and optionally asynchronous (a background
thread).  An asynchronous save copies every leaf to the host before it
returns, as the reference builds its host list in the caller: the
port's optimizer updates in place, so the caller may overwrite the
tensors as soon as `save` returns.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.module import tree_unflatten

try:
    import zstandard
except ModuleNotFoundError:  # optional dep: fail at use, not import
    zstandard = None

_FLUSH_GROUP_BYTES = 64 << 20

def _require_zstandard():
    if zstandard is None:
        raise ModuleNotFoundError(
            "checkpoint save/restore needs the optional 'zstandard' package "
            "(pip install stream-repro[checkpoint])")


def _flatten_with_paths(tree, prefix=()) -> list:
    """(path string, leaf) pairs of a nested dict in sorted-key order,
    each path as `jax.tree.flatten_with_path` prints it: keys as `['key']`
    joined by `/`."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                _flatten_with_paths(tree[k], prefix + (f"[{k!r}]",))]
    return [("/".join(prefix), tree)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of `leaf` on the host as numpy (bf16 as its uint16 view) and
    the manifest's dtype name (numpy's)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype == np.uint16:
            return torch.from_numpy(arr.view(np.int16).copy()) \
                .view(torch.bfloat16)
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True) -> str:
    """Serialize a tree of tensors; returns the checkpoint path."""
    _require_zstandard()
    host = [(path,) + _to_host(leaf)
            for path, leaf in _flatten_with_paths(tree)]

    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    def _write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        cctx = zstandard.ZstdCompressor(level=3)
        group, group_bytes, gid = {}, 0, 0

        def flush():
            nonlocal group, group_bytes, gid
            if not group:
                return
            fname = f"group_{gid:05d}.npz.zst"
            buf = io.BytesIO()
            np.savez(buf, **group)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(cctx.compress(buf.getvalue()))
            gid += 1
            group, group_bytes = {}, 0

        for i, (path, arr, dtype) in enumerate(host):
            key = f"a{i:06d}"
            manifest["leaves"].append({
                "path": path, "key": key, "file": f"group_{gid:05d}.npz.zst",
                "shape": list(arr.shape), "dtype": dtype})
            group[key] = arr
            group_bytes += arr.nbytes
            if group_bytes >= _FLUSH_GROUP_BYTES:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish

    if blocking:
        _write()
    else:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _ASYNC_THREADS.append(t)
    return final


_ASYNC_THREADS: list[threading.Thread] = []


def wait_for_async():
    for t in _ASYNC_THREADS:
        t.join()
    _ASYNC_THREADS.clear()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree=None, shardings=None, *,
            device=None):
    """Load a checkpoint; optionally re-shard onto `shardings` (any mesh).

    Without `like_tree`: {path: CPU tensor}.  With it: a tree shaped as
    `like_tree`, each leaf in its like leaf's dtype, on `device` (default:
    where the like leaf lies).  `shardings`: a tree shaped as `like_tree`
    of `sharding.rules.NamedSharding` (or None leaves): each leaf comes
    back as this rank's block of the whole array the manifest holds, so a
    checkpoint saved on one mesh restores onto any other."""
    _require_zstandard()
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dctx = zstandard.ZstdDecompressor()
    cache: dict[str, dict] = {}
    leaves_by_path = {}
    for meta in manifest["leaves"]:
        if meta["file"] not in cache:
            with open(os.path.join(path, meta["file"]), "rb") as f:
                data = dctx.decompress(f.read())
            cache[meta["file"]] = dict(np.load(io.BytesIO(data)))
        arr = cache[meta["file"]][meta["key"]]
        leaves_by_path[meta["path"]] = _from_host(arr, meta["dtype"])

    if like_tree is None:
        return leaves_by_path

    pairs = _flatten_with_paths(like_tree)
    flat_sh = [None] * len(pairs) if shardings is None else \
        [sh for _, sh in _flatten_with_paths(shardings)]
    out = []
    for (pathkey, like), sh in zip(pairs, flat_sh):
        t = leaves_by_path[pathkey]
        if sh is not None:
            t = sh.shard(t)
        if isinstance(like, torch.Tensor):
            t = t.to(device=like.device if device is None else device,
                     dtype=like.dtype)
        elif device is not None:
            t = t.to(device)
        out.append(t)
    return tree_unflatten(like_tree, out)
