"""Weights made on the device from a seed, in the type they are used in.

One normal draw a dtype fills a flat buffer in a single call; each leaf of
the layout is a view of it, aligned to 64 elements, scaled or transformed
in place as its `init` says.  The same layout, seed and device give the
same tensors, so the reference can make them again once the program has
been freed.

A cell's model is its configuration's: `model_weights` draws from the
configuration file's `weights_seed`, so every run of a cell serves or
trains the same model and the run's `--seed` draws only its traffic (a
deployment holds one model; weights drawn from the run's seed changed the
MoE routing, and with it the work, from seed to seed).
"""
from __future__ import annotations

import math

import torch

ALIGN = 64
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(tree, prefix=()):
    """(path, leaf spec) pairs of a layout, in sorted-key order."""
    if "shape" in tree:
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from leaves(tree[k], prefix + (k,))


def tensors(tree):
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensors(tree[k])
    else:
        yield tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` for one stream of the run (`salt` tells the
    weights from the token batches); any whole seed below 2**62 works."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    return g


def make_weights(layout: dict, seed: int, device) -> dict:
    """The parameter tree of `layout` on `device`, from `seed`."""
    specs = list(leaves(layout))
    sizes: dict[str, int] = {}
    offsets = []
    for _, s in specs:
        n = math.prod(s["shape"])
        off = sizes.get(s["dtype"], 0)
        offsets.append(off)
        sizes[s["dtype"]] = off + -(-n // ALIGN) * ALIGN
    gen = generator(seed, 1, device)
    flat = {dt: torch.randn(n, generator=gen, dtype=DTYPES[dt],
                            device=device)
            for dt, n in sorted(sizes.items())}
    out: dict = {}
    for (path, s), off in zip(specs, offsets):
        n = math.prod(s["shape"])
        t = flat[s["dtype"]][off:off + n].view(s["shape"])
        init = s["init"]
        if init == "normal":
            t.mul_(s["scale"])
        elif init == "ones":
            t.fill_(1.0)
        elif init == "zeros":
            t.zero_()
        elif init == "uniform":         # in (0, 1)
            t.sigmoid_()
        else:
            raise ValueError(f"unknown init {init!r} at {'.'.join(path)}")
        _put(out, path, t)
    return out


def model_weights(config: dict, device) -> dict:
    """The configuration's model, from its `weights_seed`, in the layout
    of the plain reference it names."""
    from harness import spec
    layout = spec.reference(config).param_layout(config)
    return make_weights(layout, config["weights_seed"], device)


def layout_bytes(layout: dict) -> int:
    return sum(math.prod(s["shape"]) * DTYPES[s["dtype"]].itemsize
               for _, s in leaves(layout))
