"""Weights made on the device from a seed, in the type they are used in.

One normal draw a dtype fills a flat buffer in a single call; each leaf of
the layout is a view of it, aligned to 64 elements, scaled or transformed
in place as its `init` says.  The same layout, seed and device give the
same tensors, so the reference can make them again once the program has
been freed.

A configuration with a `mesh` runs over several cards, and its whole
model may hold more than one card: there every piece is drawn from a
generator of its own, keyed by the seed and the leaf's path (`piece`).  A
piece is a leaf, or one layer of a leaf that the layout marks `stacked`
(its first axis the layer axis).  A rank draws each piece whole on its
card, keeps its block of it and frees the rest (`rank_blocks`), so it
never holds more than its blocks and one whole piece; the reference draws
any piece again on its own (`leaf` puts a whole leaf together).

A cell's model is its configuration's: `model_weights` draws from the
configuration file's `weights_seed`, so every run of a cell serves or
trains the same model and the run's `--seed` draws only its traffic (a
deployment holds one model; weights drawn from the run's seed changed the
MoE routing, and with it the work, from seed to seed).
"""
from __future__ import annotations

import hashlib
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
        _init(t, s, path)
        _put(out, path, t)
    return out


def _init(t, s: dict, path) -> None:
    """Scale or transform a standard normal draw in place as `s["init"]`
    says."""
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


def layout_of(config: dict) -> dict:
    """The parameter layout of the plain reference the configuration
    names."""
    from harness import spec
    return spec.reference(config).param_layout(config)


def model_weights(config: dict, device) -> dict:
    """The configuration's model, from its `weights_seed`, in the layout
    of the plain reference it names: one draw a dtype, or with a `mesh`
    every leaf put together from its pieces."""
    layout = layout_of(config)
    if config.get("mesh"):
        out: dict = {}
        for path, s in leaves(layout):
            _put(out, path, leaf(config, path, device, s))
        return out
    return make_weights(layout, config["weights_seed"], device)


def spec_at(layout: dict, path) -> dict:
    for k in path:
        layout = layout[k]
    return layout


def piece(config: dict, path, device, layer=None, s=None) -> torch.Tensor:
    """One piece of a `mesh` configuration's leaf at `path`: the leaf
    whole, or layer `layer` of a `stacked` leaf, drawn from its own
    generator (the configuration's `weights_seed`, the path, the layer)."""
    s = s or spec_at(layout_of(config), path)
    if bool(s.get("stacked")) != (layer is not None):
        raise ValueError(f"{'.'.join(path)}: a stacked leaf is drawn a "
                         "layer at a time, any other whole")
    key = f"{config['weights_seed']}/{'.'.join(path)}/{layer}".encode()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.sha256(key).digest()[:8],
                                 "little") % 2 ** 63)
    shape = s["shape"][1:] if layer is not None else s["shape"]
    t = torch.randn(shape, generator=g, dtype=DTYPES[s["dtype"]],
                    device=device)
    _init(t, s, path)
    return t


def leaf(config: dict, path, device, s=None) -> torch.Tensor:
    """A `mesh` configuration's leaf at `path`, whole, from its pieces."""
    s = s or spec_at(layout_of(config), path)
    if not s.get("stacked"):
        return piece(config, path, device, None, s)
    out = torch.empty(s["shape"], dtype=DTYPES[s["dtype"]], device=device)
    for i in range(s["shape"][0]):
        out[i] = piece(config, path, device, i, s)
    return out


def rank_blocks(config: dict, shardings: dict, device) -> dict:
    """This rank's blocks of a `mesh` configuration's model: every piece
    drawn whole on `device` and cut by the leaf's sharding (`shardings`,
    the program's tree of `NamedSharding` over the same paths: its
    `local_shape` and `shard`), the rest freed at once."""
    out: dict = {}
    for path, s in leaves(layout_of(config)):
        sh = spec_at(shardings, path)
        if not s.get("stacked"):
            _put(out, path, sh.shard(piece(config, path, device, None, s)))
            continue
        if any(d == 0 for d, _ in sh.dims()):
            raise ValueError(f"{'.'.join(path)}: the layer axis is split")
        block = torch.empty(sh.local_shape(s["shape"]),
                            dtype=DTYPES[s["dtype"]], device=device)
        for i in range(s["shape"][0]):
            block[i] = sh.shard(piece(config, path, device, i, s)[None])[0]
        _put(out, path, block)
    return out


def layout_bytes(layout: dict) -> int:
    return sum(math.prod(s["shape"]) * DTYPES[s["dtype"]].itemsize
               for _, s in leaves(layout))
