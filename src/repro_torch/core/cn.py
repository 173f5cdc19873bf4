"""Stream Step 1: Computation-Node identification & attribute extraction.

A CN isolates a subset of inner for-loops of a layer; the remaining outer-CN
loops enumerate the CNs and fix their intra-layer execution order (paper
Sec. III-A). Identification follows the paper's two principles:

1. *Layer topology awareness* — full-fan-in layers (fc) collapse to a single
   CN (breaking the fused stack); spatially-local layers (conv/pool/add/...)
   split along their spatial output loops (OY, optionally OX).

2. *HW dataflow awareness* — a CN must minimally encompass every loop dim
   that is spatially unrolled in ANY core of the accelerator, so no split is
   made along such dims (or tiles are kept >= the max unroll factor).

Per-CN attributes (paper Fig. 5):
  - `discardable_inputs`: input elements used exclusively by this CN, freed
    when it finishes (exact half-space intersection math, see
    `_exclusive_volume`),
  - `new_outputs`: final output elements first produced by this CN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.workload import FULL_FANIN_OPS, Layer, Workload

# Dims along which CNs may be split (spatial output dims, non-reduction).
SPLITTABLE = ("OY", "OX")


@dataclasses.dataclass(frozen=True)
class Rect:
    """Axis-aligned integer box: dim -> (start, stop). Missing dim == full."""

    ranges: tuple[tuple[str, int, int], ...]

    def volume(self) -> int:
        return math.prod(max(0, b - a) for _, a, b in self.ranges)

    def as_dict(self) -> dict[str, tuple[int, int]]:
        return {d: (a, b) for d, a, b in self.ranges}

    def intersection_volume(self, other: "Rect") -> int:
        mine, theirs = self.as_dict(), other.as_dict()
        vol = 1
        for d in set(mine) | set(theirs):
            a0, b0 = mine.get(d, (-(1 << 60), 1 << 60))
            a1, b1 = theirs.get(d, (-(1 << 60), 1 << 60))
            vol *= max(0, min(b0, b1) - max(a0, a1))
            if vol == 0:
                return 0
        return vol


@dataclasses.dataclass
class CN:
    """A computation node: one schedulable part of a layer."""

    id: int                      # global CN id
    layer: int                   # owning layer id
    idx: tuple[int, ...]         # position in the outer-CN loop grid
    intra_rank: int              # row-major rank == intra-layer exec order
    out_rect: Rect               # produced region of the layer output tensor
    in_rects: dict[int, Rect]    # producer layer id (-1 = external) -> needed input region
    macs: int
    discardable_inputs: int      # elements freed when this CN finishes
    new_inputs: int              # input elements not already needed by earlier CNs
    new_outputs: int             # final output elements generated
    weight_bytes: int            # layer weights (shared across the layer's CNs)
    in_bits: int = 8
    out_bits: int = 8

    @property
    def out_bytes(self) -> int:
        return self.new_outputs * self.out_bits // 8

    def size_signature(self) -> tuple:
        """CNs with equal signatures have identical mapping cost (Step 3 cache key).

        Keyed on loop EXTENTS, not absolute ranges: the intra-core mapping
        cost only sees `stop - start` per dim, so e.g. all interior row-bands
        of a layer collapse to one signature and are costed once. Memoized —
        every engine build over a cached graph re-reads it per CN.
        """
        sig = getattr(self, "_sig", None)
        if sig is None:
            sig = self._sig = (self.layer, tuple(sorted(
                (d, b - a) for d, a, b in self.out_rect.ranges)))
        return sig


def _split_ranges(extent: int, parts: int) -> list[tuple[int, int]]:
    """Split [0, extent) into `parts` near-equal contiguous ranges."""
    parts = max(1, min(parts, extent))
    base, rem = divmod(extent, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        out.append((start, stop))
        start = stop
    return out


def _receptive(rng: tuple[int, int], stride: int, fsize: int, pad: int, in_extent: int) -> tuple[int, int]:
    """Input range needed to produce output range `rng` (clipped by padding)."""
    a = rng[0] * stride - pad
    b = (rng[1] - 1) * stride - pad + fsize
    return (max(0, a), min(in_extent, b))


def resolve_splits(
    layer: Layer,
    granularity,
    min_tile: Mapping[str, int] | None = None,
) -> dict[str, int]:
    """Number of CN splits per splittable dim for `layer` under `granularity`.

    granularity: 'layer' | 'line' | ('tile', n_oy, n_ox) | dict(layer_id->granularity)
    min_tile: HW-dataflow-aware minimum tile extent per dim (max spatial unroll
              across cores); splits are clamped so tiles stay >= min_tile.
    """
    if isinstance(granularity, dict):
        granularity = granularity.get(layer.id, "layer")
    if layer.op in FULL_FANIN_OPS or granularity == "layer":
        return {}
    oy, ox = layer.d("OY"), layer.d("OX")
    if granularity == "line":
        want = {"OY": oy, "OX": 1}
    elif isinstance(granularity, tuple) and granularity[0] == "tile":
        want = {"OY": int(granularity[1]), "OX": int(granularity[2]) if len(granularity) > 2 else 1}
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    splits = {}
    for dim, extent in (("OY", oy), ("OX", ox)):
        n = min(want.get(dim, 1), extent)
        if min_tile and dim in min_tile and min_tile[dim] > 1:
            n = min(n, max(1, extent // min_tile[dim]))
        if n > 1:
            splits[dim] = n
    return splits


def identify_cns(
    workload: Workload,
    granularity="line",
    min_tile: Mapping[str, int] | None = None,
) -> list[CN]:
    """Split every layer of `workload` into CNs (Stream Step 1).

    All per-dimension work (receptive ranges, exclusive/fresh extents,
    output fractions) is precomputed once per layer and position; the
    per-CN loop only combines the per-position lookups, so splitting a
    layer into k CNs is O(k), not O(k x dims x receptive math).
    """
    cns: list[CN] = []
    for lid in workload.topo_order():
        layer = workload.layers[lid]
        splits = resolve_splits(layer, granularity, min_tile)
        dims = [d for d in SPLITTABLE if d in splits]
        _, _, iy_ext, ix_ext = layer.in_shape
        total_out = layer.out_elems
        layer_macs = layer.macs
        b_ext, k_ext, c_ext = layer.d("B"), layer.d("K"), layer.d("C")
        stride, pad = layer.stride, layer.padding
        wb, bits, op = layer.weight_bytes, layer.bits, layer.op

        # ---- per-dim precomputation (positions along each splittable dim) --
        # Every SPLITTABLE dim has a list of output ranges (length 1 when not
        # split), their input receptive ranges, the exclusive / fresh input
        # extents per position (paper Fig. 5), and the output fraction.
        out_rng: dict[str, list[tuple[int, int]]] = {}
        rcv: dict[str, list[tuple[int, int]]] = {}
        ext_excl: dict[str, list[int]] = {}
        ext_new: dict[str, list[int]] = {}
        frac_of: dict[str, list[float]] = {}
        for d in SPLITTABLE:
            tot = layer.d(d)
            rs = _split_ranges(tot, splits[d]) if d in splits else [(0, tot)]
            fsize = layer.d("FY" if d == "OY" else "FX")
            in_ext = iy_ext if d == "OY" else ix_ext
            rc = [_receptive(r, stride, fsize, pad, in_ext) for r in rs]
            xs, ns = [], []
            for pos, (a, b) in enumerate(rc):
                e_excl = e_new = max(0, b - a)
                if pos + 1 < len(rc):
                    e_excl = max(0, min(b, rc[pos + 1][0]) - a)
                if pos > 0:
                    e_new = max(0, b - max(a, rc[pos - 1][1]))
                xs.append(e_excl)
                ns.append(e_new)
            out_rng[d], rcv[d] = rs, rc
            ext_excl[d], ext_new[d] = xs, ns
            frac_of[d] = [(b - a) / tot for a, b in rs]
        grid = [len(out_rng[d]) for d in dims]
        n_cn = math.prod(grid) if grid else 1

        # per-producer K ranges (CN-independent): consumer input space; concat
        # rects carry the channel offset of each producer within the
        # concatenated K axis, so per-producer claims partition [0, K)
        # instead of all aliasing [0, pk)
        producers = layer.inputs if layer.inputs else (-1,)
        prod_k: list[tuple[int, int, int]] = []  # (producer, ka, kb)
        ch_off = 0
        for p in producers:
            if op == "concat":
                pk = workload.layers[p].d("K") if p >= 0 else c_ext
                prod_k.append((p, ch_off, ch_off + pk))
                ch_off += pk
            elif op in ("dwconv", "pool", "add"):
                prod_k.append((p, 0, k_ext))
            else:  # conv / fc need all input channels
                prod_k.append((p, 0, c_ext))
        sum_k = sum(kb - ka for _, ka, kb in prod_k)
        b_clamped = max(0, b_ext)

        for rank in range(n_cn):
            # decode row-major multi-index
            idx, rem = [], rank
            for g in reversed(grid):
                idx.append(rem % g)
                rem //= g
            idx = tuple(reversed(idx))
            pos = dict(zip(dims, idx))
            pos_oy, pos_ox = pos.get("OY", 0), pos.get("OX", 0)

            frac = 1.0
            for d, i in zip(dims, idx):
                frac *= frac_of[d][i]
            oy_a, oy_b = out_rng["OY"][pos_oy]
            ox_a, ox_b = out_rng["OX"][pos_ox]
            out_rect = Rect((("B", 0, b_ext), ("K", 0, k_ext),
                             ("OY", oy_a, oy_b), ("OX", ox_a, ox_b)))

            # input rect per producer operand (consumer input space)
            iy = rcv["OY"][pos_oy]
            ix = rcv["OX"][pos_ox]
            in_rects: dict[int, Rect] = {
                p: Rect((("B", 0, b_ext), ("K", ka, kb),
                         ("OY", iy[0], iy[1]), ("OX", ix[0], ix[1])))
                for p, ka, kb in prod_k}

            # ---- attribute extraction (paper Fig. 5) -----------------------
            # exclusive input volume: Π_d extent-before-next-CN's-input-start
            # fresh input volume:     Π_d extent-after-prev-CN's-input-stop
            # (per-dim extents looked up from the per-position tables; the
            # per-producer K extents factor out of the dim product)
            base = b_clamped * sum_k
            discardable = base * ext_excl["OY"][pos_oy] * ext_excl["OX"][pos_ox]
            fresh = base * ext_new["OY"][pos_oy] * ext_new["OX"][pos_ox]

            macs = max(1, round(layer_macs * frac))
            new_out = max(1, round(total_out * frac)) if total_out else 0

            cns.append(CN(
                id=len(cns), layer=lid, idx=idx, intra_rank=rank,
                out_rect=out_rect, in_rects=in_rects, macs=macs,
                discardable_inputs=discardable, new_inputs=fresh, new_outputs=new_out,
                weight_bytes=wb, in_bits=bits, out_bits=bits,
            ))
    return cns


def cns_by_layer(cns: Sequence[CN]) -> dict[int, list[CN]]:
    out: dict[int, list[CN]] = {}
    for cn in cns:
        out.setdefault(cn.layer, []).append(cn)
    for lst in out.values():
        lst.sort(key=lambda c: c.intra_rank)
    return out
