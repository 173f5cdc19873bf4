"""Stream Step 2: fine-grained CN dependency-graph generation.

Intra-layer edges follow the outer-CN loop order (rank i -> i+1), keeping
tensor accesses implementable with loop counters. Inter-layer edges are found
per producer/consumer layer pair by building an R-tree over the consumer CNs'
required-input boxes and bulk-querying it with all producer CNs' produced-
output boxes at once (paper Fig. 6); edge weight = intersection volume in
bytes, computed vectorized over the surviving (producer, consumer) pairs.

The graph is stored array-native: CSR adjacency (``indptr``/``indices``/
``edge bytes`` for both directions) plus dense per-CN attribute arrays, so the
scheduler's inner loop indexes flat arrays instead of chasing ``CN`` objects
and dict-keyed edge weights. The seed's list/dict views (``preds``, ``succs``,
``edge_bytes``) are kept as lazily-built properties for tests and tooling.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from repro_torch.core.cn import CN, Rect, cns_by_layer
from repro_torch.core.rtree import RTree, brute_force_query_batch
from repro_torch.core.workload import Workload

_DIMS = ("B", "K", "OY", "OX")
_K_AXIS = _DIMS.index("K")


def _rect_to_box(rect: Rect) -> np.ndarray:
    rd = rect.as_dict()
    return np.array([rd.get(d, (0, 1 << 40)) for d in _DIMS], dtype=np.int64)


def _rects_to_boxes(rects: list[Rect]) -> np.ndarray:
    """(n, 4, 2) box array in one numpy call (not one np.array per rect)."""
    rows = []
    for rect in rects:
        rd = rect.as_dict()
        rows.append([rd.get(d, (0, 1 << 40)) for d in _DIMS])
    return np.array(rows, dtype=np.int64)


class CNGraph:
    """CN DAG with data-weighted edges. Edge bytes==0 marks pure ordering edges.

    Canonical storage is CSR over the edge list in insertion order:
      * ``pred_indptr``/``pred_indices``/``pred_bytes``: incoming edges of CN
        ``v`` are ``pred_indices[pred_indptr[v]:pred_indptr[v+1]]`` with their
        byte weights aligned in ``pred_bytes`` (insertion order preserved —
        the scheduler's bus-FCFS serving order depends on it),
      * ``succ_indptr``/``succ_indices``/``succ_bytes``: same for outgoing,
    plus dense per-CN attribute arrays (``layer``, ``intra_rank``, ``macs``,
    ``out_bytes``, ``weight_bytes``, ``new_inputs``, ``discardable_inputs``,
    ``in_bits``) so no ``CN`` object access is needed on the scheduling path.
    """

    def __init__(self, cns: list[CN], edge_u: np.ndarray, edge_v: np.ndarray,
                 edge_b: np.ndarray):
        self.cns = cns
        n = len(cns)
        self.n = n
        edge_u = np.asarray(edge_u, dtype=np.int64)
        edge_v = np.asarray(edge_v, dtype=np.int64)
        edge_b = np.asarray(edge_b, dtype=np.int64)

        # CSR by source (stable: keeps insertion order within one source CN)
        order_u = np.argsort(edge_u, kind="stable")
        self.succ_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(edge_u, minlength=n), out=self.succ_indptr[1:])
        self.succ_indices = edge_v[order_u]
        self.succ_bytes = edge_b[order_u]

        # CSR by destination (stable: preserves per-consumer insertion order)
        order_v = np.argsort(edge_v, kind="stable")
        self.pred_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(edge_v, minlength=n), out=self.pred_indptr[1:])
        self.pred_indices = edge_u[order_v]
        self.pred_bytes = edge_b[order_v]

        # dense per-CN attribute arrays
        self.layer = np.array([c.layer for c in cns], dtype=np.int64)
        self.intra_rank = np.array([c.intra_rank for c in cns], dtype=np.int64)
        self.macs = np.array([c.macs for c in cns], dtype=np.int64)
        self.out_bytes = np.array([c.out_bytes for c in cns], dtype=np.int64)
        self.weight_bytes = np.array([c.weight_bytes for c in cns], dtype=np.int64)
        self.new_inputs = np.array([c.new_inputs for c in cns], dtype=np.int64)
        self.discardable_inputs = np.array(
            [c.discardable_inputs for c in cns], dtype=np.int64)
        self.in_bits = np.array([c.in_bits for c in cns], dtype=np.int64)

    # ---- scheduler hot-path views (shared by every engine on this graph) --
    @functools.cached_property
    def pred_pairs(self) -> list[tuple[tuple[int, int], ...]]:
        """Per-CN tuple of (predecessor, edge bytes), insertion order."""
        ptr = self.pred_indptr.tolist()
        idx = self.pred_indices.tolist()
        byt = self.pred_bytes.tolist()
        return [tuple(zip(idx[ptr[v]:ptr[v + 1]], byt[ptr[v]:ptr[v + 1]]))
                for v in range(self.n)]

    @functools.cached_property
    def pred_split(self) -> tuple[list[tuple[int, ...]],
                                  list[tuple[tuple[int, int], ...]]]:
        """`pred_pairs` split by edge kind: (ordering-only predecessors,
        data-carrying (predecessor, bytes) pairs), both insertion-ordered.

        Zero-byte edges only contribute their producer's finish time — the
        scheduler's hot loop iterates them without unpacking byte weights or
        re-testing `bytes == 0` per edge. Order within the data list is what
        fixes the bus FCFS serving order; ordering edges commute (a max)."""
        zero: list[tuple[int, ...]] = []
        data: list[tuple[tuple[int, int], ...]] = []
        for pairs in self.pred_pairs:
            zero.append(tuple(u for u, b in pairs if b == 0))
            data.append(tuple(p for p in pairs if p[1] != 0))
        return zero, data

    @functools.cached_property
    def succ_tuples(self) -> list[tuple[int, ...]]:
        ptr = self.succ_indptr.tolist()
        idx = self.succ_indices.tolist()
        return [tuple(idx[ptr[u]:ptr[u + 1]]) for u in range(self.n)]

    @functools.cached_property
    def hot_lists(self) -> dict[str, list]:
        """Per-CN attribute arrays as flat Python lists (fastest scalar
        access in the interpreter's scheduling loop)."""
        return {
            "indeg": np.diff(self.pred_indptr).tolist(),
            "layer": self.layer.tolist(),
            "intra_rank": self.intra_rank.tolist(),
            "out_bytes": self.out_bytes.tolist(),
            "weight_bytes": self.weight_bytes.tolist(),
            "new_in_bytes": (self.new_inputs * self.in_bits / 8.0).tolist(),
            "disc_bytes": (self.discardable_inputs * self.in_bits / 8.0).tolist(),
        }

    # ---- legacy list/dict views (tests, tooling) --------------------------
    @functools.cached_property
    def preds(self) -> list[list[int]]:
        ptr, idx = self.pred_indptr.tolist(), self.pred_indices.tolist()
        return [idx[ptr[v]:ptr[v + 1]] for v in range(self.n)]

    @functools.cached_property
    def succs(self) -> list[list[int]]:
        ptr, idx = self.succ_indptr.tolist(), self.succ_indices.tolist()
        return [idx[ptr[u]:ptr[u + 1]] for u in range(self.n)]

    @functools.cached_property
    def edge_bytes(self) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        ptr, idx, byt = (self.succ_indptr.tolist(), self.succ_indices.tolist(),
                         self.succ_bytes.tolist())
        for u in range(self.n):
            for k in range(ptr[u], ptr[u + 1]):
                out[(u, idx[k])] = byt[k]
        return out

    def n_edges(self) -> int:
        return int(self.succ_indices.size)

    def topo_ready_counts(self) -> np.ndarray:
        return np.diff(self.pred_indptr)


def build_cn_graph(
    workload: Workload,
    cns: Sequence[CN],
    *,
    use_rtree: bool = True,
) -> CNGraph:
    by_layer = cns_by_layer(cns)
    chunks_u: list[np.ndarray] = []
    chunks_v: list[np.ndarray] = []
    chunks_b: list[np.ndarray] = []
    boxes_of: dict[int, np.ndarray] = {}  # layer -> (n_cn, 4, 2) out boxes

    # ---- intra-layer ordering edges ---------------------------------------
    for layer_cns in by_layer.values():
        ids = np.array([c.id for c in layer_cns], dtype=np.int64)
        if ids.size > 1:
            chunks_u.append(ids[:-1])
            chunks_v.append(ids[1:])
            chunks_b.append(np.zeros(ids.size - 1, dtype=np.int64))

    # ---- inter-layer data edges (bulk R-tree per producer/consumer pair) --
    for cons_lid, cons_layer in workload.layers.items():
        cons_cns = by_layer[cons_lid]
        cons_ids = np.array([c.id for c in cons_cns], dtype=np.int64)
        k_off = 0
        for prod_lid in cons_layer.inputs:
            prod_cns = by_layer[prod_lid]
            prod_ids = np.array([p.id for p in prod_cns], dtype=np.int64)
            cons_boxes = _rects_to_boxes([c.in_rects[prod_lid] for c in cons_cns])
            prod_boxes = boxes_of.get(prod_lid)
            if prod_boxes is None:
                prod_boxes = _rects_to_boxes([p.out_rect for p in prod_cns])
                boxes_of[prod_lid] = prod_boxes
            if cons_layer.op == "concat":
                # concat in_rects live in the consumer's concatenated-K space;
                # translate the producer's output boxes into it
                prod_boxes = prod_boxes.copy()
                prod_boxes[:, _K_AXIS, :] += k_off
                k_off += workload.layers[prod_lid].d("K")
            bits = workload.layers[prod_lid].bits
            if use_rtree and len(cons_cns) > 8:
                tree = RTree(cons_boxes)
                pi, ci = tree.query_batch(prod_boxes)
            else:  # brute force (paper's baseline; kept for tests/benches)
                pi, ci = brute_force_query_batch(cons_boxes, prod_boxes)
            if pi.size == 0:
                continue
            # vectorized intersection volumes over the surviving pairs
            lo = np.maximum(prod_boxes[pi, :, 0], cons_boxes[ci, :, 0])
            hi = np.minimum(prod_boxes[pi, :, 1], cons_boxes[ci, :, 1])
            vol = np.clip(hi - lo, 0, None).prod(axis=1)
            keep = vol > 0
            chunks_u.append(prod_ids[pi[keep]])
            chunks_v.append(cons_ids[ci[keep]])
            chunks_b.append(vol[keep] * bits // 8)

    if chunks_u:
        eu = np.concatenate(chunks_u)
        ev = np.concatenate(chunks_v)
        eb = np.concatenate(chunks_b)
        # merge duplicate (u, v) pairs: bytes accumulate into the first
        # occurrence, whose position fixes the edge's insertion order
        n = len(cns)
        key = eu * n + ev
        uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
        if uniq.size != key.size:
            bsum = np.zeros(uniq.size, dtype=np.int64)
            np.add.at(bsum, inv, eb)
            order = np.argsort(first, kind="stable")
            eu, ev, eb = eu[first[order]], ev[first[order]], bsum[order]
    else:
        eu = ev = eb = np.empty(0, dtype=np.int64)

    return CNGraph(list(cns), eu, ev, eb)
