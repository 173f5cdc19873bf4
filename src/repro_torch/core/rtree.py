"""Stream Step 2 substrate: a bulk-loaded STR R-tree (Guttman [16]).

The paper's inter-layer dependency generator needs "rapid querying of
spatially separable data": given ~10^5-10^6 consumer-CN input boxes, find all
boxes intersecting a producer-CN output box without the O(N*M) pairwise scan.

We bulk-load with Sort-Tile-Recursive packing (Leutenegger et al.) and store
each tree level as a contiguous numpy array of bounding boxes, so a query
descends level-by-level with vectorized interval tests. Children of node `i`
are the contiguous slice [i*F, (i+1)*F) one level down (fixed fanout F).

Boxes are half-open integer intervals: box[d] = (lo, hi), intersecting iff
q_lo < hi and lo < q_hi in every dim.
"""
from __future__ import annotations

import math

import numpy as np


class RTree:
    def __init__(self, boxes: np.ndarray, fanout: int = 32):
        """boxes: (N, d, 2) int array of half-open boxes, in caller id order."""
        boxes = np.asarray(boxes)
        if boxes.ndim != 3 or boxes.shape[2] != 2:
            raise ValueError(f"boxes must be (N, d, 2), got {boxes.shape}")
        self.n, self.d, _ = boxes.shape
        self.fanout = fanout
        # ---- STR packing: recursively sort-and-slab along each dimension ----
        order = np.arange(self.n)
        centers = boxes[:, :, 0] + boxes[:, :, 1]  # 2*center, monotone equivalent
        self._perm = self._str_order(order, centers, 0)
        # ---- level 0 = leaves in packed order; parents take child bbox union ----
        self.levels: list[np.ndarray] = [boxes[self._perm]]
        while self.levels[-1].shape[0] > fanout:
            child = self.levels[-1]
            n_par = math.ceil(child.shape[0] / fanout)
            pad = n_par * fanout - child.shape[0]
            lo = child[:, :, 0]
            hi = child[:, :, 1]
            if pad:
                lo = np.concatenate([lo, np.full((pad, self.d), np.iinfo(np.int64).max // 2)])
                hi = np.concatenate([hi, np.full((pad, self.d), np.iinfo(np.int64).min // 2)])
            plo = lo.reshape(n_par, fanout, self.d).min(axis=1)
            phi = hi.reshape(n_par, fanout, self.d).max(axis=1)
            self.levels.append(np.stack([plo, phi], axis=-1))

    def _str_order(self, idx: np.ndarray, centers: np.ndarray, dim: int) -> np.ndarray:
        """Recursive STR: sort by dim, slice into slabs, recurse on next dim."""
        if len(idx) <= self.fanout or dim >= self.d - 1:
            return idx[np.argsort(centers[idx, dim], kind="stable")] if dim < self.d else idx
        srt = idx[np.argsort(centers[idx, dim], kind="stable")]
        # number of slabs so leaves end ~square in remaining dims
        n_leaf = math.ceil(len(idx) / self.fanout)
        n_slab = max(1, math.ceil(n_leaf ** (1.0 / (self.d - dim))))
        slab = math.ceil(len(idx) / n_slab)
        parts = [self._str_order(srt[i: i + slab], centers, dim + 1)
                 for i in range(0, len(srt), slab)]
        return np.concatenate(parts)

    def query(self, box: np.ndarray) -> np.ndarray:
        """Return original ids of all stored boxes intersecting `box` ((d,2))."""
        box = np.asarray(box)
        qlo, qhi = box[:, 0], box[:, 1]
        # start from the root level, descend keeping candidate node indices
        cand = np.arange(self.levels[-1].shape[0])
        for lvl in range(len(self.levels) - 1, 0, -1):
            b = self.levels[lvl][cand]
            hit = np.all((qlo < b[:, :, 1]) & (b[:, :, 0] < qhi), axis=1)
            nodes = cand[hit]
            # expand to children at level-1
            n_child = self.levels[lvl - 1].shape[0]
            cand = (nodes[:, None] * self.fanout + np.arange(self.fanout)[None, :]).ravel()
            cand = cand[cand < n_child]
            if cand.size == 0:
                return np.empty(0, dtype=np.int64)
        b = self.levels[0][cand]
        hit = np.all((qlo < b[:, :, 1]) & (b[:, :, 0] < qhi), axis=1)
        return self._perm[cand[hit]]

    def query_many(self, boxes: np.ndarray) -> list[np.ndarray]:
        return [self.query(b) for b in np.asarray(boxes)]

    def query_batch(self, boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Bulk query: all stored-box intersections for a batch of query boxes.

        boxes: (Q, d, 2). Returns (query_idx, item_id) arrays where stored box
        `item_id` intersects query box `query_idx`. Pairs are grouped by query
        index in ascending order, and within one query follow the same packed
        leaf order as `query()`, so the batch is a drop-in replacement for a
        per-box query loop. The whole descent runs as one vectorized
        (candidate-pair x dim) interval test per tree level.
        """
        boxes = np.asarray(boxes)
        nq = boxes.shape[0]
        if nq == 0 or self.n == 0:
            return (np.empty(0, dtype=np.int64),) * 2
        qlo, qhi = boxes[:, :, 0], boxes[:, :, 1]
        n_root = self.levels[-1].shape[0]
        q = np.repeat(np.arange(nq, dtype=np.int64), n_root)
        node = np.tile(np.arange(n_root, dtype=np.int64), nq)
        for lvl in range(len(self.levels) - 1, 0, -1):
            b = self.levels[lvl][node]
            hit = np.all((qlo[q] < b[:, :, 1]) & (b[:, :, 0] < qhi[q]), axis=1)
            q, node = q[hit], node[hit]
            # expand surviving nodes to their children one level down
            n_child = self.levels[lvl - 1].shape[0]
            child = node[:, None] * self.fanout + np.arange(self.fanout)[None, :]
            q = np.repeat(q, self.fanout)
            node = child.ravel()
            keep = node < n_child
            q, node = q[keep], node[keep]
            if node.size == 0:
                return (np.empty(0, dtype=np.int64),) * 2
        b = self.levels[0][node]
        hit = np.all((qlo[q] < b[:, :, 1]) & (b[:, :, 0] < qhi[q]), axis=1)
        return q[hit], self._perm[node[hit]]


def brute_force_query_batch(boxes: np.ndarray, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized all-pairs oracle: (query_idx, item_idx) intersecting pairs,
    grouped by query index ascending, item index ascending within a query."""
    boxes = np.asarray(boxes)
    queries = np.asarray(queries)
    hit = np.all((queries[:, None, :, 0] < boxes[None, :, :, 1])
                 & (boxes[None, :, :, 0] < queries[:, None, :, 1]), axis=2)
    return np.nonzero(hit)


def brute_force_query(boxes: np.ndarray, box: np.ndarray) -> np.ndarray:
    """O(N) oracle used by tests and the paper's baseline comparison."""
    boxes = np.asarray(boxes)
    qlo, qhi = np.asarray(box)[:, 0], np.asarray(box)[:, 1]
    hit = np.all((qlo[None] < boxes[:, :, 1]) & (boxes[:, :, 0] < qhi[None]), axis=1)
    return np.nonzero(hit)[0]
