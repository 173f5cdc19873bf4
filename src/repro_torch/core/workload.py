"""Workload IR: a DAG of DNN layers (Stream Step 0 input).

Each layer is described by its nested-for-loop ranges (ONNX-convention dims):
  B  batch            K  output channels     C  input channels
  OY/OX output rows/cols        FY/FX filter rows/cols
plus stride / padding. This mirrors Stream's ONNX-derived layer representation
(paper Sec. III-A: "compatible with all layer types, strides, and padding
supported by ONNX").

Supported op types:
  conv    : full convolution          (loops B K C OY OX FY FX)
  dwconv  : depthwise convolution     (loops B K OY OX FY FX; C==1 per group)
  fc      : fully connected / GEMM    (loops B K C) - single-CN by topology rule
  pool    : max/avg pool              (loops B K OY OX FY FX) - SIMD-mapped
  add     : elementwise residual add  (loops B K OY OX)       - SIMD-mapped
  concat  : channel concat (zero-cost data movement, scheduling-only node)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

# Canonical loop-dimension order used throughout Stream-core.
LOOP_DIMS = ("B", "K", "C", "OY", "OX", "FY", "FX")

# Ops whose output is spatially local in OY/OX (eligible for fused/line CNs).
SPATIAL_OPS = frozenset({"conv", "dwconv", "pool", "add", "concat"})
# Ops that require the full input fan-in for a single output (break fusion).
FULL_FANIN_OPS = frozenset({"fc"})
# Ops mapped to the SIMD core in the exploration study (pool / residual add).
SIMD_OPS = frozenset({"pool", "add", "concat"})


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer (node) of the workload DAG."""

    id: int
    name: str
    op: str
    dims: Mapping[str, int]  # loop dim -> extent (missing -> 1)
    stride: int = 1
    padding: int = 0
    # ids of producer layers feeding each input operand (len 1, or 2 for add)
    inputs: Sequence[int] = ()
    bits: int = 8  # operand precision (paper targets 8b edge accelerators)

    def d(self, name: str) -> int:
        return int(self.dims.get(name, 1))

    # ---- derived tensor geometry -------------------------------------------------
    @property
    def out_shape(self) -> tuple[int, int, int, int]:  # (B, K, OY, OX)
        return (self.d("B"), self.d("K"), self.d("OY"), self.d("OX"))

    @property
    def in_shape(self) -> tuple[int, int, int, int]:  # (B, C, IY, IX)
        iy = (self.d("OY") - 1) * self.stride + self.d("FY") - 2 * self.padding
        ix = (self.d("OX") - 1) * self.stride + self.d("FX") - 2 * self.padding
        cin = self.d("C") if self.op not in ("dwconv", "pool", "add", "concat") else self.d("K")
        return (self.d("B"), cin, max(iy, 1), max(ix, 1))

    @property
    def macs(self) -> int:
        if self.op in ("add", "concat"):
            return self.d("B") * self.d("K") * self.d("OY") * self.d("OX")
        return math.prod(self.d(x) for x in LOOP_DIMS)

    @property
    def weight_elems(self) -> int:
        if self.op == "conv":
            return self.d("K") * self.d("C") * self.d("FY") * self.d("FX")
        if self.op == "dwconv":
            return self.d("K") * self.d("FY") * self.d("FX")
        if self.op == "fc":
            return self.d("K") * self.d("C")
        return 0

    @property
    def weight_bytes(self) -> int:
        return self.weight_elems * self.bits // 8

    @property
    def out_elems(self) -> int:
        return math.prod(self.out_shape)

    @property
    def out_bytes(self) -> int:
        return self.out_elems * self.bits // 8


class Workload:
    """A DAG of Layers. Edges run producer -> consumer."""

    def __init__(self, name: str = "workload"):
        self.name = name
        self.layers: dict[int, Layer] = {}
        self._succ: dict[int, list[int]] = {}

    # ---- construction --------------------------------------------------------
    def add(
        self,
        name: str,
        op: str,
        dims: Mapping[str, int],
        *,
        stride: int = 1,
        padding: int = 0,
        inputs: Iterable[int] = (),
        bits: int = 8,
    ) -> int:
        lid = len(self.layers)
        inputs = tuple(inputs)
        self.layers[lid] = Layer(
            id=lid, name=name, op=op, dims=dict(dims), stride=stride,
            padding=padding, inputs=inputs, bits=bits,
        )
        self._succ[lid] = []
        for p in inputs:
            self._succ[p].append(lid)
        return lid

    # ---- queries -------------------------------------------------------------
    def successors(self, lid: int) -> list[int]:
        return self._succ[lid]

    def predecessors(self, lid: int) -> tuple[int, ...]:
        return tuple(self.layers[lid].inputs)

    def topo_order(self) -> list[int]:
        # layers are added in topological order by construction; verify anyway
        seen: set[int] = set()
        for lid, layer in self.layers.items():
            for p in layer.inputs:
                if p not in seen:
                    raise ValueError(f"layer {lid} consumes unseen producer {p}")
            seen.add(lid)
        return list(self.layers)

    def edges(self) -> list[tuple[int, int]]:
        return [(p, c) for c, l in self.layers.items() for p in l.inputs]

    def cache_key(self) -> tuple:
        """Content-based hashable identity (layers are mutable-by-append, so
        the key reflects the current DAG). Used to memoize CN-graph builds
        across repeated explorations of structurally identical workloads."""
        return (self.name, tuple(
            (l.id, l.op, tuple(sorted(l.dims.items())), l.stride, l.padding,
             tuple(l.inputs), l.bits)
            for l in self.layers.values()))

    # ---- serialization (shard manifests ship workloads as pure data) ---------
    def to_dict(self) -> dict:
        """JSON-ready DAG description; `from_dict` round-trips it exactly
        (`cache_key()` is preserved, so content keys survive the trip)."""
        return {"name": self.name, "layers": [
            {"name": l.name, "op": l.op, "dims": dict(l.dims),
             "stride": l.stride, "padding": l.padding,
             "inputs": list(l.inputs), "bits": l.bits}
            for l in self.layers.values()]}

    @classmethod
    def from_dict(cls, data: Mapping) -> "Workload":
        """Rebuild a workload from `to_dict` output (layer ids are assigned
        in list order, matching the original append order)."""
        w = cls(str(data["name"]))
        for l in data["layers"]:
            w.add(l["name"], l["op"], {str(k): int(v)
                                       for k, v in l["dims"].items()},
                  stride=int(l["stride"]), padding=int(l["padding"]),
                  inputs=tuple(int(i) for i in l["inputs"]),
                  bits=int(l["bits"]))
        return w

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers.values())

    @property
    def total_weight_bytes(self) -> int:
        return sum(l.weight_bytes for l in self.layers.values())

    def __len__(self) -> int:
        return len(self.layers)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Workload({self.name}, {len(self)} layers, {self.total_macs/1e6:.1f} MMAC)"
