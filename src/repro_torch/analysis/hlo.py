"""The dry run's counts: dot FLOPs, an HBM-traffic proxy and collective
bytes of one run of the port's program, the counterpart of the JAX
package's `repro/analysis/hlo.py` (which walks XLA's optimized HLO text).

The port walks no HLO.  A `Recorder` records the aten ops that one run of
rank 0's program dispatches, usually under `torch._subclasses.
FakeTensorMode` (the shapes and dtypes of a real run, no data and no
device work), and the collectives the program calls on an abstract mesh
(`sharding.rules.Mesh.abstract`), which it answers with empty tensors of
the output's shape.  The counting rules are the reference walker's:

  dots        `mm`, `bmm`, `addmm`, `baddbmm` (the ops `einsum`, `matmul`
              and `linear` decompose into, `out_dtype` overloads
              included): 2 * prod(out) * K FLOPs, and the two operands'
              and the output's bytes towards HBM
  data moves  2 * output bytes (read + write): `copy_` within one dtype,
              `clone`, `_to_copy` within one dtype, `index_put(_)`,
              `scatter(_add, _reduce)`, `index_add(_)`, `index_copy(_)`,
              `slice_scatter`, `select_scatter`, `index`, `gather`,
              `embedding`, `index_select`, the reductions (`sum`, `mean`,
              `amax`, `amin`, `max`/`min` over dims, `prod`, `var`,
              `std`, `norm`, `logsumexp`, `any`, `all`, `argmax`,
              `argmin`), the scans (`cumsum`, `cumprod`, `cummax`,
              `cummin`), `sort`, `topk`, `cat` and `convolution`
  fused       everything else: elementwise ops, `where`, views, factory
              ops and dtype casts (`_to_copy` or `copy_` across dtypes),
              as XLA fuses `convert` and elementwise ops
  collectives by the reference's kind names (`COLLECTIVES`), in ring wire
              bytes a device (`collective_wire_bytes`), and 2 * output
              bytes towards HBM
  attention   the bytes of every dot inside a `torch.einsum` whose
  tiles       equation matches `ATTENTION_EINSUM` (the reference's
              pattern: the decode attention's score and context
              products) or inside `layers.attention_dot` (those of
              `layers.blocked_attention`), forward and backward; a fused
              attention kernel keeps these tiles on chip, so the
              roofline's memory term subtracts them

`while_trip_counts` is always `{}`: the port's layer stacks, attention
blocks and scan chunks are Python loops, unrolled in the run, so every op
is counted where it runs.  The recorder also tracks the bytes of the
storages the run allocates (`peak_bytes`: the most alive at once, the
arguments excluded), the dry run's `temp_size_bytes`.

    >>> collective_wire_bytes("all-reduce", 1024, 4)
    1536.0
    >>> collective_wire_bytes("all-gather", 1024, 4)
    768.0
    >>> import torch
    >>> with Recorder() as rec:
    ...     y = torch.ones(8, 16) @ torch.ones(16, 4)
    >>> rec.analysis().flops == 2 * 8 * 4 * 16
    True
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.layers import attention_dot

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the reference walker's attention-tile pattern (`hlo.py:299` there), over
# torch.einsum's equation
ATTENTION_EINSUM = re.compile(r"->bhgqk|bhgqk,|->bhgt|bhgt,")

aten = torch.ops.aten
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1}
_MOVES = frozenset({
    aten.copy_, aten.clone, aten._to_copy, aten.index_put, aten.index_put_,
    aten._index_put_impl_, aten.scatter, aten.scatter_, aten.scatter_add,
    aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
    aten.index_add, aten.index_add_, aten.index_copy, aten.index_copy_,
    aten.slice_scatter, aten.select_scatter, aten.index, aten.gather,
    aten.embedding, aten.index_select, aten.sum, aten.mean, aten.amax,
    aten.amin, aten.max, aten.min, aten.prod, aten.var, aten.std,
    aten.var_mean, aten.std_mean, aten.norm, aten.linalg_vector_norm,
    aten.logsumexp, aten.any, aten.all, aten.argmax, aten.argmin,
    aten.cumsum, aten.cumprod, aten.cummax, aten.cummin, aten.sort,
    aten.topk, aten.cat, aten.convolution})
# overloads of move packets that are elementwise (`max(a, b)`)
_ELEMENTWISE = frozenset({aten.max.other, aten.min.other})

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHARDING = os.path.join(_PORT, "sharding") + os.sep
_TORCH = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep


def collective_wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Wire bytes a device of a collective of `kind` over a ring of
    `group` devices, `nbytes` the output's bytes: all-reduce 2B(g-1)/g
    (reduce-scatter + all-gather); all-gather, reduce-scatter and
    all-to-all B(g-1)/g; collective-permute B (the reference's
    `collective_wire_bytes`, with the tensor's own dtype: no XLA:CPU
    promotion to undo)."""
    ring = (group - 1) / group if group > 1 else 1.0
    if kind == "all-reduce":
        return float(nbytes) * 2 * ring
    if kind == "collective-permute":
        return float(nbytes)
    return float(nbytes) * ring


@dataclasses.dataclass
class HLOAnalysis:
    flops: float
    collective_bytes: dict[str, float]
    hbm_bytes: float
    attn_tile_bytes: float   # attention score/context tile traffic: on
                             # chip inside a fused attention kernel —
                             # subtract for the fused memory term
    while_trip_counts: dict[str, int]
    n_collectives: dict[str, int]

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storages(trees) -> dict:
    """The distinct storages of the tensors in `trees`, by storage."""
    out = {}
    for t in _tensors(trees):
        st = t.untyped_storage()
        out.setdefault(st._cdata, st)
    return out


def storage_bytes(*trees) -> int:
    """The bytes of the storages of the tensors in `trees` (nested dicts,
    lists and tuples), each storage once."""
    return sum(st.nbytes() for st in _storages(trees).values())


def _where() -> str:
    """Where the program asked for a collective: the innermost frame
    outside the sharding layer, this module and torch, with the sharding
    function it called (e.g. `models/transformer.py:444 decoder_forward
    via gather_params`); a collective of a backward pass is named by its
    autograd function (`sharding/collectives.py _GatherParam.backward`)."""
    via = None
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        name = getattr(f.f_code, "co_qualname", f.f_code.co_name)
        if path.startswith(_SHARDING):
            if f.f_code.co_name == "backward":
                return f"{os.path.relpath(path, _PORT)} {name}"
            via = name
        elif path != __file__ and not path.startswith(_TORCH):
            rel = os.path.relpath(path, _PORT) if path.startswith(_PORT) \
                else os.path.basename(path)
            return f"{rel}:{f.f_lineno} {name}" + (f" via {via}" if via
                                                   else "")
        f = f.f_back
    return f"via {via}" if via else "?"


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.rec._op(func, args, out)
        return out


class _Functions(TorchFunctionMode):
    """Tags the dots of attention products: einsums by their equation
    (gone by the time their aten ops dispatch) and `layers.attention_dot`."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not attention_dot and (
                func is not torch.einsum or not isinstance(args[0], str) or
                not ATTENTION_EINSUM.search(args[0])):
            return func(*args, **kwargs)
        self.rec._attn += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.rec._attn -= 1
        if out.requires_grad:
            self.rec._tag_backward(out, args)
        return out


class Recorder:
    """Records one run (a context manager): dot FLOPs, the HBM proxy,
    attention tile bytes and collectives (module docstring), each
    collective in `log` as (kind, wire bytes, where, shape, dtype), and
    `peak_bytes`, the most bytes of storages allocated in the run alive
    at once (storages of tensors passed to `exclude`, the arguments, never
    count).  `meshes`: abstract meshes (`Mesh.abstract`) whose collectives
    it answers while it is entered; a mesh with a process group behind it
    is refused, so a real run never skips a collective."""

    def __init__(self, *meshes):
        for m in meshes:
            if m.device_mesh is not None:
                raise ValueError(f"{m!r} has ranks behind it; a recorder "
                                 "answers only an abstract mesh's "
                                 "collectives")
        self.meshes = meshes
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.attn_tile_bytes = 0.0
        self.collective_bytes: dict[str, float] = defaultdict(float)
        self.n_collectives: dict[str, int] = defaultdict(int)
        self.log: list[tuple] = []
        self.peak_bytes = 0
        self._attn = 0
        self._excluded: set[int] = set()
        self._live: dict[int, tuple] = {}
        self._live_bytes = 0
        self._modes = ()

    # ---- the run ----------------------------------------------------------
    def exclude(self, *trees) -> int:
        """Never count the storages of these tensors (nested dicts, lists
        and tuples of them); returns their bytes, each storage once."""
        storages = _storages(trees)
        self._excluded.update(storages)
        return sum(st.nbytes() for st in storages.values())

    def __enter__(self):
        for m in self.meshes:
            m.recorder = self
        self._modes = (_Functions(self), _Dispatch(self))
        for mode in self._modes:
            mode.__enter__()
        return self

    def __exit__(self, *exc):
        for mode in reversed(self._modes):
            mode.__exit__(*exc)
        self._modes = ()
        for m in self.meshes:
            m.recorder = None
        return False

    def analysis(self) -> HLOAnalysis:
        return HLOAnalysis(flops=self.flops,
                           collective_bytes=dict(self.collective_bytes),
                           hbm_bytes=self.hbm_bytes,
                           attn_tile_bytes=self.attn_tile_bytes,
                           while_trip_counts={},
                           n_collectives=dict(self.n_collectives))

    # ---- what the modes and the meshes call -------------------------------
    def collective(self, kind: str, x: torch.Tensor, shape, group: int):
        """A collective's empty output of `shape` (x's dtype and device),
        its wire bytes and its source logged."""
        out = x.new_empty(tuple(shape))
        nbytes = _nbytes(out)
        wire = collective_wire_bytes(kind, nbytes, group)
        self.collective_bytes[kind] += wire
        self.n_collectives[kind] += 1
        self.hbm_bytes += 2 * nbytes
        self.log.append((kind, wire, _where(), tuple(shape),
                         str(x.dtype).replace("torch.", "")))
        return out

    def _op(self, func, args, out) -> None:
        packet = func.overloadpacket
        if packet in _DOTS:
            a, b = args[_DOTS[packet]], args[_DOTS[packet] + 1]
            self.flops += 2.0 * out.numel() * a.shape[-1]
            nbytes = _nbytes(a) + _nbytes(b) + _nbytes(out)
            self.hbm_bytes += nbytes
            if self._attn:
                self.attn_tile_bytes += nbytes
        elif packet in _MOVES and func not in _ELEMENTWISE and \
                not _is_convert(packet, args, out):
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in _tensors(out))
        self._track(out)

    def _track(self, out) -> None:
        grew = False
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._excluded:
                continue
            held = self._live.get(key)
            if held is not None:
                if not held[0].expired():
                    continue
                self._live_bytes -= held[1]  # a freed storage's address, reused
            n = st.nbytes()
            self._live[key] = (StorageWeakRef(st), n)
            self._live_bytes += n
            grew = True
        if grew and self._live_bytes > self.peak_bytes:
            # the sum still holds storages freed since the last sweep;
            # sweep only when it could be a new peak
            for key in [k for k, (ref, _) in self._live.items()
                        if ref.expired()]:
                self._live_bytes -= self._live.pop(key)[1]
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def _tag_backward(self, out, operands) -> None:
        """Tag the dots of an attention einsum's backward: the autograd
        nodes between `out` and its operands that run a product."""
        stop = {t.grad_fn for t in operands if isinstance(t, torch.Tensor)}
        todo, seen = [out.grad_fn], set()
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen:
                continue
            seen.add(node)
            if "mm" in node.name().lower():
                node.register_prehook(self._enter_attn)
                node.register_hook(self._leave_attn)
            todo.extend(n for n, _ in node.next_functions)

    def _enter_attn(self, grad_outputs):
        self._attn += 1

    def _leave_attn(self, grad_inputs, grad_outputs):
        self._attn -= 1


def _is_convert(packet, args, out) -> bool:
    """A copy across dtypes: XLA's `convert`, fused."""
    if packet is aten.copy_:
        return args[1].dtype != args[0].dtype
    return packet is aten._to_copy and args[0].dtype != out.dtype


def analyze(fn, *args, meshes=(), **kwargs) -> HLOAnalysis:
    """The counts of one run of `fn(*args, **kwargs)` under a `Recorder`
    over `meshes`; run it under the caller's `FakeTensorMode` to count
    without data or device work."""
    with Recorder(*meshes) as rec:
        fn(*args, **kwargs)
    return rec.analysis()
