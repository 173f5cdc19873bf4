"""The device channel (`repro_torch.obs.realtime.device_tracer`) at the
port's serving and training sites, on the CPU at tiny sizes.

Off (no profiler recording) every site gets `NULL_TRACER`, and a serve
wave and a train step dispatch exactly the ops they dispatch with the
sites taken out of the code (`_StripSites`): tracing off adds no op, no
kernel and no read-back.  Tokens, loss, parameters and moments are bit-identical on and
off.  On, the profiler's events hold the spans a wave and a step make,
nested as the sites lie, and the counters hold the prefill's positions
and kept tokens and the MoE rows routed and dropped and its slots.
"""
import __future__
import ast
import collections
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.models import layers as layers_mod
from repro_torch.models import transformer as tfm_mod
from repro_torch.models import zoo
from repro_torch.models.layers import moe_local
from repro_torch.models.module import init_from_specs, tree_leaves
from repro_torch.obs import NULL_TRACER
from repro_torch.obs.realtime import DEVICE_TRACER, device_tracer
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)

SLOTS, PROMPT, MAX_NEW = 2, 16, 4
LENGTHS = (5, 16, 23)           # the last kept to PROMPT; wave 2 one slot


def _cfg(arch="deepseek-moe-16b"):
    return reduce_config(ARCHS[arch])


def _params(cfg):
    return init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(1, cfg.vocab, n),
                    max_new_tokens=MAX_NEW) for n in LENGTHS]


def _serve(cfg):
    """Two waves (2 slots, then 1 of 2) through a fresh engine: tokens."""
    eng = ServeEngine(cfg, _params(cfg), batch_slots=SLOTS,
                      max_len=PROMPT + MAX_NEW, prompt_len=PROMPT,
                      device="cpu")
    return [r.out_tokens for r in eng.serve(_requests(cfg))]


def _train(cfg):
    """One step from fresh weights: loss, parameters, moments."""
    scfg = TrainStepConfig()
    params = _params(cfg)
    step = make_train_step(cfg, None, scfg)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, PROMPT), generator=g)
             for k in ("tokens", "labels")}
    params, state, m = step(params, init_train_state(cfg, params, scfg),
                            batch)
    return [m["loss"]] + tree_leaves(params) + tree_leaves(state["m"]) + \
        tree_leaves(state["v"])


RUNS = {"serve": _serve, "train": _train}


@pytest.fixture(autouse=True)
def fresh_counters():
    DEVICE_TRACER.reset()
    yield
    DEVICE_TRACER.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_device_tracer_follows_the_profiler():
    assert device_tracer() is NULL_TRACER
    with _recording():
        assert device_tracer() is DEVICE_TRACER
    assert device_tracer() is NULL_TRACER
    assert DEVICE_TRACER.span("serve.prefill", wave=3).args == "wave=3"


class _Ops(TorchDispatchMode):
    """The ops dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


class _StripSites(ast.NodeTransformer):
    """A function's code with the device channel's sites taken out: a
    `with <tracer>.span(...)` keeps its body, a `<tracer>.count(...)`
    statement and a `tr = device_tracer()` go."""

    def visit_With(self, node):
        self.generic_visit(node)
        expr = node.items[0].context_expr
        if len(node.items) == 1 and isinstance(expr, ast.Call) and \
                getattr(expr.func, "attr", None) == "span":
            return node.body
        return node

    def visit_Expr(self, node):
        call = node.value
        if isinstance(call, ast.Call) and \
                getattr(call.func, "attr", None) == "count":
            return None
        return node

    def visit_Assign(self, node):
        return None if ast.unparse(node.value) == "device_tracer()" else node


def _strip_sites(monkeypatch) -> list:
    """Every function or method of the instrumented modules that reaches
    the device channel, replaced by its code without the sites (compiled
    against its module's names, where every such function is the stripped
    one too); their names."""
    stripped, spaces = {}, []
    modules = (engine_mod, layers_mod, train_step_mod, tfm_mod, zoo)
    for mod in modules:
        tree = ast.parse(inspect.getsource(mod))
        found = []
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                found.append((mod, node))
            elif isinstance(node, ast.ClassDef):
                found += [(getattr(mod, node.name), f) for f in node.body
                          if isinstance(f, ast.FunctionDef)]
        for owner, fn in found:
            if "device_tracer" not in ast.unparse(fn):
                continue
            fn = ast.fix_missing_locations(_StripSites().visit(fn))
            assert "device_tracer" not in ast.unparse(fn)
            ns = dict(vars(mod))
            exec(compile(ast.Module(body=[fn], type_ignores=[]),
                         inspect.getsourcefile(mod), "exec",
                         flags=__future__.annotations.compiler_flag,
                         dont_inherit=True), ns)
            stripped[getattr(owner, fn.name)] = ns[fn.name]
            monkeypatch.setattr(owner, fn.name, ns[fn.name])
            spaces.append(ns)
    for mod in modules:         # names imported from another module
        for name, value in list(vars(mod).items()):
            if callable(value) and value in stripped:
                monkeypatch.setattr(mod, name, stripped[value])
    for ns in spaces:
        for name, value in ns.items():
            if callable(value) and value in stripped:
                ns[name] = stripped[value]
    return sorted(f.__name__ for f in stripped.values())


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tracing_off_dispatches_no_op_of_its_own(run, monkeypatch):
    """With no profiler recording, a wave and a step dispatch the ops they
    dispatch with the sites removed, in the same order."""
    cfg = _cfg()
    assert device_tracer() is NULL_TRACER
    with _Ops() as off:
        RUNS[run](cfg)
    assert _strip_sites(monkeypatch) == [
        "_ce", "_logits", "apply_layer", "blocked_attention", "decode_once",
        "make_train_step", "moe_local", "prefill_step", "readback"]
    with _Ops() as removed:
        RUNS[run](cfg)
    assert off.ops == removed.ops


@pytest.mark.parametrize("run", sorted(RUNS))
def test_outputs_bit_identical_with_the_profiler_on(run):
    cfg = _cfg()
    off = RUNS[run](cfg)
    with _recording():
        on = RUNS[run](cfg)
    if run == "serve":
        assert on == off
    else:
        assert len(on) == len(off)
        for a, b in zip(on, off):
            assert torch.equal(a, b)


def _spans(prof) -> list:
    """(name, start, end) of the device channel's spans, by start."""
    prefixes = ("serve.", "train.", "model.")
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefixes)), key=lambda x: x[1])


def _inside(child, parents) -> bool:
    return any(s <= child[1] and child[2] <= e for _, s, e in parents)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-3b"])
def test_a_wave_makes_its_spans(arch):
    cfg = _cfg(arch)
    with _recording() as prof:
        _serve(cfg)
    spans = _spans(prof)
    by = collections.defaultdict(list)
    for sp in spans:
        by[sp[0]].append(sp)
    waves = 2
    assert len(by["serve.prefill"]) == waves
    assert len(by["serve.decode"]) == waves * (MAX_NEW - 1)
    assert len(by["serve.readback"]) == waves * MAX_NEW
    phases = by["serve.prefill"] + by["serve.decode"]
    for name in ("model.mixer", "model.ffn", "model.head"):
        assert by[name] and all(_inside(sp, phases) for sp in by[name])
    assert len(by["model.mixer"]) == cfg.n_layers * len(phases)
    assert len(by["model.head"]) == len(phases)
    # the phases follow one another on the driving thread
    top = sorted(phases + by["serve.readback"], key=lambda x: x[1])
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))


def test_a_step_makes_its_spans():
    cfg = _cfg()
    with _recording() as prof:
        _train(cfg)
        _train(cfg)
    spans = _spans(prof)
    by = collections.defaultdict(list)
    for sp in spans:
        by[sp[0]].append(sp)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert len(by[name]) == 2
    for fwd, bwd, opt in zip(by["train.forward"], by["train.backward"],
                             by["train.optimizer"]):
        assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    forward = by["train.forward"]
    passes = forward + by["train.backward"]      # remat recomputes there
    assert all(_inside(sp, passes) for sp in by["model.mixer"])
    assert sum(_inside(sp, forward) for sp in by["model.mixer"]) == \
        2 * cfg.n_layers
    assert all(_inside(sp, forward) for sp in by["model.head"])


def test_prefill_counters_count_positions_and_kept_tokens():
    cfg = _cfg()
    with _recording():
        _serve(cfg)
    counters = DEVICE_TRACER.snapshot()["counters"]
    waves = -(-len(LENGTHS) // SLOTS)
    assert counters["serve.prefill_positions"] == waves * SLOTS * PROMPT
    assert counters["serve.prefill_tokens"] == \
        sum(min(n, PROMPT) for n in LENGTHS)


@pytest.mark.parametrize("n", [16, 64])
def test_moe_rows_dropped_on_one_set_of_experts(n):
    """Identical tokens route to the same top_k experts: each gets n rows
    against its capacity C, so top_k x (n - C) rows are dropped."""
    E, D, F, top_k, cf = 8, 16, 32, 2, 1.25
    g = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(D, E, generator=g),
              "gate": torch.randn(E, D, F, generator=g),
              "up": torch.randn(E, D, F, generator=g),
              "down": torch.randn(E, F, D, generator=g)}
    x = torch.randn(1, 1, D, generator=g).expand(2, n // 2, D)
    C = max(8, int(np.ceil(n * top_k * cf / E)))
    with _recording():
        moe_local(params, x, top_k=top_k, capacity_factor=cf)
    counters = DEVICE_TRACER.snapshot()["counters"]
    assert counters["moe.rows_routed"] == n * top_k
    assert counters["moe.rows_dropped"] == top_k * (n - C)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_slots_counted_once_a_capacity_call(impl):
    """`moe.slots` adds E x C at each call of the capacity path (C from
    that call's token count) and nothing on the ragged path."""
    E, D, F, top_k, cf = 8, 16, 32, 2, 1.25
    g = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(D, E, generator=g),
              "gate": torch.randn(E, D, F, generator=g),
              "up": torch.randn(E, D, F, generator=g),
              "down": torch.randn(E, F, D, generator=g)}
    sizes = (16, 64)
    with _recording():
        for n in sizes:
            moe_local(params, torch.randn(1, n, D, generator=g),
                      top_k=top_k, capacity_factor=cf, impl=impl)
    counters = DEVICE_TRACER.snapshot()["counters"]
    if impl == "ragged":
        assert "moe.slots" not in counters
        return
    assert counters["moe.slots"] == sum(
        E * max(8, int(np.ceil(n * top_k * cf / E))) for n in sizes)
    kept = counters["moe.rows_routed"] - counters["moe.rows_dropped"]
    assert 0 < kept <= counters["moe.slots"]
