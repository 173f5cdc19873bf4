"""The serving cells: a closed loop of clients over the program's
`ServeEngine.serve`, and the comparison of what it served.

Each round, every client sends one request and the harness hands the wave
(one request a client) to `serve`.  Prompt lengths come from a fixed pool
(the traffic file's clipped log-normal at evenly spaced quantiles), dealt
in an order drawn from the seed, so every seed serves the same set of
lengths; the tokens are drawn from the seed.  Between rounds the engine's
cache tensors are zeroed in place, so each wave starts from empty caches
and recurrent state.

`serve` returns only tokens, so the harness wraps the module attributes
`zoo.prefill` and `zoo.decode_step` that the engine calls: the entry of a
wave's first decode step is the moment its first tokens reached the host
(the engine reads them back just before), and in a traced run the prefill
is synchronised on both sides and timed.

The comparison (`served_gap`): after the window, a sample of whole waves
drawn from the seed, always with the wave that holds the longest prompt,
is run through the plain reference over each left-padded prompt and the
tokens fed back; for every served token, the amount by which the
reference's logit of it lies below the reference's best logit.

Over several cards (a configuration with a `mesh`; `harness/ranks.py`)
every rank builds the engine with the mesh from its own blocks of the
weights (`weights.rank_blocks`), deals the same prompts from the seed,
and starts a wave when rank 0 says so.  The engine of the port cuts the
whole tree it is given (`sharding.rules.shard_tree`); while it is built
from blocks, `blocks_as_given` puts in its place a function that keeps
them.  Rank 0 compares after the window: the reference draws the weights
again and gets every card of the cell (`readings`' `devices`); a
reference that defines `serve_logits_by_leaf` draws each piece itself
(`weights.piece`) and may spread its layers over those cards.
"""
from __future__ import annotations

import contextlib
import functools
import math
import statistics
import time

import numpy as np
import torch

from harness import ranks, spec
from harness.device import free, peak_bytes, start_profiler, sync
from harness.weights import model_weights, piece, rank_blocks, tensors

clock = time.perf_counter


def length_pool(traffic: dict) -> list:
    """The prompt lengths every seed deals from: the log-normal's quantiles
    at (i + 1/2) / n, clipped to [prompt_min, prompt_len]."""
    n = traffic["length_pool"]
    dist = statistics.NormalDist()
    return [int(min(max(round(traffic["length_median"] * math.exp(
        traffic["length_sigma"] * dist.inv_cdf((i + 0.5) / n))),
        traffic["prompt_min"]), traffic["prompt_len"])) for i in range(n)]


class Feed:
    """The clients' prompts, from the seed."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.rng = np.random.default_rng([seed, 1])
        self.pool = length_pool(traffic)
        self.vocab = vocab
        self.order: list = []

    def wave(self, n: int) -> list:
        out = []
        for _ in range(n):
            if not self.order:
                self.order = [int(x) for x in self.rng.permutation(
                    self.pool)]
            out.append(self.rng.integers(1, self.vocab, size=self.order.pop(),
                                         dtype=np.int64))
        return out


def padded(prompts: list, prompt_len: int) -> np.ndarray:
    """The prompts left-padded with token 0 to prompt_len, as the engine
    lays a wave out."""
    out = np.zeros((len(prompts), prompt_len), np.int64)
    for i, p in enumerate(prompts):
        p = p[-prompt_len:]
        out[i, prompt_len - len(p):] = p
    return out


class Hooks:
    """Wraps `zoo.prefill` and `zoo.decode_step` while entered: each decode
    step's entry time, and with `traced` the prefill synchronised, timed
    and the calls marked as "chipbench.prefill" / "chipbench.decode"."""

    def __init__(self, zoo, device, traced: bool):
        self.zoo, self.device, self.traced = zoo, device, traced
        self.decode_entries: list = []
        self.prefill_s: list = []

    def __enter__(self):
        zoo, prefill, decode = self.zoo, self.zoo.prefill, \
            self.zoo.decode_step
        self.saved = (prefill, decode)
        mark = torch.profiler.record_function if self.traced else \
            (lambda _: contextlib.nullcontext())

        def timed_prefill(*a, **kw):
            with mark("chipbench.prefill"):
                if self.traced:
                    sync(self.device)
                t0 = clock()
                out = prefill(*a, **kw)
                if self.traced:
                    sync(self.device)
                    self.prefill_s.append(clock() - t0)
            return out

        def timed_decode(*a, **kw):
            self.decode_entries.append(clock())
            with mark("chipbench.decode"):
                return decode(*a, **kw)

        zoo.prefill, zoo.decode_step = timed_prefill, timed_decode
        return self

    def __exit__(self, *exc):
        self.zoo.prefill, self.zoo.decode_step = self.saved
        return False


@contextlib.contextmanager
def blocks_as_given(mesh):
    """While entered with a mesh, the engine keeps the tree it is given,
    which holds this rank's blocks, instead of cutting it again."""
    if mesh is None:
        yield
        return
    from repro_torch.serve import engine
    cut = engine.shard_tree
    engine.shard_tree = lambda tree, shardings: tree
    try:
        yield
    finally:
        engine.shard_tree = cut


class Program:
    """The engine of one run, built from the seed, warmed up on the cell's
    own shapes; with `mesh`, this rank's part of it."""

    def __init__(self, cell, seed: int, device, traced: bool, mesh=None):
        from repro_torch.models import zoo
        from repro_torch.models.transformer import param_shardings
        from repro_torch.serve.engine import ServeEngine
        self.cell, self.seed, self.device, self.traced = cell, seed, device, \
            traced
        self.mesh, self.lockstep_s = mesh, []
        tr = cell.traffic
        self.arch = spec.arch_config(cell.config)
        if mesh is None:
            self.params = model_weights(cell.config, device)
        else:
            self.params = rank_blocks(cell.config,
                                      param_shardings(self.arch, mesh), device)
        with blocks_as_given(mesh):
            self.engine = ServeEngine(
                self.arch, self.params, mesh=mesh,
                batch_slots=tr["batch_slots"],
                max_len=tr["prompt_len"] + tr["new_tokens"],
                prompt_len=tr["prompt_len"], device=device)
        self.feed = Feed(tr, self.arch.vocab, seed)
        self.hooks = Hooks(zoo, device, traced)
        for _ in range(tr["warmup_waves"]):
            self.round()
        if mesh is not None:    # the default group's first collective
            ranks.agree(True, device)
        sync(device)
        self.hooks.prefill_s.clear()

    def more(self, more: bool) -> bool:
        """Whether another wave starts: this process's answer on one rank,
        rank 0's on every rank of a mesh (one broadcast, timed)."""
        if self.mesh is None:
            return more
        t = clock()
        more = ranks.agree(more, self.device)
        self.lockstep_s.append(clock() - t)
        return more

    def round(self, profiled: bool = False) -> dict:
        from repro_torch.serve.engine import Request
        tr = self.cell.traffic
        prompts = self.feed.wave(tr["clients"])
        reqs = [Request(prompt=p, max_new_tokens=tr["new_tokens"])
                for p in prompts]
        for t in tensors(self.engine.caches):
            t.zero_()
        self.hooks.decode_entries = []
        n_prefill = len(self.hooks.prefill_s)
        with self.hooks:
            send = clock()
            self.engine.serve(reqs)
            done = clock()
        entries = self.hooks.decode_entries
        return {"send": send, "done": done,
                "first": entries[0] if entries else done,
                "decode_entries": entries,
                "prefill_s": (self.hooks.prefill_s[n_prefill]
                              if len(self.hooks.prefill_s) > n_prefill
                              else None),
                "profiled": profiled,
                "lengths": [len(p) for p in prompts],
                "prompts": prompts,
                "out": [list(r.out_tokens) for r in reqs]}

    def window(self, seconds: float, t_start: float):
        """Rounds until `seconds` have passed; the window closes when the
        last round started in it has finished.  A traced run profiles the
        rounds `trace_from` .. `trace_from + trace_waves - 1`."""
        from harness.record import Run
        from harness.trace import WINDOW, Trace
        tr = self.cell.traffic
        waves, trace, prof = [], None, None
        t0 = clock()
        setup_s = t0 - t_start
        while self.more(clock() - t0 < seconds or
                        (self.traced and trace is None)):
            i = len(waves)
            profiled = self.traced and \
                tr["trace_from"] <= i < tr["trace_from"] + tr["trace_waves"]
            if profiled and prof is None:
                prof = start_profiler()
                if self.mesh is not None:   # every rank's profiler is on
                    ranks.agree(True, self.device)
                span = torch.profiler.record_function(WINDOW)
                span.__enter__()
            waves.append(self.round(profiled))
            if prof is not None and i == tr["trace_from"] + \
                    tr["trace_waves"] - 1:
                sync(self.device)
                span.__exit__(None, None, None)
                prof.stop()
                trace = Trace.from_profiler(prof)
                prof = None
        t1 = clock()
        return Run(kind="serve", config=self.cell.config, traffic=tr,
                   setup_s=setup_s, window=(t0, t1), waves=waves,
                   trace=trace, peak_bytes=peak_bytes(self.device),
                   lockstep_s=self.lockstep_s)

    def close(self) -> None:
        del self.engine, self.params
        free(self.device)


def sample_waves(waves: list, seed: int, n: int) -> list:
    """`n` of the finished waves, drawn from the seed, always with the one
    holding the longest prompt."""
    longest = max(range(len(waves)), key=lambda i: max(waves[i]["lengths"]))
    rest = [i for i in range(len(waves)) if i != longest]
    rng = np.random.default_rng([seed, 2])
    picked = [longest] + [int(i) for i in rng.choice(
        rest, size=min(n - 1, len(rest)), replace=False)]
    return [waves[i] for i in sorted(picked)]


def wave_tokens(wave: dict, prompt_len: int) -> np.ndarray:
    """A wave's served sequences: the padded prompts, then every served
    token but the last (each fed back to the model)."""
    out = np.asarray(wave["out"], np.int64)
    return np.concatenate([padded(wave["prompts"], prompt_len),
                           out[:, :-1]], axis=1)


def streamed(cell) -> bool:
    """Whether the reference draws each piece of the weights itself: a
    configuration with a `mesh` whose reference defines
    `serve_logits_by_leaf`."""
    return bool(cell.config.get("mesh")) and hasattr(
        spec.reference(cell.config), "serve_logits_by_leaf")


def reference_logits(cell, params, wave, devices, prec):
    """The reference's logits of a wave; `params` the whole tree on
    `devices[0]`, or None where the reference draws its pieces
    (`serve_logits_by_leaf(config, draw, tokens, prompt_len, prec,
    devices)`, `draw(path, device, layer)` as `weights.piece`)."""
    ref = spec.reference(cell.config)
    tokens = torch.as_tensor(wave_tokens(wave, cell.traffic["prompt_len"]),
                             device=devices[0])
    if params is None:
        return ref.serve_logits_by_leaf(
            cell.config, functools.partial(piece, cell.config), tokens,
            cell.traffic["prompt_len"], prec, devices)
    return ref.serve_logits(cell.config, params, tokens,
                            cell.traffic["prompt_len"], prec)


def gaps(logits, tokens) -> torch.Tensor:
    """How far each chosen token's logit lies below the best: logits
    (B, n, V), tokens (B, n)."""
    best = logits.max(dim=-1).values
    return best - torch.gather(logits, -1, tokens[..., None])[..., 0]


def readings(cell, seed: int, run, devices: list,
             control: bool = False) -> dict:
    """The numbers compared, from the sampled waves: `served_gap`, the
    widest gap of a served token, and `served_gap_mean`, the mean gap over
    the sampled served tokens; with `control`, `control_gap` and
    `control_gap_mean`, the same of the token the float8 reference puts
    first at each served position.  `devices` are the cell's (one a
    rank); the reference works on the first, or where it draws its own
    pieces, on all of them."""
    from reference import common
    common.no_tf32()
    waves = sample_waves(run.waves, seed, cell.traffic["check_waves"])
    params = None if streamed(cell) else model_weights(cell.config,
                                                       devices[0])
    served, low = [], []
    for w in waves:
        logits = reference_logits(cell, params, w, devices, common.FLOAT32)
        out = torch.as_tensor(np.asarray(w["out"]), device=logits.device)
        served.append(gaps(logits, out).flatten())
        if control:
            fp8 = reference_logits(cell, params, w, devices,
                                   common.Precision("fp8"))
            low.append(gaps(logits, fp8.argmax(-1)).flatten())
            del fp8
        del logits
    out = {}
    for name, g in (("served", served), ("control", low)):
        if g:
            g = torch.cat(g)
            out[f"{name}_gap"] = float(g.max())
            out[f"{name}_gap_mean"] = float(g.mean())
    return out


def requests_of(run) -> tuple:
    """(attempted, failed) requests of the window: a request fails that did
    not get its tokens, or got one outside the vocabulary."""
    n_new, vocab = run.traffic["new_tokens"], run.config["vocab"]
    attempted = failed = 0
    for w in run.waves:
        for out in w["out"]:
            attempted += 1
            if len(out) != n_new or not all(0 <= t < vocab for t in out):
                failed += 1
    return attempted, failed

