"""Determinism linter: AST checks for nondeterminism leaking into the
deterministic modules (the JAX package's `repro/analysis/staticcheck/
linter.py`, its rules extended to torch's process-global RNG, over the
port's tier map `repro_torch.analysis.staticcheck.tiers`).

Every invariant the runtime promises — content-keyed `ResultStore` re-runs,
segment-checkpoint resume, shard-merge bit-identity, seeded fault
injection — breaks the moment wall-clock time, process-global RNG, or
hash-order-dependent iteration reaches a metric, a trace, or a content key.
This pass proves their absence statically instead of waiting for a golden
test to catch the regression.

Rules (IDs are what pragmas and reports use):

* ``wall-clock`` — reading the wall clock (`time.time`, `time.perf_counter`,
  `datetime.now`, ...) in a deterministic-tier module.
* ``unseeded-rng`` — process-global RNG (`random.random`,
  `np.random.rand`, `random.seed`, `torch.manual_seed`, `torch.seed`, and
  torch's samplers `rand`/`randn`/`randint`/`randperm`/`normal`/
  `bernoulli`/`multinomial` without a ``generator=``) or
  constructing a generator without an explicit seed
  (`np.random.default_rng()`); seeded construction (`default_rng(0)`,
  `SeedSequence([s, k])`, `jax.random.*` which always takes a key, a
  torch sampler given a `torch.Generator`) is fine.
* ``id-hash`` — `id()` / builtin `hash()` feeding a key (assigned to a
  ``*key*``-named variable or used inside a ``*key*``/``*hash*``-named
  function): both are interpreter-run-local and must never reach a content
  key or anything serialized.
* ``iter-order`` — iterating a set (or materializing one via
  `list`/`tuple`/`join`) where the order can flow onward; set order
  depends on `PYTHONHASHSEED`.  `sorted(set(...))` is the fix and is not
  flagged.
* ``unpicklable-submit`` — a lambda / nested function passed to a
  ``submit``-like call: it will not survive the spawn-based
  `ProcessExecutor` pickle boundary.
* ``bad-pragma`` — a ``# staticcheck:`` comment that does not name a known
  rule: every suppression must be auditable by rule ID.

Intentional uses are suppressed with a same-line (or preceding
comment-line) pragma — ``# staticcheck: allow(<rule>)`` — which keeps them
visible: suppressed violations are still reported as *allowed*.

    >>> vs = lint_source("import time\\nt0 = time.time()\\n",
    ...                  tier="deterministic")
    >>> [(v.rule, v.line) for v in vs]
    [('wall-clock', 2)]
    >>> lint_source("import time\\n"
    ...             "t0 = time.time()  # staticcheck: allow(wall-clock)\\n",
    ...             tier="deterministic")[0].allowed
    True
    >>> lint_source("import time\\nt0 = time.time()\\n", tier="realtime")
    []
    >>> [v.rule for v in lint_source("import torch\\nx = torch.randn(3)\\n",
    ...                              tier="realtime")]
    ['unseeded-rng']
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

from repro_torch.analysis.staticcheck.tiers import rule_applies, tier_of_path

RULES: dict[str, str] = {
    "wall-clock": "wall-clock read in a deterministic-tier module",
    "unseeded-rng": "process-global or unseeded RNG",
    "id-hash": "id()/hash() feeding a key (interpreter-run-local values)",
    "iter-order": "set iteration order can flow onward (PYTHONHASHSEED)",
    "unpicklable-submit": "lambda/nested def crossing a process boundary",
    "bad-pragma": "staticcheck pragma without a known rule ID",
    "parse-error": "file does not parse",
}

_PRAGMA_MARK = re.compile(r"#\s*staticcheck\s*:")
_PRAGMA_ALLOW = re.compile(r"#\s*staticcheck\s*:\s*allow\(([^)]*)\)")

_WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns", "time.clock_gettime", "time.clock_gettime_ns",
    "time.localtime", "time.gmtime", "time.asctime", "time.ctime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

# stdlib `random` module-level functions drawing from the process-global
# Mersenne Twister (plus `seed`, which mutates that shared state)
_PY_GLOBAL_RNG = frozenset({
    "seed", "random", "randint", "randrange", "getrandbits", "randbytes",
    "choice", "choices", "shuffle", "sample", "uniform", "triangular",
    "betavariate", "expovariate", "gammavariate", "gauss", "lognormvariate",
    "normalvariate", "vonmisesvariate", "paretovariate", "weibullvariate",
})
# numpy legacy global-state samplers (`np.random.rand` et al.)
_NP_GLOBAL_RNG = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "bytes", "uniform",
    "normal", "standard_normal", "poisson", "beta", "binomial",
    "exponential", "gamma", "zipf", "geometric", "laplace", "logistic",
    "lognormal", "multinomial", "pareto", "power", "rayleigh", "wald",
    "weibull", "triangular", "vonmises", "chisquare", "dirichlet", "f",
    "gumbel", "hypergeometric", "logseries", "negative_binomial",
    "noncentral_chisquare", "noncentral_f", "standard_cauchy",
    "standard_exponential", "standard_gamma", "standard_t",
})
# torch: mutators/readers of the process-global generator, and samplers
# that draw from it unless given `generator=`
_TORCH_GLOBAL_SEED = frozenset({"manual_seed", "seed"})
_TORCH_SAMPLERS = frozenset({"rand", "randn", "randint", "randperm",
                             "normal", "bernoulli", "multinomial"})
# generator/seed constructors: fine *with* an explicit seed argument,
# flagged when called with no arguments (OS-entropy seeded)
_SEEDABLE_CTORS = frozenset({
    "random.Random", "numpy.random.default_rng", "numpy.random.RandomState",
    "numpy.random.SeedSequence", "numpy.random.PCG64", "numpy.random.MT19937",
    "numpy.random.Philox", "numpy.random.SFC64",
})
# unconditionally entropy-backed
_ENTROPY = frozenset({
    "os.urandom", "uuid.uuid1", "uuid.uuid4", "random.SystemRandom",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbelow", "secrets.choice", "secrets.randbits",
})

_KEYISH = re.compile(r"key|hash|digest|fingerprint", re.IGNORECASE)
_SUBMITTERS = frozenset({"submit", "apply_async", "map_async",
                         "starmap_async"})
# order-insensitive consumers: a set flowing into these is harmless
_SET_CONSUMERS = frozenset({"list", "tuple", "iter", "enumerate"})


@dataclasses.dataclass(frozen=True)
class Violation:
    """One lint finding; `allowed=True` means a pragma suppresses it."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    allowed: bool = False

    def format(self) -> str:
        mark = " [allowed]" if self.allowed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}{mark}"


class _Aliases:
    """Import-alias resolution: local name -> canonical dotted prefix."""

    def __init__(self) -> None:
        self._map: dict[str, str] = {}

    def add_import(self, node: ast.Import) -> None:
        for a in node.names:
            self._map[(a.asname or a.name.split(".")[0])] = \
                a.name if a.asname else a.name.split(".")[0]

    def add_import_from(self, node: ast.ImportFrom) -> None:
        if node.level or not node.module:   # relative imports: repo-local
            return
        base = node.module
        # `from datetime import datetime` must canonicalize to the class
        for a in node.names:
            self._map[a.asname or a.name] = f"{base}.{a.name}"

    def resolve(self, dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        head = self._map.get(head, head)
        return f"{head}.{rest}" if rest else head


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.AST, aliases: _Aliases) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        return name is not None and \
            aliases.resolve(name) in ("set", "frozenset")
    return False


class _Scope:
    """One function (or module) scope: names that pickle cannot ship."""

    def __init__(self, is_module: bool):
        self.is_module = is_module
        self.unpicklable: set[str] = set()   # nested defs + lambda names


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, aliases: _Aliases):
        self.path = path
        self.aliases = aliases
        self.found: list[tuple[int, int, str, str]] = []
        self._funcs: list[str] = []          # enclosing function names
        self._targets: list[list[str]] = []  # active assignment targets
        self._scopes: list[_Scope] = [_Scope(is_module=True)]

    # ---- bookkeeping -----------------------------------------------------
    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.found.append((node.lineno, node.col_offset, rule, message))

    def visit_Import(self, node: ast.Import) -> None:
        self.aliases.add_import(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self.aliases.add_import_from(node)

    def _visit_func(self, node) -> None:
        if not self._scopes[-1].is_module:
            self._scopes[-1].unpicklable.add(node.name)
        self._funcs.append(node.name)
        self._scopes.append(_Scope(is_module=False))
        self.generic_visit(node)
        self._scopes.pop()
        self._funcs.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node: ast.Assign) -> None:
        names = []
        for t in node.targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    names.append(sub.id)
        if isinstance(node.value, ast.Lambda):
            self._scopes[-1].unpicklable.update(names)
        self._targets.append(names)
        self.visit(node.value)
        self._targets.pop()

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        names = [node.target.id] if isinstance(node.target, ast.Name) else []
        self._targets.append(names)
        if node.value is not None:
            self.visit(node.value)
        self._targets.pop()

    # ---- rule checks -----------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        canon = self.aliases.resolve(name) if name else None
        if canon:
            self._check_wall_clock(node, canon)
            self._check_rng(node, canon)
            self._check_id_hash(node, canon)
            self._check_set_consumer(node, canon)
        self._check_join(node)
        self._check_submit(node)
        self.generic_visit(node)

    def _check_wall_clock(self, node: ast.Call, canon: str) -> None:
        if canon in _WALL_CLOCK:
            self._flag(node, "wall-clock",
                       f"{canon}() reads the wall clock; deterministic "
                       "paths must not observe real time")

    def _check_rng(self, node: ast.Call, canon: str) -> None:
        if canon.startswith("jax.random."):
            return                       # key-passing API: always explicit
        if canon in _ENTROPY:
            self._flag(node, "unseeded-rng",
                       f"{canon}() draws OS entropy; derive randomness "
                       "from an explicit seed instead")
            return
        mod, _, fn = canon.rpartition(".")
        if mod == "random" and fn in _PY_GLOBAL_RNG:
            self._flag(node, "unseeded-rng",
                       f"random.{fn}() uses the process-global RNG; use a "
                       "seeded random.Random/np.random.default_rng")
            return
        if mod == "numpy.random" and fn in _NP_GLOBAL_RNG:
            self._flag(node, "unseeded-rng",
                       f"np.random.{fn}() uses numpy's legacy global "
                       "state; use a seeded np.random.default_rng")
            return
        if mod in ("torch", "torch.random") and fn in _TORCH_GLOBAL_SEED:
            self._flag(node, "unseeded-rng",
                       f"torch.{fn}() touches torch's process-global "
                       "generator; use a seeded torch.Generator")
            return
        if mod == "torch" and fn in _TORCH_SAMPLERS and not any(
                k.arg == "generator" for k in node.keywords):
            self._flag(node, "unseeded-rng",
                       f"torch.{fn}() without generator= draws from torch's "
                       "process-global generator; pass a seeded "
                       "torch.Generator")
            return
        if canon in _SEEDABLE_CTORS and not node.args and not node.keywords:
            self._flag(node, "unseeded-rng",
                       f"{canon}() without a seed argument is seeded from "
                       "OS entropy; pass an explicit seed")

    def _check_id_hash(self, node: ast.Call, canon: str) -> None:
        if canon not in ("id", "hash"):
            return
        keyish_target = any(_KEYISH.search(n)
                            for ns in self._targets for n in ns)
        keyish_func = any(_KEYISH.search(f) for f in self._funcs)
        if keyish_target or keyish_func:
            self._flag(node, "id-hash",
                       f"{canon}() is interpreter-run-local; it must not "
                       "feed a key (content keys must survive restarts)")

    def _check_set_consumer(self, node: ast.Call, canon: str) -> None:
        if canon in _SET_CONSUMERS and node.args \
                and _is_set_expr(node.args[0], self.aliases):
            self._flag(node, "iter-order",
                       f"{canon}() over a set materializes hash order; "
                       "wrap the set in sorted(...)")

    def _check_join(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and node.func.attr == "join" \
                and node.args and _is_set_expr(node.args[0], self.aliases):
            self._flag(node, "iter-order",
                       "join() over a set serializes hash order; "
                       "wrap the set in sorted(...)")

    def _check_submit(self, node: ast.Call) -> None:
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SUBMITTERS):
            return
        args = list(node.args) + [k.value for k in node.keywords]
        for arg in args:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Lambda):
                    self._flag(sub, "unpicklable-submit",
                               "lambda cannot cross the spawn-based "
                               "process-pool pickle boundary")
            if isinstance(arg, ast.Name) and any(
                    arg.id in s.unpicklable for s in self._scopes):
                self._flag(arg, "unpicklable-submit",
                           f"'{arg.id}' is a nested def/lambda; only "
                           "module-level callables pickle across workers")

    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter, self.aliases):
            self._flag(node.iter, "iter-order",
                       "iterating a set yields hash order; iterate "
                       "sorted(...) instead")
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_comprehension_iter(self, comp: ast.comprehension) -> None:
        if _is_set_expr(comp.iter, self.aliases):
            self._flag(comp.iter, "iter-order",
                       "comprehension over a set yields hash order; "
                       "iterate sorted(...) instead")

    def generic_visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp,
                             ast.SetComp)):
            for comp in node.generators:
                self.visit_comprehension_iter(comp)
        super().generic_visit(node)


def _pragmas(source: str) -> tuple[dict[int, set[str]], list[tuple[int, str]]]:
    """(line -> allowed rules, bad pragmas).  A pragma on a comment-only
    line also covers the next line (long statements push pragmas up).
    Only real COMMENT tokens count — a docstring *describing* the pragma
    syntax is not a pragma."""
    allow: dict[int, set[str]] = {}
    bad: list[tuple[int, str]] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return allow, bad                    # unparsable: parse-error covers it
    for tok in tokens:
        if tok.type != tokenize.COMMENT or not _PRAGMA_MARK.search(tok.string):
            continue
        lineno, line = tok.start[0], tok.string
        m = _PRAGMA_ALLOW.search(line)
        rules = {r.strip() for r in m.group(1).split(",")} - {""} \
            if m else set()
        unknown = sorted(r for r in rules if r not in RULES)
        if m is None or not rules or unknown:
            what = f"unknown rule(s) {', '.join(unknown)}" if unknown \
                else "no rule ID"
            bad.append((lineno, f"staticcheck pragma with {what}; use "
                                "'# staticcheck: allow(<rule>)'"))
            continue
        allow.setdefault(lineno, set()).update(rules)
        if tok.line.strip().startswith("#"):  # comment-only line: covers next
            allow.setdefault(lineno + 1, set()).update(rules)
    return allow, bad


def lint_source(source: str, path: str = "<string>",
                tier: str | None = None) -> list[Violation]:
    """Lint one module's source; `tier` defaults from the path."""
    tier = tier or tier_of_path(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 1, e.offset or 0,
                          "parse-error", str(e.msg))]
    linter = _Linter(path, _Aliases())
    linter.visit(tree)
    allow, bad = _pragmas(source)
    out = [Violation(path, line, 0, "bad-pragma", msg)
           for line, msg in bad]
    for line, col, rule, message in linter.found:
        if not rule_applies(rule, tier):
            continue
        out.append(Violation(path, line, col, rule, message,
                             allowed=rule in allow.get(line, ())))
    out.sort(key=lambda v: (v.line, v.col, v.rule))
    return out


def iter_python_files(paths) -> list[str]:
    """Expand files/directories into a sorted list of ``.py`` paths."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        else:
            files.append(p)
    return files


def lint_paths(paths, tier: str | None = None) -> list[Violation]:
    """Lint every ``.py`` file under `paths` (tier resolved per file
    unless forced)."""
    out: list[Violation] = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        out += lint_source(source, path=path, tier=tier)
    return out
