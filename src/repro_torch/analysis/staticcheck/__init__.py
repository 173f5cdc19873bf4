"""Static analysis of the port: machine-check the invariants the runtime
promises (the JAX package's `repro.analysis.staticcheck`).

Two passes:

* the **determinism linter** (`repro_torch.analysis.staticcheck.linter`)
  — an AST pass over ``src/repro_torch/`` proving no wall-clock reads,
  unseeded RNG (torch's process-global generator included), `id()`/
  `hash()`-fed keys, set-iteration-order leaks, or unpicklable
  process-pool submissions reach the deterministic tier (tier map in
  `repro_torch.analysis.staticcheck.tiers`), run by
  ``python -m repro_torch.tools.check_static``;
* the **schedule race detector**
  (`repro_torch.analysis.staticcheck.racecheck`) — a trace validator
  proving resource exclusivity, dependency ordering, segment-barrier
  monotonicity and memory-capacity feasibility on a recorded schedule,
  also reachable as ``ScheduleEngine.schedule(..., validate=True)``.

    >>> from repro_torch.analysis.staticcheck import lint_source
    >>> [v.rule for v in lint_source("import time\\nt = time.time()\\n",
    ...                              tier="deterministic")]
    ['wall-clock']
    >>> issubclass(TraceValidationError, ValueError)
    True
"""
from repro_torch.analysis.staticcheck.linter import (
    RULES,
    Violation,
    iter_python_files,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.staticcheck.racecheck import (
    INVARIANTS,
    TraceValidationError,
    validate_trace,
)
from repro_torch.analysis.staticcheck.tiers import (
    DETERMINISTIC,
    MODULE_TIERS,
    REALTIME,
    module_of_path,
    rule_applies,
    tier_of_module,
    tier_of_path,
)

__all__ = [
    "DETERMINISTIC", "INVARIANTS", "MODULE_TIERS", "REALTIME", "RULES",
    "TraceValidationError", "Violation", "iter_python_files", "lint_paths",
    "lint_source", "module_of_path", "rule_applies", "tier_of_module",
    "tier_of_path", "validate_trace",
]
