"""Module-tier map of the port: which determinism rules apply where (the
JAX package's `repro/analysis/staticcheck/tiers.py` over `repro_torch`).

The repo's reproducibility chain (content-keyed stores, segment-checkpoint
resume, shard-merge bit-identity, seeded fault injection) only holds for
code on the *deterministic* tier — the scheduling core, the sweep API, the
hardware model, and everything whose outputs land in a golden trace or a
persisted record.  Code on the *realtime* tier (CLI launchers that print
step timings, benchmark drivers) may read the wall clock freely; every
other rule still applies there.

Tier resolution is longest-prefix match over dotted module names, so a new
subpackage inherits the strict tier by default — loosening is an explicit
edit to `MODULE_TIERS`, reviewed like any other contract change.

    >>> tier_of_module("repro_torch.core.scheduler")
    'deterministic'
    >>> tier_of_module("repro_torch.launch.train")
    'realtime'
    >>> tier_of_path("src/repro_torch/api/session.py")
    'deterministic'
    >>> tier_of_path("benchmarks/run.py")
    'realtime'
"""
from __future__ import annotations

import os

DETERMINISTIC = "deterministic"
REALTIME = "realtime"

# longest dotted prefix wins; everything under `repro_torch` defaults to
# the deterministic tier unless an entry here loosens it.
MODULE_TIERS: tuple[tuple[str, str], ...] = (
    ("repro_torch.launch", REALTIME),   # CLI entry points: printed step timings
    # explicit pin (same tier the `repro` default implies): the batched
    # fitness path feeds GA pruning decisions, so its determinism rules
    # must survive any future loosening of a broader prefix
    ("repro_torch.core.vectorized", DETERMINISTIC),
    # explicit pin for the same reason: serving traces are content-
    # addressed values (pure-hash arrival gaps, bit-identical replay), so
    # the wall-clock/unseeded-rng rules are load-bearing for
    # repro_torch.serve even though its sibling repro_torch.launch is
    # realtime
    ("repro_torch.serve", DETERMINISTIC),
    # two-channel observability split (docs/ARCHITECTURE.md §13): the
    # sim-time channel (tracer, exporter, report) is explicitly pinned
    # deterministic — traces/snapshots must stay byte-identical across
    # runs — while the wall-time sink is the one REALTIME carve-out, the
    # only repro_torch.obs module allowed to read the wall clock
    ("repro_torch.obs", DETERMINISTIC),
    ("repro_torch.obs.realtime", REALTIME),
    ("repro_torch", DETERMINISTIC),
)

# rules whose violations are only meaningful on the deterministic tier;
# the remaining rules (unseeded RNG, unpicklable submits, pragma hygiene)
# apply everywhere
DETERMINISTIC_ONLY_RULES = frozenset(
    {"wall-clock", "id-hash", "iter-order"})


def tier_of_module(module: str) -> str:
    """Tier of a dotted module name (longest-prefix match; modules outside
    `repro_torch` — benchmarks, tools — are wall-clock-allowed)."""
    best, best_len = REALTIME, -1
    for prefix, tier in MODULE_TIERS:
        if (module == prefix or module.startswith(prefix + ".")) \
                and len(prefix) > best_len:
            best, best_len = tier, len(prefix)
    return best


def module_of_path(path: str) -> str | None:
    """Dotted module name of a source path, or None when the path does not
    sit under a `repro_torch/` package root.

        >>> module_of_path("/x/src/repro_torch/core/scheduler.py")
        'repro_torch.core.scheduler'
        >>> module_of_path("tools/check_docs.py") is None
        True
    """
    parts = os.path.normpath(path).split(os.sep)
    if "repro_torch" not in parts:
        return None
    parts = parts[parts.index("repro_torch"):]
    if not parts[-1].endswith(".py"):
        return None
    parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def tier_of_path(path: str) -> str:
    module = module_of_path(path)
    return tier_of_module(module) if module else REALTIME


def rule_applies(rule: str, tier: str) -> bool:
    """Whether violations of `rule` count on `tier`.

        >>> rule_applies("wall-clock", "realtime")
        False
        >>> rule_applies("unseeded-rng", "realtime")
        True
    """
    if tier == REALTIME and rule in DETERMINISTIC_ONLY_RULES:
        return False
    return True
