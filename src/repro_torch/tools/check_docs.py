"""The port's docs gate: its public docstring examples through `doctest`,
beside the JAX package's `tools/check_docs.py` (which also checks the
repo's markdown links and runs `repro`'s examples).

    python -m repro_torch.tools.check_docs

The `repro_torch.api`, `repro_torch.analysis`, `repro_torch.core`,
`repro_torch.obs` and `repro_torch.serve` packages are walked
automatically (every public module — no underscore-prefixed name part —
is included), so a new module cannot silently skip the gate;
`EXTRA_MODULES` pins the public surface outside those packages.  The
examples run on the CPU.  Exits 1 on any failed example, else 0.
"""
from __future__ import annotations

import doctest
import importlib
import pkgutil
import sys

# packages whose public modules are discovered recursively
DISCOVER_PACKAGES = ["repro_torch.api", "repro_torch.analysis",
                     "repro_torch.core", "repro_torch.obs",
                     "repro_torch.serve"]
# public modules outside the discovered packages
EXTRA_MODULES = [
    "repro_torch.hw.topology",
    "repro_torch.hw.catalog",
    "repro_torch.interop",
]


def doctest_modules() -> list[str]:
    """Discovered public modules + the pinned extras, sorted and deduped.

    Discovery imports each package and walks its `__path__`; a module is
    public when no dotted-name part starts with an underscore."""
    names = set(EXTRA_MODULES)
    for pkg_name in DISCOVER_PACKAGES:
        pkg = importlib.import_module(pkg_name)
        names.add(pkg_name)
        for info in pkgutil.walk_packages(pkg.__path__, f"{pkg_name}."):
            if any(part.startswith("_") for part in info.name.split(".")):
                continue
            names.add(info.name)
    return sorted(names)


def run_doctests(modules: list[str]) -> tuple[int, int, list[str]]:
    attempted, failed, failures = 0, 0, []
    for name in modules:
        mod = importlib.import_module(name)
        res = doctest.testmod(mod, verbose=False)
        attempted += res.attempted
        failed += res.failed
        if res.failed:
            failures.append(f"{name}: {res.failed}/{res.attempted} failed")
    return attempted, failed, failures


def main() -> int:
    modules = doctest_modules()
    attempted, failed, failures = run_doctests(modules)
    print(f"doctests: {attempted} examples over {len(modules)} "
          f"modules, {failed} failed")
    for f in failures:
        print(f"  {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
