"""The port's static-analysis gate: the determinism linter
(`repro_torch.analysis.staticcheck`) over the port, the JAX package's
`tools/check_static.py` for `src/repro_torch`.

    python -m repro_torch.tools.check_static [--strict] [--format json] [PATH ...]

Lints `src/repro_torch/` (or the paths given), each file at the tier of
its module (`repro_torch.analysis.staticcheck.tiers`), and reports every
finding — including pragma-suppressed ones, marked `[allowed]` so
intentional nondeterminism stays visible in CI logs.

Exit codes: 0 clean (or non-strict), 5 unallowed violations under
`--strict`, 2 usage error.  `--format json` emits one machine-readable
object (`{"violations": [...], "summary": {...}}`) for tooling.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import repro_torch
from repro_torch.analysis.staticcheck import lint_paths, tier_of_path

PORT = os.path.dirname(os.path.abspath(repro_torch.__file__))
ROOT = os.path.dirname(os.path.dirname(PORT))

EXIT_VIOLATIONS = 5


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="check_static",
        description="determinism linter over the port's Python sources")
    parser.add_argument("paths", nargs="*", default=[PORT],
                        help="files/directories to lint "
                             "(default: src/repro_torch)")
    parser.add_argument("--strict", action="store_true",
                        help=f"exit {EXIT_VIOLATIONS} when unallowed "
                             "violations remain")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="report format (default: text)")
    args = parser.parse_args(argv)

    violations = lint_paths(args.paths)
    unallowed = [v for v in violations if not v.allowed]
    allowed = [v for v in violations if v.allowed]

    if args.format == "json":
        print(json.dumps({
            "violations": [{
                "path": os.path.relpath(v.path, ROOT)
                if os.path.isabs(v.path) else v.path,
                "line": v.line, "col": v.col, "rule": v.rule,
                "message": v.message, "allowed": v.allowed,
                "tier": tier_of_path(v.path),
            } for v in violations],
            "summary": {"unallowed": len(unallowed),
                        "allowed": len(allowed),
                        "strict": bool(args.strict)},
        }, indent=2))
    else:
        for v in violations:
            print(v.format())
        print(f"staticcheck: {len(unallowed)} violations, "
              f"{len(allowed)} pragma-allowed")

    if unallowed and args.strict:
        return EXIT_VIOLATIONS
    return 0


if __name__ == "__main__":
    sys.exit(main())
