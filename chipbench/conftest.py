"""The benchmark's CPU tests: `python -m pytest chipbench` from the root of
the checkout.  The harness (`chipbench/harness`, `chipbench/reference`)
and the program (`src/repro_torch`) are put on the path here."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
