#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's number of CUDA
devices.  The cell comes from `BENCHMARK.json`; the program is
`src/repro_torch`, put on the path here.  Set-up (weights from the seed,
warm-up of the cell's own shapes, and in a fresh checkout the kernels'
build into `build/`) is timed from this process's start; then the window
runs for `--seconds`; then the program is freed and its outputs are held
against the plain reference (`chipbench/reference/`).  The last line of
standard output is the result as one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of the result.  Without a CUDA device, or with JAX or the JAX package
loaded, the run prints no result and exits with a code other than 0.

A cell whose configuration has a `mesh` runs in one process a card, rank
r on `cuda:r` (`chipbench/harness/ranks.py`): this process starts the
ranks, watches them, and prints rank 0's result once every rank has
ended with 0; set-up is timed from this process's start, so it holds
starting the ranks and joining their process group.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def caches_inside_checkout() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    caches_inside_checkout()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from harness import spec
    from harness.cell_run import run_cell
    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if cell.config.get("mesh"):
        from harness import ranks
        code, line = ranks.launch(cell, args.seed, args.seconds,
                                  bool(args.trace), T_START)
        if code:
            return code
    else:
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
