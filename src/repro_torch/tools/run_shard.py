"""Run one shard of a sweep manifest on this machine (no deps, argparse only).

    python -m repro_torch.tools.run_shard sweep.json --shard 2/8 --out shard2

Loads the manifest (written by `repro_torch.api.build_manifest(...).save(...)`
or `repro_torch.api.shard(...)`), optionally slices it to shard k of n
(`--shard k/n`, 0-based k; omit it when the manifest is already a single
shard), rebuilds the design points with content-key verification, and runs
them into a per-shard JSONL store under `--out`.  Re-running after a crash
is incremental: points already in the shard store are served without
scheduling.  Merge the shard stores afterwards with
`python -m repro_torch.tools.merge_stores`.

Fault tolerance: `--retries N` gives every point N extra attempts before it
is quarantined into ``failures.jsonl`` beside the records (quarantine
degrades the shard, it never aborts it); `--deadline S` re-dispatches
process-executor stragglers; `--repair` quarantines corrupt store lines to
a ``.bad`` sidecar instead of refusing to load.  A JSON heartbeat is
written to ``<out>/heartbeat.json`` after every point (``--heartbeat PATH``
to move it, ``--heartbeat none`` to disable) so a supervisor can tell a
slow shard from a dead one.  Exit codes: 0 all points healthy, 3 the shard
completed but quarantined points (summary on stderr).
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_shard(text: str) -> tuple[int, int]:
    """'2/8' -> (2, 8), validating 0 <= k < n.

        >>> parse_shard("2/8")
        (2, 8)
    """
    try:
        k_s, n_s = text.split("/")
        k, n = int(k_s), int(n_s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected K/N (e.g. 2/8), got {text!r}")
    if not 0 <= k < n:
        raise argparse.ArgumentTypeError(
            f"shard index {k} outside 0..{n - 1}")
    return k, n


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        description="run one shard of a sweep manifest")
    ap.add_argument("manifest", help="path to a SweepManifest JSON file")
    ap.add_argument("--shard", type=parse_shard, default=None, metavar="K/N",
                    help="run the k-th of n contiguous balanced slices "
                         "(0-based; omit when the manifest is one shard)")
    ap.add_argument("--out", default=None,
                    help="shard store directory (default: shard<K>of<N> "
                         "next to the manifest)")
    ap.add_argument("--executor", choices=("serial", "process"),
                    default="serial")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-executor worker count")
    ap.add_argument("--retries", type=int, default=0,
                    help="extra attempts per point before quarantine "
                         "(default 0: first failure quarantines)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-point result deadline in seconds (process "
                         "executor): stragglers are re-dispatched")
    ap.add_argument("--heartbeat", default=None, metavar="PATH",
                    help="heartbeat JSON file (default: <out>/heartbeat.json;"
                         " 'none' disables)")
    ap.add_argument("--repair", action="store_true",
                    help="quarantine corrupt store lines to a .bad sidecar "
                         "instead of refusing to load")
    args = ap.parse_args(argv)

    from repro_torch.api.distributed import SweepManifest, run_shard

    manifest = SweepManifest.load(args.manifest)
    out = args.out
    if out is None:
        k, n = (args.shard if args.shard is not None
                else (manifest.shard_index or 0, manifest.n_shards or 1))
        out = os.path.join(os.path.dirname(os.path.abspath(args.manifest)),
                           f"shard{k}of{n}")
    heartbeat = args.heartbeat
    if heartbeat is None:
        heartbeat = os.path.join(out, "heartbeat.json")
        os.makedirs(out, exist_ok=True)
    elif heartbeat.lower() == "none":
        heartbeat = None
    sweep = run_shard(manifest, cache_dir=out, shard=args.shard,
                      executor=args.executor, max_workers=args.workers,
                      retries=args.retries, deadline_s=args.deadline,
                      heartbeat=heartbeat, repair=args.repair)
    print(f"shard done: {len(sweep)} points ({sweep.n_scheduled} scheduled, "
          f"{sweep.n_from_store} from store, {sweep.n_failed} quarantined, "
          f"{sweep.n_retried} retries) in {sweep.wall_s:.1f}s "
          f"-> {os.path.join(out, 'records.jsonl')}")
    if sweep.n_failed:
        print(f"QUARANTINED {sweep.n_failed} point(s) "
              f"(see {os.path.join(out, 'failures.jsonl')}):", file=sys.stderr)
        for f in sweep.failures:
            print(f"  {f.key}  {f.error_type}: {f.message} "
                  f"({f.attempts} attempts)", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
