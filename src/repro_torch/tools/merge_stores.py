"""Merge shard result stores offline (no deps, argparse only).

    python -m repro_torch.tools.merge_stores merged shard0 shard1 shard2

Sources are shard store directories (holding ``records.jsonl``) or ``.jsonl``
files; the first positional argument is the destination store directory (or
``.jsonl`` file).  Records are content-keyed, so the merge concatenates and
dedups by key — merging the N shards of a partitioned sweep reproduces the
serial run's record set exactly, and re-merging is idempotent (an existing
destination store contributes its records first).  Shard ``failures.jsonl``
sidecars merge the same way (first-wins, healthy records supersede).

Integrity: ``--verify`` checks every source for mid-file corruption and
torn tails before merging (``--verify`` alone, without sources to merge
into a destination, works too: pass the stores to check as sources and any
throwaway destination); a corrupt source aborts with exit code 4 unless
``--repair`` is given, which quarantines bad lines to ``.bad`` sidecars
and merges the rest.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description="merge shard result stores")
    ap.add_argument("out", help="destination store directory (or .jsonl file)")
    ap.add_argument("sources", nargs="+",
                    help="shard store directories or records.jsonl files")
    ap.add_argument("--allow-missing", action="store_true",
                    help="skip sources without a store instead of failing")
    ap.add_argument("--verify", action="store_true",
                    help="integrity-check every source before merging "
                         "(corrupt source -> exit 4)")
    ap.add_argument("--repair", action="store_true",
                    help="quarantine corrupt mid-file lines to .bad "
                         "sidecars instead of aborting")
    args = ap.parse_args(argv)

    from repro_torch.api.distributed import merge_stores
    from repro_torch.api.resilience import StoreCorruptionError
    from repro_torch.api.session import ResultStore

    present, skipped = [], []
    for src in args.sources:
        if not os.path.exists(ResultStore.resolve_path(src)) \
                and not os.path.exists(ResultStore.resolve_failures_path(src)):
            if args.allow_missing:
                skipped.append(src)
                continue
            print(f"error: no shard store at {ResultStore.resolve_path(src)} "
                  "(use --allow-missing to skip)", file=sys.stderr)
            return 2
        present.append(src)

    if args.verify:
        corrupt = 0
        for src in present:
            try:
                report = ResultStore.verify_path(src)
            except StoreCorruptionError as e:
                corrupt += 1
                print(f"CORRUPT  {src}: {e}", file=sys.stderr)
                continue
            tail = ", torn tail" if report["torn_tail"] else ""
            print(f"ok       {src}: {report['n_records']} records, "
                  f"{report['n_failures']} failures{tail}")
        if corrupt and not args.repair:
            print(f"error: {corrupt} corrupt store(s) "
                  "(re-run with --repair to quarantine bad lines)",
                  file=sys.stderr)
            return 4

    # load once: the loaded stores go straight into the merge
    sources = [ResultStore(src, repair=args.repair) for src in present]
    per_source = [len(s) for s in sources]
    merged = merge_stores(args.out, *sources, repair=args.repair)
    dupes = max(0, sum(per_source) - len(merged))
    print(f"merged {len(sources)} stores "
          f"({' + '.join(map(str, per_source)) or '0'} records, "
          f"{dupes} duplicate keys) "
          f"-> {merged.path} ({len(merged)} records"
          + (f", {len(merged.failures())} failures" if merged.failures()
             else "") + ")")
    if skipped:
        print(f"skipped missing: {', '.join(skipped)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
