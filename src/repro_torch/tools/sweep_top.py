"""sweep_top: live terminal dashboard over a fleet of sweep shards.

Tails the atomic heartbeat files `run_shard --heartbeat` writes (status,
done/failed counts, points/s, embedded session metrics) plus each
shard's per-shard JSONL record store (incumbent best EDP / latency) and
renders one merged fleet view, refreshed in place:

    python -m repro_torch.tools.sweep_top shards/shard*/heartbeat.json
    python -m repro_torch.tools.sweep_top --dir shards         # autodiscover
    python -m repro_torch.tools.sweep_top --dir shards --once  # one snapshot

Reading is strictly passive: heartbeats are atomic (tmp+replace) so a
snapshot never sees a torn write, and the record stores are append-only
JSONL tailed with a tolerant parser (a mid-append torn last line is
skipped, exactly like the store's own reader).
"""
import argparse
import glob
import json
import os
import sys
import time


def read_heartbeat(path: str) -> "dict | None":
    """Parse one heartbeat file; None when missing or unreadable.

    Heartbeats are written atomically, so a failed parse means the shard
    never wrote one (or the supervisor pointed at the wrong file) — the
    dashboard shows it as 'no beat' rather than crashing.
    """
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def tail_store(store_dir: str) -> dict:
    """Incumbent metrics of one shard's JSONL record store.

    Returns {"records": n, "best_edp": x|None, "best_latency_cc": y|None};
    zeros/None when the store does not exist yet.  Torn trailing lines
    (a write in flight) are skipped.
    """
    path = os.path.join(store_dir, "records.jsonl")
    n, best_edp, best_lat = 0, None, None
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue       # torn/in-flight line
                n += 1
                edp = rec.get("edp")
                lat = rec.get("latency_cc")
                if edp is not None and (best_edp is None or edp < best_edp):
                    best_edp = edp
                if lat is not None and (best_lat is None or lat < best_lat):
                    best_lat = lat
    except OSError:
        pass
    return {"records": n, "best_edp": best_edp, "best_latency_cc": best_lat}


def fleet_snapshot(heartbeat_paths, store_dirs=()) -> dict:
    """Merge shard heartbeats (+ optional stores) into one fleet view.

    Shards are keyed by heartbeat path; totals aggregate done/failed/
    total/points_per_s over every live beat.  Store dirs are matched to
    shards positionally when counts line up, else aggregated separately.
    """
    shards = []
    totals = {"done": 0, "failed": 0, "total": 0, "points_per_s": 0.0,
              "records": 0, "live": 0}
    best_edp = None
    stores = [tail_store(d) for d in store_dirs]
    for i, path in enumerate(heartbeat_paths):
        beat = read_heartbeat(path)
        store = stores[i] if i < len(stores) else None
        row = {"path": path, "beat": beat, "store": store}
        shards.append(row)
        if beat is None:
            continue
        totals["live"] += 1
        totals["done"] += beat.get("done", 0)
        totals["failed"] += beat.get("failed", 0)
        totals["total"] += beat.get("total") or 0
        totals["points_per_s"] += beat.get("points_per_s", 0.0)
    for store in stores:
        totals["records"] += store["records"]
        edp = store["best_edp"]
        if edp is not None and (best_edp is None or edp < best_edp):
            best_edp = edp
    totals["best_edp"] = best_edp
    return {"shards": shards, "totals": totals}


def _fmt(value, width: int) -> str:
    if value is None:
        return "-".rjust(width)
    if isinstance(value, float):
        return f"{value:.3g}".rjust(width)
    return str(value).rjust(width)


def render(snapshot: dict) -> str:
    """Fixed-width text rendering of one fleet snapshot."""
    lines = [f"{'shard':>6} {'status':>12} {'done':>7} {'fail':>5} "
             f"{'total':>7} {'pts/s':>8} {'records':>8} {'best edp':>10}"]
    for row in snapshot["shards"]:
        beat, store = row["beat"], row["store"]
        if beat is None:
            name = os.path.basename(os.path.dirname(row["path"])) or "?"
            lines.append(f"{name:>6} {'no beat':>12}")
            continue
        idx = beat.get("shard_index")
        name = "?" if idx is None else str(idx)
        lines.append(" ".join([
            _fmt(name, 6), _fmt(beat.get("status", "?"), 12),
            _fmt(beat.get("done", 0), 7), _fmt(beat.get("failed", 0), 5),
            _fmt(beat.get("total"), 7),
            _fmt(beat.get("points_per_s", 0.0), 8),
            _fmt(store["records"] if store else None, 8),
            _fmt(store["best_edp"] if store else None, 10)]))
    t = snapshot["totals"]
    lines.append(f"fleet: {t['live']}/{len(snapshot['shards'])} live  "
                 f"done {t['done']}/{t['total']}  failed {t['failed']}  "
                 f"{t['points_per_s']:.2f} pts/s  "
                 f"records {t['records']}  best edp "
                 f"{t['best_edp'] if t['best_edp'] is not None else '-'}")
    return "\n".join(lines)


def discover(root: str) -> "tuple[list[str], list[str]]":
    """(heartbeat paths, store dirs) under a shard root directory."""
    beats = sorted(glob.glob(os.path.join(root, "*", "heartbeat.json")))
    stores = [os.path.dirname(p) for p in beats]
    return beats, stores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("heartbeats", nargs="*",
                    help="heartbeat JSON files (one per shard)")
    ap.add_argument("--dir", help="shard root: tails */heartbeat.json and "
                                  "the store next to each beat")
    ap.add_argument("--stores", nargs="*", default=None,
                    help="per-shard store dirs (positional match)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit")
    args = ap.parse_args(argv)
    beats, stores = list(args.heartbeats), list(args.stores or ())
    if args.dir:
        d_beats, d_stores = discover(args.dir)
        beats += d_beats
        if not stores:
            stores = d_stores
    if not beats:
        ap.error("no heartbeat files (pass paths or --dir)")
    while True:
        snap = fleet_snapshot(beats, stores)
        if args.once:
            print(render(snap))
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + render(snap) + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
