#!/usr/bin/env python3
"""Read the control of ``correct`` on the card at a cell's own size:

    python3 perfbench/tools/control.py --workload CELL \
        --events-per-lane N --seeds 11,12,13 [--out build/control.jsonl] \
        [--schedules RESULT.json]

For each seed it prints the comparison's numbers for the reference in
bfloat16 put in the program's place (``lib.control``); ``N`` is the events
a run of the cell serves per lane.  ``--schedules`` names a file holding a
run's result line (or its ``schedules`` list): each lane is then folded in
the chunks that run's pool folded it in (moves between buckets, a flushed
tail), and ``N`` is not used.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--events-per-lane", type=int, default=None)
    ap.add_argument("--schedules", default=None)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from perfbench.lib import check, control, manifest
    config = manifest.cell(args.workload)["config"]
    if args.schedules:
        with open(args.schedules) as f:
            rows = json.load(f)
        rows = rows["schedules"] if isinstance(rows, dict) else rows
        chunks = [check.sizes(check.from_runs(r)) for r in rows]
    elif args.events_per_lane is not None:
        chunks = control.constant(config, args.events_per_lane)
    else:
        ap.error("give --events-per-lane or --schedules")
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control.readings(config, seed, chunks, device=args.device)
        row = {"workload": args.workload, "seed": seed,
               "events_per_lane": [sum(c) for c in chunks],
               "correct": all(c["value"] <= c["limit"]
                              for c in got.values()),
               **{k: c["value"] for k, c in got.items()}}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
