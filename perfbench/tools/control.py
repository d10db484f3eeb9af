#!/usr/bin/env python3
"""Read the control of ``correct`` on the card at a cell's own size:

    python3 perfbench/tools/control.py --workload CELL \
        --events-per-lane N --seeds 11,12,13 [--out build/control.jsonl]

For each seed it prints the comparison's numbers for the reference in
bfloat16 put in the program's place (``lib.control``); ``N`` is the events
a run of the cell serves per lane.
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
    ap.add_argument("--events-per-lane", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from perfbench.lib import control, manifest
    config = manifest.cell(args.workload)["config"]
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control.readings(config, seed, args.events_per_lane,
                               device=args.device)
        row = {"workload": args.workload, "seed": seed,
               "events_per_lane": args.events_per_lane,
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
