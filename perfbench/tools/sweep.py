#!/usr/bin/env python3
"""Find a live cell's knee: serve its open loop at offered rates that are
fractions of a reference rate (the ``.sat`` cell's ``events_per_s``), one
window each, and print each point's latency and whether its backlog grew.

    python3 perfbench/tools/sweep.py --workload CELL --base EVENTS_PER_S \
        --fractions 0.6,0.7,0.8,0.9,1.0 --seconds 10 --seed N \
        [--out build/sweep.jsonl]

A point's backlog grows when the median latencies of the window's four
quarters of slabs rise quarter on quarter and the last is more than 1.1
times the first, or some slab was never delivered.  The knee is the
highest rate below the first point whose backlog grew; the sweep records
that point and stops there.  The cell's data file takes 0.8 of the knee.
All points run in this one process, one after another (the first one
builds the kernels).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

GROWTH = 1.1
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--base", type=float, required=True)
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from perfbench.lib import bench
    knee = None
    for frac in (float(f) for f in args.fractions.split(",")):
        rate = frac * args.base
        res = bench.run(args.workload, args.seed, args.seconds, False,
                        offered=rate)
        lv = res["loop"]
        q = lv["quarter_p50_ms"]
        grew = (all(b > a for a, b in zip(q, q[1:]))
                and q[-1] > GROWTH * q[0]) or res["failed"] > 0
        row = {"workload": args.workload, "fraction": frac, "rate": rate,
               "grew": grew, "last_over_first": q[-1] / q[0],
               "correct": res["correct"], "attempted": res["attempted"],
               "failed": res["failed"], **lv}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        if grew:
            break
        knee = rate
    print(json.dumps({"workload": args.workload, "knee": knee,
                      "offered": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
