#!/usr/bin/env python3
"""Spreads of the end-to-end metrics over runs kept by ``runs.py``:

    python3 perfbench/tools/spread.py build/set1.jsonl \
        [build/set2.jsonl ...]

Each file is one set.  Per cell and metric it prints each set's median and
its spread (the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median), the
spread left when the set's run farthest from its median is left out, and
five times the widest spread (the bound that rule gives, at least 1%).
"""
from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(vals) -> float:
    q1, _, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / statistics.median(vals)


def trimmed(vals) -> list:
    med = statistics.median(vals)
    far = max(range(len(vals)), key=lambda i: abs(vals[i] - med))
    return [v for i, v in enumerate(vals) if i != far]


def main(paths) -> int:
    sets = []
    for path in paths:
        got = defaultdict(lambda: defaultdict(list))
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                res = r["result"]
                cell, _, _, trace = r["spec"].split(":")
                if res is None or trace != "0":
                    continue
                for k, v in res["metrics"].items():
                    got[cell][k].append(v["value"])
        sets.append(got)
    cells = sorted({c for s in sets for c in s})
    for cell in cells:
        for metric in sorted({m for s in sets for m in s.get(cell, {})}):
            rows, widest = [], 0.0
            for i, s in enumerate(sets):
                vals = s.get(cell, {}).get(metric, [])
                if len(vals) < 3:
                    continue
                sp = spread(vals)
                widest = max(widest, sp)
                rows.append(f"set{i + 1} n={len(vals)} median="
                            f"{statistics.median(vals):.6g} spread={sp:.4f}"
                            f" trimmed={spread(trimmed(vals)):.4f}")
            print(f"{cell} {metric}: " + "; ".join(rows)
                  + f"; 5x widest = {max(0.01, 5 * widest):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
