#!/usr/bin/env python3
"""Run cells one after another, each run in a process of its own, and keep
every result line.

    python3 perfbench/tools/runs.py --out build/runs.jsonl \
        CELL:SEED:SECONDS:TRACE [...]

Each spec runs ``python3 perfbench/run.py --workload CELL --seed SEED
--seconds SECONDS --trace TRACE`` from the checkout's root.  One JSON line
per run goes to ``--out``: the spec, exit code, wall seconds, the result
object (or ``null``) and the end of standard error.  A one-line summary of
each run is printed as it ends.  ``nvidia-smi``'s card name and power limit
are printed first where it is present.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "no nvidia-smi"
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False)
    return out.stdout.strip()


def summary(res: dict) -> str:
    if res is None:
        return "no result"
    m = " ".join(f"{k}={v['value']:.6g}" for k, v in res["metrics"].items())
    bad = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    return (f"correct={res['correct']} attempted={res['attempted']} "
            f"failed={res['failed']} {m} peak="
            f"{res['device']['memory_peak_bytes']} failing={bad}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("specs", nargs="+")
    args = ap.parse_args(argv)
    print(f"[runs] card: {card()}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    worst = 0
    with open(args.out, "a") as f:
        for spec in args.specs:
            cell, seed, seconds, trace = spec.split(":")
            cmd = [sys.executable, "perfbench/run.py", "--workload", cell,
                   "--seed", seed, "--seconds", seconds, "--trace", trace]
            t = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True, check=False)
            wall = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            res = None
            if p.returncode == 0 and lines:
                res = json.loads(lines[-1])
            f.write(json.dumps({"spec": spec, "rc": p.returncode,
                                "wall_s": wall, "result": res,
                                "stderr": p.stderr[-4000:]}) + "\n")
            f.flush()
            print(f"[runs] {spec} rc={p.returncode} wall={wall:.1f}s "
                  f"{summary(res)}", flush=True)
            if p.returncode:
                print(p.stderr[-3000:], flush=True)
            worst = max(worst, p.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
