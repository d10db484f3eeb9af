#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (the port, ``repro_torch``, is imported from
``src/``).  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from a profiled stretch after the window.  Both
check every answer against the plain reference and print the numbers
compared, each beside its limit, last on standard error and last in the
result line.  Exits non-zero, printing no result, without enough CUDA
devices, without the port, or if JAX or the JAX package got loaded.
"""
from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks); 0
    where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from perfbench.lib import bench, manifest
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        bench.log(f"[run] the port is missing from this checkout: {exc}")
        return 2
    import torch
    chips = manifest.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        bench.log(f"[run] {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}")
        return 3
    res = bench.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), age0=AGE0, t_start=T_START)
    foreign = bench.foreign_modules()
    if foreign:
        bench.log(f"[run] JAX or the JAX package was loaded: {foreign}")
        return 4
    for name, c in res["checks"].items():
        bench.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
