"""Benchmark runner of the port: the reference's ``benchmarks/run.py`` over
the modules the port has.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--smoke] \
        [--device cpu] [--json-out PATH]

Prints ``name,us_per_call,derived`` CSV, as the reference's runner does,
from ``bench_hwmodel`` (module label ``hwmodel(fig9,fig10)``),
``bench_throughput`` (``throughput(fig1b,fig10d)``), ``bench_dvfs``
(``dvfs(tableI,fig8)``), ``bench_auc`` (``auc(fig11)``),
``bench_streaming`` (``streaming(serving)``) and ``scenarios``
(``scenarios(slo)``), in the reference's order.  Rows whose name ends in
``_skipped``
record a measurement this host cannot take, with 0 in both columns.
``--json-out`` writes the same rows in the reference's JSON shape
(``{"smoke", "rows": {name: {"us_per_call", "derived", "module"[,
"skipped"]}}, "errors"}``); nothing is written by default.  A module that
raises is reported on stderr and makes the run exit non-zero.  Pipelines
and pools run on ``--device`` (the card unless the caller asks for
``cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.benchmarks import (bench_auc, bench_dvfs, bench_hwmodel,
                                    bench_streaming, bench_throughput,
                                    scenarios)

MODULES = (
    ("hwmodel(fig9,fig10)", bench_hwmodel),
    ("throughput(fig1b,fig10d)", bench_throughput),
    ("dvfs(tableI,fig8)", bench_dvfs),
    ("auc(fig11)", bench_auc),
    ("streaming(serving)", bench_streaming),
    ("scenarios(slo)", scenarios),
)


def collect(smoke: bool = False, device: str = "cuda") -> tuple[dict, list]:
    """Run ``MODULES``, print each row as CSV, and return ``(records,
    errors)`` in the JSON artifact's shape."""
    records: dict = {}
    errors: list = []
    for label, mod in MODULES:
        t0 = time.perf_counter()
        try:
            for name, us, derived in mod.rows(smoke=smoke, device=device):
                print(f"{name},{us:.3f},{derived:.6g}")
                rec = {"us_per_call": float(us), "derived": float(derived),
                       "module": label}
                if name.endswith("_skipped"):
                    rec["skipped"] = True
                records[name] = rec
        except Exception as e:
            errors.append({"module": label,
                           "error": f"{type(e).__name__}: {e}"})
            print(f"{label}_ERROR,0,0  # {type(e).__name__}: {e}",
                  file=sys.stderr)
        print(f"# {label} done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    return records, errors


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke sizes")
    ap.add_argument("--json-out", default="",
                    help="write the rows as JSON to this path (default: "
                         "none)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    records, errors = collect(args.smoke, args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"smoke": args.smoke, "rows": records,
                       "errors": errors}, f, indent=2, sort_keys=True)
        print(f"# wrote {len(records)} rows -> {args.json_out}",
              file=sys.stderr)
    if errors:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
