"""Benchmark runner of the port: the reference's ``benchmarks/run.py`` over
the modules the port has.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--smoke] \
        [--device cpu] [--json-out PATH] [--check-regression BASELINE \
        [--tol 0.35] [--tol-time 3.0]]

Prints ``name,us_per_call,derived`` CSV, as the reference's runner does,
from ``bench_hwmodel`` (module label ``hwmodel(fig9,fig10)``),
``bench_throughput`` (``throughput(fig1b,fig10d)``), ``bench_dvfs``
(``dvfs(tableI,fig8)``), ``bench_auc`` (``auc(fig11)``),
``bench_tos_kernels`` (``tos_kernels(perf)``), ``bench_streaming``
(``streaming(serving)``), ``scenarios`` (``scenarios(slo)``) and
``roofline_table`` (``roofline(dryrun)``: the dry-run's records under
``experiments/dryrun``, read, not made), in the reference's order.  Each
module's ``rows`` gets the ``smoke`` and ``device`` arguments it takes.
Rows whose name ends in ``_skipped``
record a measurement this host cannot take, with 0 in both columns.
``--json-out`` writes the same rows in the reference's JSON shape
(``{"smoke", "rows": {name: {"us_per_call", "derived", "module"[,
"skipped"]}}, "errors"}``); nothing is written by default.  A module that
raises is reported on stderr and makes the run exit non-zero.  Pipelines
and pools run on ``--device`` (the card unless the caller asks for
``cpu``).

``--check-regression BASELINE`` is the reference's perf gate, with its
tables and rules (``check_regression``): after the modules finish, every
baseline row whose name ends in a gated suffix is compared with this run's
and the process exits non-zero on a regression.  Structural rows
(``_GATE_STRUCTURAL``: counts of fetches, migrations, transitions, pack
moves, the fused step's round-trips, the D2H ratio) may drift by ``--tol``
(35%) in their bad direction; wall-time rows (``_GATE_TIME``: the slab and
overload p99s) by ``--tol-time`` (3.0, i.e. 4x), and only when the run's
``--smoke`` flag equals the baseline's.  The gate fails closed: a gated
baseline row that this run lacks or skipped counts as a regression, and so
does a gate that checked no row.  The ``roofline(dryrun)`` rows
(``dryrun_cells_ok``, the ``_compute_frac`` rows) have no gated suffix.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

from repro_torch.benchmarks import (bench_auc, bench_dvfs, bench_hwmodel,
                                    bench_streaming, bench_throughput,
                                    bench_tos_kernels, roofline_table,
                                    scenarios)

MODULES = (
    ("hwmodel(fig9,fig10)", bench_hwmodel),
    ("throughput(fig1b,fig10d)", bench_throughput),
    ("dvfs(tableI,fig8)", bench_dvfs),
    ("auc(fig11)", bench_auc),
    ("tos_kernels(perf)", bench_tos_kernels),
    ("streaming(serving)", bench_streaming),
    ("scenarios(slo)", scenarios),
    ("roofline(dryrun)", roofline_table),
)

# (suffix, direction) of the gated rows, the reference's tables: "higher"
# fails when a row drops below baseline * (1 - tol), "lower" when it rises
# above baseline * (1 + tol).
_GATE_STRUCTURAL = (
    ("_burst_rounds_per_fetch", "higher"),
    ("_fetches_per_round", "lower"),
    ("_migration_count", "higher"),
    ("_migration_padding_saved_ratio", "higher"),
    ("_overload_ladder_transitions", "higher"),
    # the fused step: K1 calls per chunk (one call, two kernel launches)
    ("_fused_roundtrips_per_chunk", "lower"),
    ("_pump_stage_overlap_ratio", "higher"),
    ("_pack_padding_saved_ratio", "higher"),
    ("_d2h_bytes_ratio", "lower"),
    ("_slo_migrations", "higher"),
    ("_slo_transitions", "higher"),
    ("_slo_pack_moves", "higher"),
)
_GATE_TIME = (
    ("_slab_p99_ms", "lower"),
    ("_overload_p99_none_ms", "lower"),
    ("_overload_p99_ladder_ms", "lower"),
)


def check_regression(records: dict, baseline_path: str, *, smoke: bool,
                     tol: float, tol_time: float) -> int:
    """Compare this run's rows with a committed baseline JSON; returns the
    number of regressions, each printed to stderr.  Fails closed: a gated
    baseline row missing from (or skipped in) this run counts, and so does
    checking no row at all."""
    with open(baseline_path) as f:
        base = json.load(f)
    time_comparable = bool(base.get("smoke")) == bool(smoke)
    if not time_comparable:
        print("# gate: smoke flag differs from baseline — wall-time rows "
              "skipped, structural rows still checked", file=sys.stderr)
    gates = list(_GATE_STRUCTURAL) + (list(_GATE_TIME) if time_comparable
                                      else [])
    failures = checked = 0
    for name, brec in sorted(base.get("rows", {}).items()):
        if brec.get("skipped"):
            continue
        for suffix, direction in gates:
            if not name.endswith(suffix):
                continue
            ref = float(brec["derived"])
            if ref <= 0:
                continue
            rec = records.get(name)
            if rec is None or rec.get("skipped"):
                failures += 1
                print(f"# REGRESSION {name}: gated baseline row missing "
                      f"from this run (renamed row, or its bench module "
                      f"failed)", file=sys.stderr)
                continue
            t = tol if (suffix, direction) in _GATE_STRUCTURAL else tol_time
            cur = float(rec["derived"])
            checked += 1
            if (cur < ref * (1 - t)) if direction == "higher" \
                    else (cur > ref * (1 + t)):
                failures += 1
                print(f"# REGRESSION {name}: {cur:.6g} vs baseline "
                      f"{ref:.6g} (allowed {direction}-is-better drift "
                      f"{t:.0%})", file=sys.stderr)
    if checked == 0 and failures == 0:
        failures += 1
        print(f"# REGRESSION: no gated rows found in {baseline_path} — "
              f"the gate checked nothing", file=sys.stderr)
    print(f"# gate: {checked} row(s) checked against {baseline_path}, "
          f"{failures} regression(s)", file=sys.stderr)
    return failures


def collect(smoke: bool = False, device: str = "cuda") -> tuple[dict, list]:
    """Run ``MODULES``, print each row as CSV, and return ``(records,
    errors)`` in the JSON artifact's shape."""
    records: dict = {}
    errors: list = []
    for label, mod in MODULES:
        params = inspect.signature(mod.rows).parameters
        kwargs = {k: v for k, v in (("smoke", smoke), ("device", device))
                  if k in params}
        t0 = time.perf_counter()
        try:
            for name, us, derived in mod.rows(**kwargs):
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
    ap.add_argument("--check-regression", metavar="BASELINE", default=None,
                    help="compare the gated rows with this baseline JSON; "
                         "exit non-zero on a regression")
    ap.add_argument("--tol", type=float, default=0.35,
                    help="allowed drift of structural rows (fraction of "
                         "the baseline; default 0.35)")
    ap.add_argument("--tol-time", type=float, default=3.0,
                    help="allowed drift of wall-time rows (fraction of the "
                         "baseline; default 3.0 = 4x)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    records, errors = collect(args.smoke, args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"smoke": args.smoke, "rows": records,
                       "errors": errors}, f, indent=2, sort_keys=True)
        print(f"# wrote {len(records)} rows -> {args.json_out}",
              file=sys.stderr)
    failures = len(errors)
    if args.check_regression:
        failures += check_regression(
            records, args.check_regression, smoke=args.smoke, tol=args.tol,
            tol_time=args.tol_time)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
