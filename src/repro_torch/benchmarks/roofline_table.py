"""The dry-run's JSON records as the roofline table, and the runner's
``roofline(dryrun)`` rows (the port of ``benchmarks/roofline_table.py``).

``load(out_dir)`` reads every record ``launch.dryrun`` wrote there;
``markdown_table(out_dir, mesh)`` renders one row per cell of
``configs.cells(include_skipped=True)`` (skipped, missing, or its three
roofline terms, dominant term and MODEL/counted FLOPs); ``rows(out_dir)``
gives one ``roofline_{arch}_{shape}_compute_frac`` per ok single-mesh
record (the compute term over the largest term) and ``dryrun_cells_ok``,
the count of ok records.  It reads records only: nothing runs.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch import configs

__all__ = ["load", "markdown_table", "rows"]

OUT_DIR = "experiments/dryrun"


def load(out_dir=OUT_DIR):
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def markdown_table(out_dir=OUT_DIR, mesh="single") -> str:
    recs = [r for r in load(out_dir) if r.get("mesh") == mesh and r.get("ok")
            and not r.get("tag")]
    by_key = {(r["arch"], r["shape"]): r for r in recs}
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | MODEL/HLO FLOPs | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cell in configs.cells(include_skipped=True):
        key = (configs.canon(cell["arch"]), cell["shape"])
        if cell["skip"]:
            lines.append(
                f"| {cell['arch']} | {cell['shape']} | — | — | — | — | — | "
                f"SKIP: {cell['skip']} |")
            continue
        r = by_key.get(key)
        if r is None:
            lines.append(f"| {cell['arch']} | {cell['shape']} | ? | ? | ? | "
                         f"? | ? | missing |")
            continue
        rf = r["roofline"]
        lines.append(
            f"| {cell['arch']} | {cell['shape']} | {rf['compute_s']:.3g} | "
            f"{rf['memory_s']:.3g} | {rf['collective_s']:.3g} | "
            f"{rf['dominant']} | {rf['useful_ratio']:.3f} | "
            f"{rf.get('note', '')} |"
        )
    return "\n".join(lines)


def rows(out_dir=OUT_DIR):
    recs = load(out_dir)
    out = []
    for r in recs:
        if not r.get("ok") or r.get("tag"):
            continue
        rf = r.get("roofline")
        if rf and r["mesh"] == "single":
            dom = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
            frac = rf["compute_s"] / dom if dom else 0.0
            out.append((f"roofline_{r['arch']}_{r['shape']}_compute_frac",
                        0.0, frac))
    out.append(("dryrun_cells_ok", 0.0,
                float(sum(1 for r in recs if r.get("ok")))))
    return out
