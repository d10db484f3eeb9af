#!/usr/bin/env python3
"""Write the JAX package's Fig. 11 rows, as it computes them under the
installed jax, to ``tests/data/fig11_reference.json``.

    PYTHONPATH=src python3 tools/fig11_reference.py

Runs ``benchmarks/bench_auc.py``'s ``rows()`` at full size and at smoke
size on the CPU and records ``{"jax": version, "full": {name: derived},
"smoke": {name: derived}}``.  The BER rows of the committed
``benchmarks/BENCH_serving.json`` and ``BENCH_smoke_baseline.json`` were
drawn with ``jax_threefry_partitionable=False`` (they are reproduced
exactly with that flag set); jax 0.9 draws partitionably by default, as
the port does, so the JAX package no longer reproduces those rows.  The
error-free rows agree.  ``chip_smoke.py`` holds the
port's full-size rows on the card to this file, and
``tests/test_torch_paper_benches.py`` holds its smoke rows to a live run.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "fig11_reference.json"


def reference_rows(smoke: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    from benchmarks import bench_auc
    return {n: float(v) for n, _, v in bench_auc.rows(smoke=smoke)}


def main() -> int:
    import jax
    data = {"jax": jax.__version__, "full": reference_rows(False),
            "smoke": reference_rows(True)}
    OUT.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)} (jax {jax.__version__})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
