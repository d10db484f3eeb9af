"""Paper Fig. 11: precision-recall AUC of corner detection, error-free
against BER-injected (0.2% at 0.61 V, 2.5% at 0.6 V), on the shapes_dof /
dynamic_dof analogues.

The port of the reference's ``benchmarks/bench_auc.py``, with its row
names and sizes (80 ms streams, 12 ms at smoke size): the batch pipeline
runs on ``device`` (the card, K1 and K2, unless the caller asks for
``cpu``).  ``derived`` = AUC or delta-AUC; the paper reports deltas of
0.027 / 0.015 at 2.5% BER and ~0 at 0.2%.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import pipeline, pr_eval
from repro_torch.events import synthetic


def _run(stream, vdd, inject, device):
    cfg = pipeline.PipelineConfig(
        chunk=512, lut_every_chunks=2, vdd=vdd, inject_ber=inject,
        device=device)
    return pipeline.run_pipeline(stream.xy, stream.ts, cfg)


def rows(smoke: bool = False, device: str = "cuda"):
    out = []
    duration_us = 12_000 if smoke else 80_000
    for name, gen, seed in (
        ("shapes_dof", synthetic.shapes_stream, 0),
        ("dynamic_dof", synthetic.dynamic_stream, 1),
    ):
        stream = gen(duration_us=duration_us, seed=seed)
        base = _run(stream, 1.2, False, device)
        ok0 = np.isfinite(base.scores)
        auc0 = pr_eval.pr_auc(base.scores[ok0], stream.is_corner[ok0])
        out.append((f"fig11_{name}_auc_errorfree", 0.0, auc0))
        for vdd, tag in ((0.61, "ber0.2pct"), (0.60, "ber2.5pct")):
            r = _run(stream, vdd, True, device)
            ok = ok0 & np.isfinite(r.scores)
            auc = pr_eval.pr_auc(r.scores[ok], stream.is_corner[ok])
            out.append((f"fig11_{name}_auc_{tag}", 0.0, auc))
            out.append((f"fig11_{name}_delta_{tag}", 0.0, auc0 - auc))
    return out
