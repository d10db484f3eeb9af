"""Precision-recall evaluation of per-event corner scores (paper Fig. 11).

Ground truth comes from the synthetic generators (``repro_torch.events``): an event
is corner-positive iff it lies within ``gt_radius`` pixels of a true moving
vertex at its timestamp.  The PR curve sweeps the score threshold; AUC is the
trapezoidal area, matching luvHarris's evaluation protocol.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pr_curve", "pr_auc", "delta_auc"]


def pr_curve(scores: np.ndarray, labels: np.ndarray, n_thresh: int = 256):
    """Returns (precision, recall, thresholds); ignores -inf scores."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=bool)
    ok = np.isfinite(scores)
    scores, labels = scores[ok], labels[ok]
    if scores.size == 0 or labels.sum() == 0:
        return np.ones(1), np.zeros(1), np.zeros(1)

    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    l = labels[order].astype(np.float64)
    tp = np.cumsum(l)
    fp = np.cumsum(1.0 - l)
    # Deduplicate tied thresholds: keep the last index of each distinct score.
    distinct = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tp, fp = tp[distinct], fp[distinct]
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / labels.sum()
    # Prepend the (recall=0, precision=1) anchor.
    precision = np.r_[1.0, precision]
    recall = np.r_[0.0, recall]
    return precision, recall, s[distinct]


def pr_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Trapezoidal area under the PR curve."""
    p, r, _ = pr_curve(scores, labels)
    return float(np.trapezoid(p, r))


def delta_auc(scores_ref, scores_test, labels) -> float:
    """AUC(ref) - AUC(test): the paper's 'AUC decrease' metric."""
    return pr_auc(scores_ref, labels) - pr_auc(scores_test, labels)
