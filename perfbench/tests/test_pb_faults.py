"""The harness's own verdict on broken programs: a whole run of a tiny
cell on the CPU (the look for a chip skipped) with the timed path broken
underneath comes out not correct, once for each fault a pool can have; the
sound program comes out correct.  One card holds every lane, so there is
no exchange between chips to leave out."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import bench  # noqa: E402
from perfbench.tests import _tiny  # noqa: E402


def _unchanged(orig):
    """The step returns its state unchanged: outputs computed on copies."""
    def step(inplace, tos, sae, *args):
        _, _, keep, scores = orig(inplace, tos.clone(), sae.clone(), *args)
        return tos, sae, keep, scores
    return step


def _half_lanes(orig):
    """Half of the lanes are left out of every step."""
    def step(inplace, tos, sae, lut, xy, ts, valid, ber, bits, mask, kw):
        b = tos.shape[0]
        keep = torch.arange(b, device=tos.device) < b // 2
        mask = keep if mask is None else mask & keep
        return orig(inplace, tos, sae, lut, xy, ts, valid, ber, bits, mask,
                    kw)
    return step


def _altered(orig):
    """One answer altered where it is produced: lane 0's first keep flag."""
    def step(*args):
        tos, sae, keep, scores = orig(*args)
        keep = keep.clone()
        keep[0, 0] = ~keep[0, 0]
        return tos, sae, keep, scores
    return step


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.tiny_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("fault", [None, _unchanged, _half_lanes, _altered],
                         ids=["sound", "state_unchanged", "half_lanes",
                              "answer_altered"])
@pytest.mark.parametrize("cell", ["tiny.tinysat"])
def test_run_verdict(root, cell, fault, monkeypatch):
    from repro_torch.kernels import ops
    if fault is not None:
        monkeypatch.setattr(ops, "_fused_step", fault(ops._fused_step))
    res = bench.run(cell, 2**31 + 99, 1.0, False, device="cpu", root=root)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    assert not bench.foreign_modules()


def test_live_run_on_cpu(root):
    res = bench.run("tiny.tinylive", 5, 1.0, False, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["loop"]["p95_ms"] > 0
