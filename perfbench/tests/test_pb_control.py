"""The control of ``correct`` fails: the reference put in the program's
place at one precision below the config's (bfloat16 Harris LUT and device
books) is not correct by the config's own limits, while the reference
against itself reads zero on every number but the float32 rounding of its
scores."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import control  # noqa: E402
from perfbench.lib.manifest import load_json  # noqa: E402
from perfbench.tests import _tiny  # noqa: E402


@pytest.mark.parametrize("name", ["davis240", "hd720_x4_dvfs"])
def test_control_fails_and_reference_agrees(name):
    config = (_tiny.davis_config() if name == "davis240" else
              load_json(REPO / "perfbench" / "configs" / f"{name}.json"))
    small = {**config, "cameras": 2,
             "stream": {**config["stream"], "duration_us": 20_000}}
    if name.startswith("hd"):
        small["sensor"] = {"height": 720, "width": 1280}
        small["stream"]["duration_us"] = 2_000
    chunks = control.constant(small, 8 * 512)
    got = control.readings(small, 7, chunks, device="cpu")
    assert any(c["value"] > c["limit"] for c in got.values()), got
    assert got["score_gap"]["value"] > got["score_gap"]["limit"]
    same = control.readings(small, 7, chunks, device="cpu",
                            dtype=torch.float64)
    # handed out as float32 scores, as the pool hands them out
    assert same["score_gap"]["value"] < 1e-6
    assert all(c["value"] == 0 for k, c in same.items()
               if k != "score_gap"), same
