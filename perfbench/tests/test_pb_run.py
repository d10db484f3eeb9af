"""``perfbench/run.py``'s refusals, and one short cell on the card.

Without enough CUDA devices, or in a directory that holds only
``BENCHMARK.json`` and ``perfbench/`` (no port), it exits non-zero and
prints no result line.  The ``cuda`` test runs a short window of the first
cell on the card and needs it to be correct."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

ARGS = ["--workload", "hd720_x4_dvfs.sat", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300, check=False)


def test_refuses_without_a_card():
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-2000:]
    assert "CUDA device" in p.stderr


def test_refuses_without_the_port(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-2000:]


@pytest.mark.cuda
def test_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600, check=False)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
