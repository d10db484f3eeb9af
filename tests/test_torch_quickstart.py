"""The port's quickstart (``repro_torch.examples.quickstart``) against the
reference's ``examples/quickstart.py`` on the CPU: the stream, kept share,
scored count and macro / conventional lines equal, PR-AUC within 1e-3;
the values ``main`` returns are the ones it printed."""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro_torch.examples import quickstart as t_quick  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REFERENCE = Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs():
    spec = importlib.util.spec_from_file_location("_ref_quickstart",
                                                  REFERENCE)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    _, want = _printed(ref.main)
    got, lines = _printed(t_quick.main, "cpu")
    return got, lines, want


def test_lines_match_reference(runs):
    got, lines, want = runs
    assert len(lines) == len(want) == 6
    auc = [i for i, ln in enumerate(want) if ln.startswith("PR-AUC")]
    assert auc == [2]
    for i, (a, b) in enumerate(zip(lines, want)):
        if i not in auc:
            assert a == b
    want_auc = float(re.match(r"PR-AUC: ([0-9.]+)", want[2]).group(1))
    assert abs(got["pr_auc"] - want_auc) <= 1e-3


def test_returned_values_are_the_printed_ones(runs):
    got, lines, want = runs
    assert lines[0].startswith(f"stream: {got['n_events']} events")
    assert lines[1] == (f"kept after STCF: {got['kept_share']:.0%}  "
                        f"scored: {got['n_scored']} events")
    assert lines[2] == f"PR-AUC: {got['pr_auc']:.3f}"
    for line, vdd in zip(lines[3:5], (1.2, 0.6)):
        m = got["macro"][vdd]
        assert line == (f"macro @ {vdd:.1f} V: {m['energy_uj']:.1f} uJ, "
                        f"{m['busy_ms']:.2f} ms busy "
                        f"({m['capacity_meps']:.1f} Meps capacity)")
    assert lines[5] == (f"conventional digital would need "
                        f"{got['conventional_ms']:.2f} ms "
                        f"({got['conventional_meps']:.1f} Meps)")
