"""The port's end-to-end example (``repro_torch.examples.
corner_detection_e2e``) against the reference's
``examples/corner_detection_e2e.py`` on the CPU, on one short stream (the
reference's full 80 ms run takes minutes here):

  * ``run`` at 1.2 V, at 0.6 V with BER and under DVFS with BER: kept,
    TOS, vdd trace and energy exact, scores within ``1e-5 * max|R|``,
    PR-AUC within 1e-3;
  * ``compare_scan_vs_reference`` and ``demo_streaming``: every printed
    line equal to the reference's apart from wall-clock figures (the
    us/event line, the session's kev/s) and the port's extra line naming
    each side's backend; every flag ``True``;
  * ``main`` at a cut length: the values it returns are the ones it
    printed, and all six flags of both datasets are ``True``.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_pool_harness import close, one_torch_thread  # noqa: E402,F401
from repro.core import pr_eval as j_pr_eval  # noqa: E402
from repro.events import synthetic as j_synthetic  # noqa: E402
from repro_torch.core import pr_eval as t_pr_eval  # noqa: E402
from repro_torch.events import synthetic as t_synthetic  # noqa: E402
from repro_torch.examples import corner_detection_e2e as t_e2e  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REFERENCE = (Path(__file__).resolve().parents[1] / "examples"
             / "corner_detection_e2e.py")
DURATION_US = 12_000
FLAGS = ("session", "device_slab_feed", "ring_pool", "bucketed_pool",
         "adaptive_migration", "ladder_premium_held")


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def _steady(lines):
    """The lines without wall-clock figures and the port's backend line."""
    out = []
    for ln in lines:
        if ln.startswith(("    us/event", "    backends")):
            continue
        out.append(re.sub(r"\(\d+ kev/s\)", "(kev/s)", ln))
    return out


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("_ref_e2e", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def streams():
    return (j_synthetic.shapes_stream(duration_us=DURATION_US, seed=0),
            t_synthetic.shapes_stream(duration_us=DURATION_US, seed=0))


@pytest.mark.parametrize("kw", [dict(vdd=1.2, inject=False),
                                dict(vdd=0.6, inject=True),
                                dict(vdd=1.2, inject=True, use_dvfs=True)],
                         ids=["errorfree", "ber_0.6V", "dvfs"])
def test_run_matches_reference(ref, streams, kw):
    jst, tst = streams
    want = ref.run(jst, **kw)
    got = t_e2e.run(tst, device="cpu", **kw)
    for f in ("kept", "tos", "vdd_trace"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.energy_pj == want.energy_pj
    close(got.scores, want.scores)
    ok = np.isfinite(want.scores)
    assert abs(t_pr_eval.pr_auc(got.scores[ok], tst.is_corner[ok])
               - j_pr_eval.pr_auc(want.scores[ok], jst.is_corner[ok])) <= 1e-3


def test_compare_scan_vs_reference_lines(ref, streams):
    jst, tst = streams
    _, want = _printed(ref.compare_scan_vs_reference, jst)
    got, lines = _printed(t_e2e.compare_scan_vs_reference, tst, "cpu")
    assert _steady(lines) == _steady(want)
    assert lines[1] == "    backends   : scan fused  vs  reference nmc"
    assert got["bit_exact"] is True
    assert (got["host_syncs_scan"], got["host_syncs_reference"]) == (1, 19)


def test_demo_streaming_lines_and_flags(ref, streams):
    jst, tst = streams
    _, want = _printed(ref.demo_streaming, jst)
    flags, lines = _printed(t_e2e.demo_streaming, tst, "cpu")
    assert _steady(lines) == _steady(want)
    assert list(flags) == list(FLAGS)
    assert all(v is True for v in flags.values()), flags


def test_main_returns_what_it_printed():
    out, lines = _printed(t_e2e.main, "cpu", 6_000)
    assert list(out) == ["shapes_dof", "dynamic_dof"]
    heads = [i for i, ln in enumerate(lines) if ln.startswith("[")]
    assert len(heads) == 2
    for (name, res), i in zip(out.items(), heads):
        assert lines[i] == f"[{name}] events={res['n_events']}"
        assert lines[i + 1] == (
            f"  AUC @1.2V error-free : {res['auc_errorfree']:.3f}   energy "
            f"{res['energy_uj_errorfree']:.2f} uJ")
        assert lines[i + 2].startswith(
            f"  AUC @0.6V BER=2.5%   : {res['auc_low']:.3f}   energy "
            f"{res['energy_uj_low']:.2f} uJ   (dAUC {res['dauc']:+.3f}, "
            f"energy x{res['energy_ratio']:.1f} less)")
        assert lines[i + 3] == (
            f"  DVFS run: mean Vdd {res['dvfs_mean_vdd']:.2f} V, energy "
            f"{res['dvfs_energy_uj']:.2f} uJ")
        cmp = res["scan_vs_reference"]
        assert lines[i + 4] == ("  scan vs host-loop reference (bit-exact: "
                                f"{cmp['bit_exact']})")
        assert cmp["bit_exact"] is True
        assert all(res["flags"][f] is True for f in FLAGS), res["flags"]
