"""The port's ``DvfsTrace.avg_power_mw()`` and ``drop_rate()`` against the
reference's (``repro.core.dvfs.DvfsTrace``), on ``tests/test_dvfs.py``'s
streams and a burst profile that outruns the top operating point, with and
without DVFS and under a ``vdd_ceiling``.  Bound: exactly equal (both are
float64 numpy arithmetic on equal arrays)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import dvfs as j_dvfs  # noqa: E402
from repro.events import synthetic as j_syn  # noqa: E402
from repro_torch.core import dvfs as t_dvfs  # noqa: E402
from repro_torch.events import synthetic as t_syn  # noqa: E402

# name -> (rate profile in events/us, window_us, seed, DvfsConfig kwargs)
STREAMS = {
    "flat_1e-3": (np.full(10, 1e-3), 10_000, 2, {}),
    "flat_2e-3": (np.full(30, 2e-3), 10_000, 2, {}),
    "profile": (np.array([0.5, 0.5, 2.0, 2.0, 0.2, 0.2, 1.0, 1.0]) * 1e-3,
                10_000, 2, dict(tw_us=10_000)),
    "burst": (np.array([0.5, 10.0, 60.0, 3.0, 30.0, 80.0, 1.0, 20.0]), 150,
              5, dict(tw_us=150)),
}


def _traces(name, use_dvfs, ceiling):
    prof, window, seed, kw = STREAMS[name]
    j_st = j_syn.rate_profile_stream(prof, window_us=window, seed=seed)
    t_st = t_syn.rate_profile_stream(prof, window_us=window, seed=seed)
    np.testing.assert_array_equal(j_st.ts, t_st.ts)
    j_tr = j_dvfs.simulate_dvfs(
        j_st.ts, j_dvfs.DvfsConfig(vdd_ceiling=ceiling, **kw),
        use_dvfs=use_dvfs)
    t_tr = t_dvfs.simulate_dvfs(
        t_st.ts, t_dvfs.DvfsConfig(vdd_ceiling=ceiling, **kw),
        use_dvfs=use_dvfs)
    return len(j_st.ts), j_tr, t_tr


@pytest.mark.parametrize("ceiling", [None, 0.9])
@pytest.mark.parametrize("use_dvfs", [True, False])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_avg_power_and_drop_rate_equal(name, use_dvfs, ceiling):
    n, j_tr, t_tr = _traces(name, use_dvfs, ceiling)
    assert t_tr.avg_power_mw() == j_tr.avg_power_mw()
    assert isinstance(t_tr.avg_power_mw(), float)
    for total in (n, 0, 7):
        assert t_tr.drop_rate(total) == j_tr.drop_rate(total)


def test_cases_reach_drops_and_dvfs_savings():
    """The cases are not all trivial: the burst drops events, and DVFS
    saves power on the 2e-3 stream (``test_dvfs.py``'s claims, on the
    port)."""
    n, _, burst = _traces("burst", True, None)
    assert burst.drop_rate(n) > 0.0
    _, _, with_dvfs = _traces("flat_2e-3", True, None)
    _, _, without = _traces("flat_2e-3", False, None)
    assert with_dvfs.avg_power_mw() < without.avg_power_mw()
    n, _, flat = _traces("flat_1e-3", True, None)
    assert flat.drop_rate(n) == 0.0
