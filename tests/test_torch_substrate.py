"""Host-side substrate of the port against ``repro``: byte-equal synthetic
streams and chunk stacks, equal hwmodel floats, PR-AUC and DVFS traces."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import dvfs as j_dvfs  # noqa: E402
from repro.core import hwmodel as j_hw  # noqa: E402
from repro.core import pr_eval as j_pr  # noqa: E402
from repro.events import stream as j_stream  # noqa: E402
from repro.events import synthetic as j_syn  # noqa: E402
from repro_torch.core import dvfs as t_dvfs  # noqa: E402
from repro_torch.core import hwmodel as t_hw  # noqa: E402
from repro_torch.core import pr_eval as t_pr  # noqa: E402
from repro_torch.events import stream as t_stream  # noqa: E402
from repro_torch.events import synthetic as t_syn  # noqa: E402

STREAMS = {
    "shapes": lambda m: m.shapes_stream(duration_us=20_000, seed=3),
    "dynamic": lambda m: m.dynamic_stream(duration_us=20_000, seed=4),
    "rate": lambda m: m.rate_profile_stream(np.array([0.1, 0.5, 2.0])),
    "ramp": lambda m: m.ramp_stream([10, 200, 50]),
    "burst": lambda m: m.burst_stream(40, 8),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_synthetic_streams_byte_equal(name):
    a, b = STREAMS[name](j_syn), STREAMS[name](t_syn)
    for field in ("xy", "ts", "pol", "is_corner"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.height, a.width) == (b.height, b.width)


@pytest.mark.parametrize("chunk", [64, 100])
def test_chunking_equal(chunk):
    s = t_syn.shapes_stream(duration_us=10_000, seed=5)
    for x, y in zip(j_stream.stack_chunks(s.xy, s.ts, chunk),
                    t_stream.stack_chunks(s.xy, s.ts, chunk)):
        np.testing.assert_array_equal(x, y)
    got = list(t_stream.chunk_iterator(s, chunk, start_chunk=1))
    want = list(j_stream.chunk_iterator(s, chunk, start_chunk=1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_hwmodel_floats_equal():
    for v in (0.6, 0.61, 0.65, 0.8, 1.0, 1.2):
        for fn in ("patch_latency_ns", "patch_energy_pj",
                   "max_throughput_meps", "ber_at", "row_delay_ns"):
            assert getattr(t_hw, fn)(v) == getattr(j_hw, fn)(v), (fn, v)
        assert t_hw.power_mw(3.0, v) == j_hw.power_mw(3.0, v)
    assert t_hw.dvfs_lut() == j_hw.dvfs_lut()


def test_pr_auc_equal():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal(500).astype(np.float32)
    scores[rng.random(500) < 0.2] = -np.inf
    labels = rng.random(500) < 0.3
    assert t_pr.pr_auc(scores, labels) == j_pr.pr_auc(scores, labels)
    s2 = scores + 0.1 * rng.standard_normal(500).astype(np.float32)
    assert t_pr.delta_auc(scores, s2, labels) == j_pr.delta_auc(
        scores, s2, labels)


@pytest.mark.parametrize("ceiling", [None, 0.9])
def test_dvfs_host_paths_equal(ceiling):
    cfg_t = t_dvfs.DvfsConfig(vdd_ceiling=ceiling)
    cfg_j = j_dvfs.DvfsConfig(vdd_ceiling=ceiling)
    s = t_syn.rate_profile_stream(np.array([0.05, 1.0, 6.0, 20.0, 0.5]))
    a, b = j_dvfs.simulate_dvfs(s.ts, cfg_j), t_dvfs.simulate_dvfs(s.ts,
                                                                   cfg_t)
    for field in ("window_t_us", "est_meps", "vdd", "cap_meps", "energy_pj",
                  "dropped"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    np.testing.assert_array_equal(
        j_dvfs.per_chunk_vdd(s.ts, 40, 256, cfg_j),
        t_dvfs.per_chunk_vdd(s.ts, 40, 256, cfg_t))
    for x, y in zip(j_dvfs.op_point_table(cfg_j),
                    t_dvfs.op_point_table(cfg_t)):
        np.testing.assert_array_equal(x, y)
