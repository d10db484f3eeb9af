"""The port's TOS-kernel cost model (``repro_torch.benchmarks.
bench_tos_kernels``) on the CPU against the reference's
``benchmarks/bench_tos_kernels.py``.

Bounds: row names and order equal to the reference's (smoke and full
size); the bin rows, the unfused bytes and both round-trip rows equal
(``==``); each ``_vpu_s`` / ``_hbm_s`` / ``_mxu_s`` row times its H100 rate
equal to the reference's row times its v5e rate within 1e-12 relative (the
same work at another rate); ``fused_hbm_bytes_per_chunk`` equal to the
shared ``bounds.k1_work`` on the chunk; the measured column 0.0 on the
CPU; the round-trip row a count of K1 calls per chunk."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[1]
# benchmarks/ is a top-level package at the repository's root
sys.path.insert(0, str(ROOT))

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from benchmarks import bench_tos_kernels as ref  # noqa: E402
from repro.launch.mesh import HW  # noqa: E402
from repro_torch.benchmarks import bench_tos_kernels as port  # noqa: E402
from repro_torch.benchmarks import bounds  # noqa: E402
from repro_torch.core import stcf  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RATES = {"_vpu_s": (bounds.INT32_OPS, ref.VPU_OPS),
         "_hbm_s": (bounds.MEM_BPS, HW.HBM_BW),
         "_mxu_s": (bounds.TENSOR_FP16_FLOPS, HW.PEAK_BF16_FLOPS)}
EQUAL = ("_bin_mean_frac", "_bin_max_frac", "_unfused_hbm_bytes_per_chunk",
         "_unfused_roundtrips_per_chunk", "_fused_roundtrips_per_chunk")


@pytest.fixture(scope="module", params=[True, False], ids=["smoke", "full"])
def both(request, one_torch_thread):
    smoke = request.param
    return port.rows(smoke=smoke, device="cpu"), ref.rows(smoke=smoke)


def test_row_names_in_reference_order(both):
    got, want = both
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    assert len(got) in (18, 36)          # 12 tos_kernel + 6 fusedstep a size


def test_smoke_rows_are_the_baselines():
    base = json.loads((ROOT / "benchmarks" / "BENCH_smoke_baseline.json")
                      .read_text())["rows"]
    names = [n for n, _, _ in port.rows(smoke=True, device="cpu")]
    assert set(names) == {k for k, v in base.items()
                          if v["module"] == "tos_kernels(perf)"}


@pytest.mark.parametrize("suffix", list(RATES))
def test_terms_are_the_references_work_at_the_h100_rates(both, suffix):
    got, want = both
    ours, theirs = RATES[suffix]
    n = 0
    for (name, us, g), (_, _, w) in zip(got, want):
        if name.endswith(suffix):
            assert g * ours == pytest.approx(w * theirs, rel=1e-12), name
            n += 1
    assert n == {"_vpu_s": 3, "_hbm_s": 3, "_mxu_s": 1}[suffix] * (
        len(got) // 18)


@pytest.mark.parametrize("suffix", EQUAL)
def test_counts_equal_the_references(both, suffix):
    got, want = both
    rows = [(g, w) for g, w in zip(got, want) if g[0].endswith(suffix)]
    assert rows
    for (name, us, g), (_, _, w) in rows:
        assert (us, g) == (0.0, w), name


def test_headline_rows_follow_the_terms(both):
    got, _ = both
    rows = {n: v for n, _, v in got}
    for h, w, e in port.SIZES[:len(got) // 18]:
        pre = f"tos_kernel_{h}x{w}_E{e}_"
        stream = max(rows[pre + "stream_vpu_s"], rows[pre + "stream_hbm_s"])
        onehot = max(rows[pre + k] for k in ("onehot_mxu_s", "onehot_vpu_s",
                                            "onehot_hbm_s"))
        assert rows[pre + "stream_meps"] == e / stream / 1e6
        assert rows[pre + "onehot_meps"] == e / onehot / 1e6
        assert rows[pre + "binned_stream_meps"] == e / (
            stream * rows[pre + "bin_max_frac"]) / 1e6


@pytest.mark.parametrize("h,w,e", port.SIZES)
def test_fused_bytes_are_k1s_in_place_work(h, w, e):
    """K1's bytes on the reference's binned stream (the first E events of
    ``shapes_stream(h, w, 20 ms, seed 0)``) from a fresh state, BER off."""
    st = synthetic.shapes_stream(height=h, width=w, duration_us=20_000,
                                 seed=0)
    assert len(st) >= e
    xy, ts = st.xy[:e].astype(np.int32), st.ts[:e].astype(np.int32)
    valid = np.ones((e,), bool)
    keep = stcf.stcf_chunked(stcf.fresh_sae(h, w), torch.from_numpy(xy),
                             torch.from_numpy(ts),
                             torch.from_numpy(valid))[1].numpy()
    assert 0 < keep.sum() < e
    want = bounds.k1_work(1, h, w, e, 7, xy[None], valid[None], keep[None],
                          False)[0]
    assert port.fused_bytes(h, w, e) == want
    if (h, w, e) == port.SIZES[0]:
        rows = {n: v for n, _, v in port.rows(smoke=True, device="cpu")}
        assert rows[f"fusedstep_{h}x{w}_E{e}_fused_hbm_bytes_per_chunk"] \
            == float(want)


def test_measured_column_is_zero_on_the_cpu(both):
    got, _ = both
    assert all(us == 0.0 for _, us, _ in got)


def test_roundtrips_are_counted_k1_calls(monkeypatch):
    """The row counts K1 calls per chunk of a fold: a step that made two
    calls per chunk would read 2."""
    d = {}
    port.rows(smoke=True, device="cpu", details=d)
    (det,) = d.values()
    assert det["k1_calls_per_chunk"] == 1.0 and det["n_chunks"] > 10
    assert det["measured"] is None and det["t_launch_s"] == port.T_LAUNCH_S
    orig = ops.fused_step_op_

    def twice(*a, **kw):
        ops.CALLS["fused_step"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "fused_step_op_", twice)
    rows = {n: v for n, _, v in port.rows(smoke=True, device="cpu")}
    assert rows["fusedstep_180x240_E256_fused_roundtrips_per_chunk"] == 2.0


def test_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.rows(smoke=True)


def test_bounds_are_the_h100_data_sheet():
    assert bounds.MEM_BPS == 3.35e12
    assert bounds.FP32_ROUNDED == bounds.FP32_OPS / 2
    assert bounds.TENSOR_FP16_FLOPS == 989e12
    assert bounds.INT32_OPS == 132 * 64 * 1.98e9
