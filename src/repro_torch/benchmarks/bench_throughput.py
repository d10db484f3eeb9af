"""Paper Fig. 1(b) / Fig. 10(d): supported event rate per method, plus the
measured software throughput of the TOS update spellings and of the batch
pipeline against its host-loop oracle.

The port of the reference's ``benchmarks/bench_throughput.py``, with its
row names and sizes.  The ``fig1b_*`` rows are the hardware model's Meps.
The ``sw_*`` rows time the plain PyTorch TOS updates on ``device`` (the
reference's software rows, not kernels; ``tos_update_sequential`` is a host
loop over the events) at 180x240 with E=1024.  The ``pipeline_*`` rows time
``run_pipeline`` (one host sync; the config's default backend ``"fused"``,
K1 + K2) against ``run_pipeline_reference`` (O(n_chunks) syncs; backend
``"nmc"``, K4 + K2, since the oracle has no fused spelling), both warmed
first; ``pipeline_*_host_syncs`` count the blocking transfers.  Every timed
window ends in a device synchronise.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import hwmodel as hw
from repro_torch.core import tos
from repro_torch.core.state import resolve_device


def _time(fn, *args, reps=3, device="cuda"):
    """Mean wall time of ``fn(*args)`` over ``reps`` calls after one warm
    call, each window closed by a synchronise of ``device``."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / reps


def rows(smoke: bool = False, device: str = "cuda"):
    device = resolve_device(device)
    out = []
    # Fig. 1(b): max throughput per method (hardware model)
    out.append(("fig1b_meps_eharris", 0.0, 0.15))         # [10]'s figure
    out.append(("fig1b_meps_conventional_luvharris", 0.0,
                hw.max_throughput_meps(1.2, nmc=False)))
    out.append(("fig1b_meps_nmc_tos_1.2V", 0.0, hw.max_throughput_meps(1.2)))
    out.append(("fig1b_meps_nmc_tos_0.6V", 0.0, hw.max_throughput_meps(0.6)))
    out.append(("fig1b_meps_davis240_bandwidth", 0.0, 12.0))

    # Measured software throughput: sequential against batched.
    rng = np.random.default_rng(0)
    h, w, e = 180, 240, 1024
    xy = torch.as_tensor(
        np.stack([rng.integers(0, w, e), rng.integers(0, h, e)], 1),
        dtype=torch.int32, device=device)
    valid = torch.ones((e,), dtype=torch.bool, device=device)
    surf = tos.tos_new(h, w, device=device)

    kw = dict(device=device)
    t_seq = _time(lambda: tos.tos_update_sequential(surf, xy, valid), **kw)
    t_bat = _time(lambda: tos.tos_update_batched(surf, xy, valid), **kw)
    t_one = _time(lambda: tos.tos_update_batched_onehot(surf, xy, valid),
                  **kw)
    out.append(("sw_seq_us_per_kevent", t_seq * 1e6, e / t_seq / 1e6))
    out.append(("sw_batched_us_per_kevent", t_bat * 1e6, e / t_bat / 1e6))
    out.append(("sw_onehot_us_per_kevent", t_one * 1e6, e / t_one / 1e6))
    out.append(("sw_batched_speedup_vs_seq", 0.0, t_seq / t_bat))
    out.extend(_pipeline_rows(smoke=smoke, device=device))
    return out


def _pipeline_rows(smoke: bool = False, device="cuda"):
    """The scan (``"fused"``) against the host-loop oracle (``"nmc"``):
    wall time per event and host syncs, both paths warmed first."""
    from repro_torch.core import pipeline as pipe
    from repro_torch.events import synthetic

    st = synthetic.shapes_stream(duration_us=10_000 if smoke else 60_000,
                                 seed=0)
    cfg = pipe.PipelineConfig(chunk=512, lut_every_chunks=2,
                              device=str(device))
    ref_cfg = dataclasses.replace(cfg, backend="nmc")
    n = len(st)

    pipe.run_pipeline(st.xy, st.ts, cfg)              # warm
    pipe.run_pipeline_reference(st.xy, st.ts, ref_cfg)
    t0 = time.perf_counter()
    r_scan = pipe.run_pipeline(st.xy, st.ts, cfg)     # ends in its fetch
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_ref = pipe.run_pipeline_reference(st.xy, st.ts, ref_cfg)
    t_ref = time.perf_counter() - t0

    return [
        ("pipeline_ref_us_per_event", t_ref * 1e6, t_ref / n * 1e6),
        ("pipeline_scan_us_per_event", t_scan * 1e6, t_scan / n * 1e6),
        ("pipeline_scan_speedup_vs_ref", 0.0, t_ref / t_scan),
        ("pipeline_ref_host_syncs", 0.0, float(r_ref.host_syncs)),
        ("pipeline_scan_host_syncs", 0.0, float(r_scan.host_syncs)),
    ]
