#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) with ``nvcc`` (CUDA toolkit).
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of this repository.  Phases, each printing its own lines:

  1. environment: the card's name and power limit, and the ``nvcc`` build
     of both kernels (``csrc/*.cu``, built in parallel for ``sm_90a``);
  2. K1 (fused chunk step) against its plain PyTorch version on the card,
     at 180x240 and 1280x720, 512 events, 1 and 4 lanes, BER off and on:
     every output must be equal;
  3. K2 (Harris response) against its plain version at both sizes, within
     ``1e-5 * max|R|``;
  4. end to end on the DAVIS240 sensor (180x240): ``run_pipeline`` with
     BER at a fixed 0.6 V and with online DVFS, on the card and on the CPU
     (plain versions), held to the parity bounds; PR-AUC printed;
  5. end to end at 1280x720 (an HD event sensor): events/s and ms per
     chunk; the launch counts of phases 4-5 must be nonzero for both
     kernels;
  6. per-kernel times (CUDA events) beside the plain versions' times and a
     bound from bytes and operations, a profile of the HD step, and the
     JSON summary line.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REL = 1e-5                   # LUT / score bound: |delta| <= REL * max|ref|
MEM_BPS = 3.35e12            # H100 SXM HBM3, bytes/s (data sheet)
FP32_OPS = 66.9e12           # H100 SXM float32 outside the tensor cores
INT32_OPS = 132 * 64 * 1.98e9   # 64 INT32 lanes per SM, 132 SMs, 1.98 GHz


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(rng, b, h, w, e, dev, *, inject):
    """A busy mid-stream state and one clustered chunk per lane."""
    import numpy as np
    import torch
    from repro_torch.core import ber as ber_mod
    from repro_torch.core import prng
    from repro_torch.core.stcf import NEVER
    tos = np.zeros((b, h, w), np.uint8)
    hot = rng.random((b, h, w)) < 0.3
    tos[hot] = rng.integers(225, 256, hot.sum())
    sae = np.full((b, h, w), NEVER, np.int32)
    seen = rng.random((b, h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    lut = rng.standard_normal((b, h, w)).astype(np.float32)
    centres = rng.integers(0, (w, h), (b, 8, 2))
    pick = centres[np.arange(b)[:, None], rng.integers(0, 8, (b, e))]
    xy = np.clip(pick + rng.integers(-6, 7, (b, e, 2)), 0, (w - 1, h - 1))
    ts = np.sort(rng.integers(25_000, 40_000, (b, e)), axis=1)
    valid = np.arange(e)[None].repeat(b, 0) < e - 7
    t = [torch.from_numpy(a).to(dev) for a in
         (tos, sae, lut, xy.astype(np.int32), ts.astype(np.int32), valid)]
    ber = torch.full((b,), 0.025 if inject else 0.0, device=dev)
    keys = torch.stack([prng.prng_key(i, device=dev) for i in range(b)])
    bits = (ber_mod.write_error_bits(keys, (h, w), ber) if inject else None)
    return t, ber, bits


def _covered(xy, mask, radius, h, w):
    """Distinct pixels within ``radius`` (square) of the masked events, per
    lane summed."""
    import numpy as np
    n = 0
    for lane_xy, lane_m in zip(xy, mask):
        hit = np.zeros((h, w), bool)
        x, y = lane_xy[lane_m, 0], lane_xy[lane_m, 1]
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                hit[np.clip(y + dy, 0, h - 1),
                    np.clip(x + dx, 0, w - 1)] = True
        n += int(hit.sum())
    return n


def k1_bound(b, h, w, e, patch, xy, valid, keep, inject):
    """Least time for one K1 call's work, updating the surfaces in place
    (the step drops the old state): events read and keep/scores written
    once; the SAE read over the valid events' 3x3 neighbourhoods and
    written at their centres; the LUT read at the kept centres; the TOS
    read and written over the kept patches, or over every pixel with the
    bits when injecting.  Integer operations: nine SAE tests per event, the
    patch writes, and four per pixel for BER.  Pixel counts are this
    chunk's distinct ones.  Also returns the bytes of the out-of-place
    call (both surfaces read and copied whole), for comparison."""
    r = patch // 2
    ev = b * e * (8 + 4 + 1) + b * e * (1 + 4)
    nbytes = ev + 4 * _covered(xy, valid, 1, h, w)
    nbytes += 4 * _covered(xy, valid, 0, h, w) + 4 * _covered(xy, keep, 0,
                                                              h, w)
    if inject:
        nbytes += b * h * w * (1 + 4 + 1) + b * 4
    else:
        nbytes += 2 * _covered(xy, keep, r, h, w)
    ops = 9 * int(valid.sum()) + int(keep.sum()) * patch * patch + (
        b * h * w * 4 if inject else 0)
    out_of_place = ev + b * h * w * 2 * (1 + 4) + 4 * int(keep.sum())
    out_of_place += (b * h * w * 4 + b * 4) if inject else 0
    t_b, t_o = nbytes / MEM_BPS, ops / INT32_OPS
    return (max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"),
            out_of_place / MEM_BPS * 1e3)


def k2_bound(b, h, w, sobel=5, window=5):
    """Least time for one K2 call: tos read and R written once; float32
    operations of a separable form: ``/255``, each Sobel gradient as a
    column and a row pass over its factors' nonzero taps (an FMA, two
    operations, per tap) on the window halo, three products, each of the
    three box sums as two passes of ``window - 1`` adds, and the det/trace
    tail."""
    import numpy as np
    from repro_torch.core.harris import sobel_kernels
    taps = 0
    for g in map(np.asarray, sobel_kernels(sobel)):
        taps += (np.count_nonzero(g.any(axis=1))
                 + np.count_nonzero(g.any(axis=0))
                 if np.linalg.matrix_rank(g) == 1 else np.count_nonzero(g))
    rw = window // 2
    grad = b * (h + 2 * rw) * (w + 2 * rw)
    ops = grad * (1 + 2 * taps + 3) + b * h * w * (3 * 2 * (window - 1) + 7)
    nbytes = b * h * w * (1 + 4)
    t_b, t_o = nbytes / MEM_BPS, int(ops) / FP32_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def close(got, want):
    """Max |delta| over finite entries; raises unless -inf positions match
    and |delta| <= REL * max|want|."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), fin) or not np.array_equal(
            got[~fin], want[~fin]):
        raise AssertionError("non-finite positions differ")
    if not fin.any():
        return 0.0
    err = float(np.abs(got[fin] - want[fin]).max())
    bound = REL * float(np.abs(want[fin]).max())
    if err > bound:
        raise AssertionError(f"max |delta| {err:.3g} > bound {bound:.3g}")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import ber as ber_mod
    from repro_torch.core import pipeline, pr_eval, prng
    from repro_torch.events import synthetic
    from repro_torch.kernels import _build, fused_step, harris_conv, ops

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[env] nvcc build of {sorted(logs)} took "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] ptxas {name}: {line.strip()}")

    # --- 2. K1 against its plain version -------------------------------
    rng = np.random.default_rng(0)
    k1_err = 0.0
    kw = dict(patch=7, th=225, support=2, tw=5000, stcf_enabled=True)
    for h, w in ((180, 240), (720, 1280)):
        for b in (1, 4):
            for inject in (False, True):
                ins, ber, bits = k1_inputs(rng, b, h, w, 512, dev,
                                           inject=inject)
                plain = fused_step.fused_step_ref(*ins, ber, bits, **kw)
                got = fused_step.fused_step_cuda(*ins, ber, bits, **kw)
                torch.cuda.synchronize()
                for name, p, g in zip(("tos", "sae", "keep", "scores"),
                                      plain, got):
                    if not torch.equal(p, g):
                        raise AssertionError(
                            f"K1 {name} differs at {h}x{w} B={b} "
                            f"ber={inject}")
                    fin = torch.isfinite(p.double())
                    if fin.any():
                        k1_err = max(k1_err, float(
                            (p.double() - g.double())[fin].abs().max()))
                print(f"[K1] {h}x{w} B={b} ber={'on' if inject else 'off'}: "
                      f"tos, sae, keep, scores equal "
                      f"(kept {int(plain[2].sum())}/{b * 512})")

    # --- 3. K2 against its plain version -------------------------------
    k2_err = 0.0
    for h, w in ((180, 240), (720, 1280)):
        for b in (1, 4):
            tos = k1_inputs(rng, b, h, w, 8, dev, inject=False)[0][0]
            plain = harris_conv.harris_ref(tos)
            got = harris_conv.harris_cuda(tos)
            err = close(got.cpu().numpy(), plain.cpu().numpy())
            k2_err = max(k2_err, err)
            print(f"[K2] {h}x{w} B={b}: max |delta| {err:.3g} "
                  f"(max|R| {float(plain.abs().max()):.3g}, bit-equal "
                  f"{torch.equal(got, plain)})")

    # --- 4/5. the main path: run_pipeline on the card ------------------
    davis = synthetic.shapes_stream(duration_us=200_000, seed=0)
    hd = synthetic.shapes_stream(height=720, width=1280,
                                 duration_us=100_000, n_shapes=12,
                                 signal_rate_per_us=2.0,
                                 noise_rate_per_us=0.5, seed=0)
    davis_cfgs = {
        "ber_0.6V": dict(inject_ber=True, vdd=0.6),
        "dvfs_online": dict(dvfs=True, dvfs_online=True),
    }
    hd_cfg = pipeline.PipelineConfig(height=720, width=1280, chunk=512,
                                     lut_every_chunks=2, dvfs=True,
                                     dvfs_online=True, inject_ber=True)
    pipeline.run_pipeline(hd.xy[:4096], hd.ts[:4096], hd_cfg)   # warm-up

    ops.reset_launch_counts()
    gpu_runs, gpu_s = {}, {}
    for name, extra in davis_cfgs.items():
        cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                      patch=7, th=225, **extra)
        t0 = time.perf_counter()
        gpu_runs[name] = pipeline.run_pipeline(davis.xy, davis.ts, cfg)
        gpu_s[name] = time.perf_counter() - t0
    lanes = 4
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2, patch=7,
                                  th=225, **davis_cfgs["ber_0.6V"])
    t0 = time.perf_counter()
    batch = pipeline.run_pipeline_batched(
        np.stack([davis.xy] * lanes), np.stack([davis.ts] * lanes), cfg,
        seeds=list(range(lanes)))
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd_res = pipeline.run_pipeline(hd.xy, hd.ts, hd_cfg)
    torch.cuda.synchronize()
    hd_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"[main] launches on the main path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    for name, extra in davis_cfgs.items():
        cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                      patch=7, th=225, device="cpu", **extra)
        want = pipeline.run_pipeline(davis.xy, davis.ts, cfg)
        got = gpu_runs[name]
        for field in ("kept", "tos", "vdd_trace"):
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"DAVIS240 {name}: {field} differs")
        if (got.energy_pj, got.host_syncs) != (want.energy_pj, 1):
            raise AssertionError(f"DAVIS240 {name}: energy books differ")
        err_s = close(got.scores, want.scores)
        err_l = close(got.lut, want.lut)
        ok = np.isfinite(want.scores)
        auc_g = pr_eval.pr_auc(got.scores[ok], davis.is_corner[ok])
        auc_c = pr_eval.pr_auc(want.scores[ok], davis.is_corner[ok])
        if abs(auc_g - auc_c) > 1e-3:
            raise AssertionError(f"DAVIS240 {name}: PR-AUC {auc_g} vs "
                                 f"{auc_c}")
        print(f"[davis240] {name}: {len(davis)} events, kept/tos/vdd/energy "
              f"equal to CPU, scores max|delta| {err_s:.3g}, lut max|delta| "
              f"{err_l:.3g}, PR-AUC cuda {auc_g:.6f} cpu {auc_c:.6f}, "
              f"host_syncs {got.host_syncs}")

    one = gpu_runs["ber_0.6V"]
    for field in ("scores", "kept", "tos", "lut"):
        if not np.array_equal(getattr(batch[0], field), getattr(one, field)):
            raise AssertionError(f"batched lane 0 {field} differs from the "
                                 f"single-stream run")
    if np.array_equal(batch[1].tos, one.tos):
        raise AssertionError("lanes with other seeds drew the same bits")
    print(f"[davis240] {smi}: ber_0.6V single stream {gpu_s['ber_0.6V']:.3f}"
          f" s = {len(davis) / gpu_s['ber_0.6V']:.0f} events/s; "
          f"run_pipeline_batched x{lanes} lanes {batch_s:.3f} s = "
          f"{lanes * len(davis) / batch_s:.0f} events/s, lane 0 equal to "
          f"the single run, other seeds differ")

    n_chunks = -(-len(hd) // hd_cfg.chunk)
    if not (np.isfinite(hd_res.lut).all() and hd_res.tos.shape == (720, 1280)
            and hd_res.kept.any()):
        raise AssertionError("HD run produced a malformed result")
    print(f"[hd] 1280x720: {len(hd)} events in {n_chunks} chunks of 512, "
          f"{hd_s:.3f} s wall = {len(hd) / hd_s:.0f} events/s, "
          f"{hd_s / n_chunks * 1e3:.3f} ms/chunk (host clock, incl. "
          f"upload and one fetch), kept {hd_res.kept.mean():.3f}, "
          f"vdd picks {sorted(set(hd_res.vdd_trace.tolist()))}")

    # --- 6. times at the main path's shapes ----------------------------
    b, h, w, e = 1, 720, 1280, 512
    ins, ber, bits = k1_inputs(rng, b, h, w, e, dev, inject=True)
    keep = fused_step.fused_step_cuda(*ins, ber, bits, **kw)[2]
    k1_ms = cuda_ms(lambda: fused_step.fused_step_cuda(*ins, ber, bits, **kw))
    k1_plain = cuda_ms(lambda: fused_step.fused_step_ref(*ins, ber, bits,
                                                         **kw), iters=5)
    k1_bms, k1_by, k1_oop = k1_bound(
        b, h, w, e, 7, ins[3].cpu().numpy(), ins[5].cpu().numpy(),
        keep.cpu().numpy(), True)
    tos = ins[0]
    k2_ms = cuda_ms(lambda: harris_conv.harris_cuda(tos))
    k2_plain = cuda_ms(lambda: harris_conv.harris_ref(tos), iters=10)
    k2_bms, k2_by = k2_bound(b, h, w)
    key = prng.prng_key(0, device=dev)[None]
    prng_ms = cuda_ms(lambda: ber_mod.write_error_bits(key, (h, w), ber),
                      iters=10)
    print(f"[time] {smi}: K1 {k1_ms:.4f} ms (plain {k1_plain:.4f} ms, "
          f"bound {k1_bms:.5f} ms by {k1_by} in place, {k1_oop:.5f} ms "
          f"by bytes out of place); K2 {k2_ms:.4f} ms (plain "
          f"{k2_plain:.4f} ms, bound {k2_bms:.5f} ms by {k2_by}); threefry "
          f"BER draw (plain torch, 1280x720x5) {prng_ms:.4f} ms")

    # Profile of a short steady window of the HD step.
    from torch.profiler import ProfilerActivity, profile
    win = slice(0, 64 * hd_cfg.chunk)
    pipeline.run_pipeline(hd.xy[win], hd.ts[win], hd_cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.run_pipeline(hd.xy[win], hd.ts[win], hd_cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side rows only (kernels, copies): an aten op's row repeats the
    # device time of the kernels it launched.
    rows = [r for r in prof.key_averages()
            if str(r.device_type).endswith("CUDA")
            and r.self_device_time_total > 0]
    rows.sort(key=lambda r: -r.self_device_time_total)
    groups = {"K1 fused_step.cu": ("stcf_score", "tos_patch", "ber_apply"),
              "K2 harris.cu": ("harris_kernel",), "copies": ("Memcpy",
                                                             "Memset")}
    per = {g: 0.0 for g in (*groups, "plain torch (threefry, DVFS, ...)")}
    for r in rows:
        g = next((g for g, keys in groups.items()
                  if any(k in r.key for k in keys)),
                 "plain torch (threefry, DVFS, ...)")
        per[g] += r.self_device_time_total / 1e3
    dev_ms = sum(per.values())
    print(f"[profile] {smi}: HD, 64 chunks: wall {wall_ms:.2f} ms, device "
          f"busy {dev_ms:.2f} ms, idle share {1 - dev_ms / wall_ms:.3f}")
    for g, ms in per.items():
        print(f"[profile]   {g}: {ms:.3f} ms ({ms / 64 * 1e3:.1f} us/chunk)")
    ours = ("stcf_score", "tos_patch", "ber_apply", "harris_kernel",
            "Memcpy")
    for i, r in enumerate(rows):
        if i < 10 or any(k in r.key for k in ours):
            print(f"[profile]   {r.self_device_time_total / 1e3:9.3f} ms "
                  f"x{r.count:<5d} {r.key[:90]}")

    kernels = [
        {"name": "fused_step", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_step.cu",
         "replaces": "src/repro/kernels/fused_step.py:154",
         "launches": launches["fused_step"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bms,
         "bound_by": k1_by, "library_ms": None},
        {"name": "harris", "route": "cuda",
         "source": "src/repro_torch/csrc/harris.cu",
         "replaces": "src/repro/kernels/harris_conv.py:101",
         "launches": launches["harris"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bms,
         "bound_by": k2_by, "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
