"""Cost model of the TOS kernels on the H100: the port of the reference's
``benchmarks/bench_tos_kernels.py``, with its row names, order and sizes
(smoke: 180x240 with E=256; full: also 720x1280 with E=1024).

The work is the reference's own; only the rates are the card's
(``benchmarks.bounds``, NVIDIA's data sheet for the H100 SXM at 700 W).
Per size, 12 ``tos_kernel_*`` rows:

* ``{stream,batched,onehot}_*_s``: the reference's roofline terms of its
  three formulations of one chunk's TOS update (``kernel_terms``: the
  event-serial stream kernel, the event-parallel scatter counts, the
  one-hot matmul), in seconds.  ``_vpu_s`` is the integer operations on
  the CUDA cores at ``INT32_OPS``; ``_mxu_s`` the one-hot product's FLOPs
  on the tensor cores at the dense fp16 peak (``TENSOR_FP16_FLOPS``);
  ``_hbm_s`` the bytes at ``MEM_BPS``.
* ``stream_meps`` / ``onehot_meps``: E over the formulation's dominant
  term, in Mevents/s.
* ``bin_mean_frac`` / ``bin_max_frac``: the mean and the largest share of
  the E events whose patch touches one 128x128 tile, after
  ``kernels.tos_update.bin_events_to_tiles``, on the first E events of
  ``synthetic.shapes_stream(h, w, 20 ms, seed 0)`` ("the chunk" below);
  ``binned_stream_meps``: the stream term scaled by the busiest tile's
  share.

and 6 ``fusedstep_*`` rows, the fused chunk step against the reference's
unfused 4-op pipeline (STCF, TOS update, BER, score):

* ``unfused_hbm_bytes_per_chunk``: the reference's accounting of the four
  ops, each round-tripping its surfaces through HBM (``fused_terms``).
* ``fused_hbm_bytes_per_chunk``: the port's K1 in place without BER on the
  chunk from a fresh state (``bounds.k1_work``).  K1 keeps no surface
  resident, so only the pixels the chunk touches move; the reference's
  TPU kernel paid a whole LUT read for VMEM residency instead.
* ``unfused_roundtrips_per_chunk``: 4, one per op of the plain path.
* ``fused_roundtrips_per_chunk``: kernel round-trips per chunk, the step
  operations that round-trip the step's surface state through HBM;
  counted, as K1 calls (``ops.LAUNCHES`` on the card, ``ops.CALLS`` on
  the CPU) per chunk over a fold of the stream through ``run_pipeline``
  (backend ``"fused"``, chunk E).  One K1 call is two kernel launches,
  ``stcf_score_kernel`` then ``fused_tile_kernel`` (``csrc/fused_step.cu``):
  the first writes no surface, only E-sized records for the second, which
  reads and writes the surfaces once.
* ``{unfused,fused}_events_per_s``: E over the launches times the launch
  floor, plus the bytes at ``MEM_BPS``, plus the reference's shared stream
  operation term; the unfused path has 4 launches, K1 2.  The launch
  floor is an empty kernel launch by CUDA events, measured in the same
  run, on the card; on the CPU ``T_LAUNCH_S``.

``us_per_call`` is 0.0 on the CPU, as in the reference.  On the card it
is the device time per call (the profiler's; CUDA events when it records
nothing) of the port kernel that implements the row's formulation, on the
chunk from a fresh state: ``stream_meps`` K4 (``nmc``),
``binned_stream_meps`` K6 (``nmc_binned``, cap E), ``onehot_meps`` K5
(``batched``, the counts on the tensor cores) and
``fusedstep_*_fused_events_per_s`` K1 in place without BER.  These timing
calls go to the kernels directly and are not counted in ``ops.LAUNCHES``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.bounds import (INT32_OPS, MEM_BPS,
                                           TENSOR_FP16_FLOPS, k1_bound,
                                           k1_work, tos_bound)
from repro_torch.core.state import resolve_device

__all__ = ["SIZES", "T_LAUNCH_S", "kernel_terms", "fused_terms",
           "binned_chunk", "binned_fraction", "fused_bytes", "measure",
           "rows"]

SIZES = ((180, 240, 256), (720, 1280, 1024))

# An empty kernel's launch (every block returning at once), measured by
# tools/tos_count_phases.py on an NVIDIA H100 80GB HBM3 at 700 W: the
# launch floor where no card measures one.
T_LAUNCH_S = 0.97e-6


def kernel_terms(h=720, w=1280, e=1024, patch=7):
    """Roofline terms (seconds per chunk) of the reference's three
    formulations, its work counts at the H100's rates."""
    px = h * w
    out = {}
    # (a) the stream kernel: per event a masked decrement over the tile
    # (compare, select, subtract per pixel), the surface read and written
    # once per chunk.
    out["stream_vpu_s"] = e * px * 3.0 / INT32_OPS
    out["stream_hbm_s"] = 2 * px * 1 / MEM_BPS
    # (b) event-parallel scatter counts: E*P^2 scatter-adds, the E^2
    # suffix pass, the O(px) apply.
    out["batched_vpu_s"] = (e * patch * patch * 4 + e * e * 2
                            + px * 4) / INT32_OPS
    out["batched_hbm_s"] = 2 * px / MEM_BPS
    # (c) one-hot matmul: counts = (H, E) x (E, W).
    out["onehot_mxu_s"] = 2.0 * h * e * w / TENSOR_FP16_FLOPS
    out["onehot_vpu_s"] = (e * (h + w) + e * e * 2 + px * 4) / INT32_OPS
    out["onehot_hbm_s"] = 2 * px / MEM_BPS
    return out


def fused_terms(h, w, e, fused_bytes, roundtrips, t_launch):
    """The ``fusedstep_*`` rows (see the module docstring): the unfused
    4-op bytes by the reference's accounting, K1's bytes ``fused_bytes``
    and its counted ``roundtrips``."""
    px = h * w
    ev_bytes = e * 4 * 4               # (E, 4) int32 chunk upload
    unfused_bytes = (
        (px * 4 + ev_bytes + px * 4 + e * 4)  # stcf: SAE in/out, keep out
        + (px + ev_bytes + px)                # tos update: TOS in/out
        + (px + px)                           # ber inject: TOS in/out
        + (e * 4 + e * 4)                     # score: LUT gather, scores
    )
    ops_s = e * px * 3.0 / INT32_OPS   # the stream term, same both ways
    unfused_s = 4 * t_launch + unfused_bytes / MEM_BPS + ops_s
    fused_s = 2 * t_launch + fused_bytes / MEM_BPS + ops_s
    return {
        "unfused_hbm_bytes_per_chunk": float(unfused_bytes),
        "fused_hbm_bytes_per_chunk": float(fused_bytes),
        "unfused_roundtrips_per_chunk": 4.0,
        "fused_roundtrips_per_chunk": float(roundtrips),
        "unfused_events_per_s": e / unfused_s,
        "fused_events_per_s": e / fused_s,
    }


def _stream(h, w):
    from repro_torch.events import synthetic
    return synthetic.shapes_stream(height=h, width=w, duration_us=20_000,
                                   seed=0)


def binned_chunk(h, w, e):
    """The chunk: the first ``e`` events of the 20 ms shapes stream at
    ``h x w``, padded as the reference pads (``xy`` 0, invalid); numpy
    ``(xy (E, 2) int32, ts (E,) int32, valid (E,) bool)``."""
    st = _stream(h, w)
    n = min(e, len(st))
    xy = np.zeros((e, 2), np.int32)
    ts = np.full((e,), st.ts[n - 1], np.int32)
    xy[:n], ts[:n] = st.xy[:n], st.ts[:n]
    return xy, ts, np.arange(e) < n


def binned_fraction(h, w, e, patch=7):
    """Mean and largest per-tile event share of the chunk after binning
    by 128x128 tile (cap E, lossless)."""
    from repro_torch.kernels.tos_update import _grid, bin_events_to_tiles
    xy, _, valid = binned_chunk(h, w, e)
    binned, _ = bin_events_to_tiles(torch.from_numpy(xy),
                                    torch.from_numpy(valid),
                                    grid_hw=_grid(h, w), patch=patch, cap=e)
    per_tile = binned[..., 2].sum(-1).numpy()
    return float(per_tile.mean()) / e, float(per_tile.max()) / e


def _stcf_kw():
    """The pipeline's default STCF support and window."""
    from repro_torch.core import pipeline
    cfg = pipeline.PipelineConfig(device="cpu")
    return dict(support=cfg.stcf_support, tw=cfg.stcf_tw_us)


def _chunk_keep(h, w, xy, ts, valid):
    """K1's keep of the chunk from a fresh state (the plain STCF)."""
    from repro_torch.core import stcf
    return stcf.stcf_chunked(
        stcf.fresh_sae(h, w), torch.from_numpy(xy), torch.from_numpy(ts),
        torch.from_numpy(valid), **_stcf_kw())[1].numpy()


def fused_bytes(h, w, e, patch=7):
    """K1's bytes in place without BER on the chunk from a fresh state."""
    xy, ts, valid = binned_chunk(h, w, e)
    keep = _chunk_keep(h, w, xy, ts, valid)
    return k1_work(1, h, w, e, patch, xy[None], valid[None], keep[None],
                   False)[0]


def _k1_calls_per_chunk(h, w, e, device):
    """K1 calls per chunk over a fold of the 20 ms stream through
    ``run_pipeline(backend="fused")``, and the number of chunks."""
    from repro_torch.core import pipeline
    from repro_torch.kernels import ops
    st = _stream(h, w)
    cfg = pipeline.PipelineConfig(height=h, width=w, chunk=e,
                                  backend="fused", device=str(device))
    counts = ops.LAUNCHES if device.type == "cuda" else ops.CALLS
    before = counts["fused_step"]
    pipeline.run_pipeline(st.xy, st.ts, cfg)
    n_chunks = -(-len(st) // e)
    return (counts["fused_step"] - before) / n_chunks, n_chunks


def measure(h, w, e, device, *, patch=7, th=225, iters=30):
    """On the card: device ms per call of K4, K6 (cap E), K5 and K1 (in
    place, without BER) on the chunk from a fresh state, each beside its
    bound (``bounds``; ms, and what bounds it)."""
    from repro_torch.benchmarks.timing import device_ms
    from repro_torch.core.stcf import NEVER
    from repro_torch.kernels import fused_step, ops, tos_update
    xy_np, ts_np, valid_np = binned_chunk(h, w, e)
    keep_np = _chunk_keep(h, w, xy_np, ts_np, valid_np)
    xy, ts, valid = (torch.from_numpy(a)[None].to(device)
                     for a in (xy_np, ts_np, valid_np))
    tos = torch.zeros((1, h, w), dtype=torch.uint8, device=device)
    out = {}
    kw = dict(patch=patch, th=th)
    centre = ops.centre_surface((h, w), xy, valid, **kw)
    for mode in ("nmc", "nmc_binned", "batched"):
        kern = getattr(tos_update, f"{ops.TOS_MODES[mode]}_cuda")
        extra = (centre,) if mode == "batched" else ()
        ckw = dict(kw, cap=e) if mode.endswith("binned") else kw
        out[mode] = dict(
            ms=device_ms(lambda: kern(tos, xy, valid, *extra, **ckw),
                         iters=iters),
            bound=tos_bound(1, h, w, e, patch, valid_np, centre=bool(extra)))

    sae = torch.full((1, h, w), NEVER, dtype=torch.int32, device=device)
    lut = torch.zeros((1, h, w), dtype=torch.float32, device=device)
    # Each call steps a fresh copy of the state, made before the timed
    # window: warm-up, three profiler windows and a CUDA-event fallback.
    states = iter([(tos.clone(), sae.clone()) for _ in range(4 * iters + 3)])
    k1kw = dict(patch=patch, th=th, stcf_enabled=True, **_stcf_kw())
    out["fused_step"] = dict(
        ms=device_ms(lambda: fused_step.fused_step_cuda_(
            *next(states), lut, xy, ts, valid, None, None, **k1kw),
            iters=iters),
        bound=k1_bound(1, h, w, e, patch, xy_np[None], valid_np[None],
                       keep_np[None], False)[:2])
    return out


def rows(smoke: bool = False, device: str = "cuda", *, details=None):
    """The reference's rows at its sizes; ``details``, a dict if given,
    gets per size ``{"measured": measure(...) or None, "k1_calls_per_chunk",
    "n_chunks", "t_launch_s"}``."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        from repro_torch.benchmarks.timing import launch_floor_ms
        t_launch = launch_floor_ms() / 1e3
    else:
        t_launch = T_LAUNCH_S
    out = []
    for (h, w, e) in SIZES[:1] if smoke else SIZES:
        pre = f"tos_kernel_{h}x{w}_E{e}_"
        got = measure(h, w, e, device) if on_card else {}
        us = {k: v["ms"] * 1e3 for k, v in got.items()}
        t = kernel_terms(h, w, e)
        out += [(pre + k, 0.0, v) for k, v in t.items()]
        stream = max(t["stream_vpu_s"], t["stream_hbm_s"])
        onehot = max(t["onehot_mxu_s"], t["onehot_vpu_s"],
                     t["onehot_hbm_s"])
        out.append((pre + "stream_meps", us.get("nmc", 0.0),
                    e / stream / 1e6))
        out.append((pre + "onehot_meps", us.get("batched", 0.0),
                    e / onehot / 1e6))
        mean_f, max_f = binned_fraction(h, w, e)
        out.append((pre + "bin_mean_frac", 0.0, mean_f))
        out.append((pre + "bin_max_frac", 0.0, max_f))
        out.append((pre + "binned_stream_meps", us.get("nmc_binned", 0.0),
                    e / (stream * max_f) / 1e6))

        calls, n_chunks = _k1_calls_per_chunk(h, w, e, device)
        fused = fused_terms(h, w, e, fused_bytes(h, w, e), calls, t_launch)
        for k, v in fused.items():
            out.append((f"fusedstep_{h}x{w}_E{e}_{k}",
                        us.get("fused_step", 0.0)
                        if k == "fused_events_per_s" else 0.0, v))
        if details is not None:
            details[(h, w, e)] = dict(measured=got or None,
                                      k1_calls_per_chunk=calls,
                                      n_chunks=n_chunks, t_launch_s=t_launch)
    return out

