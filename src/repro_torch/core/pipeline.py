"""Batch entry points (``repro.core.pipeline``): fold a whole event stream
through the detector and return per-event corner scores.

    events -> STCF denoise -> (DVFS picks Vdd) -> TOS update
           -> [BER injection at the chosen Vdd] -> Harris LUT
           -> per-event corner scores

``run_pipeline`` prepares the stream on the host (chunking, int64 -> int32
timestamp rebase, precomputed DVFS riders), uploads it once, folds every
chunk with ``state.detector_step`` on the configured device, and fetches the
results in one transfer (``host_syncs == 1``).  ``run_pipeline_batched``
does the same for B equal-length streams as B lanes of one state, so each
chunk is one kernel launch for all lanes.

Backends: ``"fused"`` (default; twin of the reference's ``"pallas_fused"``)
runs the chunk block as kernel K1 and the LUT refresh as kernel K2 on a CUDA
device; ``"torch"`` (twin of ``"jnp"``) composes the plain operators.  The
device is ``cfg.device``: ``"cuda"`` by default, ``"cpu"`` where asked.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import hwmodel
from repro_torch.core import state as state_mod
from repro_torch.events import stream as stream_mod

__all__ = [
    "BACKENDS",
    "PipelineConfig",
    "PipelineResult",
    "chunk_ts_base",
    "run_pipeline",
    "run_pipeline_batched",
]

BACKENDS = ("fused", "torch")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    height: int = 180
    width: int = 240
    patch: int = 7
    th: int = 225
    chunk: int = 256
    lut_every_chunks: int = 4
    stcf_enabled: bool = True
    stcf_tw_us: int = 5000
    stcf_support: int = 2
    sobel_size: int = 5
    window_size: int = 5
    harris_k: float = 0.04
    # hardware simulation
    vdd: float = 1.2                 # fixed Vdd if dvfs disabled
    dvfs: bool = False
    dvfs_online: bool = False        # in-step streaming controller
    dvfs_cfg: dvfs_mod.DvfsConfig = dataclasses.field(
        default_factory=dvfs_mod.DvfsConfig
    )
    inject_ber: bool = False
    seed: int = 0
    use_onehot_update: bool = False  # reference's MXU spelling; False only
    # execution
    backend: str = "fused"           # one of BACKENDS
    interpret: Optional[bool] = None  # reference's Pallas flag; None only
    device: str = "cuda"

    def __post_init__(self):
        # The reference's field names are kept; a value that chooses a
        # spelling which exists only in the reference is refused.
        if self.use_onehot_update:
            raise ValueError(
                "use_onehot_update selects the reference's one-hot MXU "
                "spelling of the TOS update; the port has no such spelling")
        if self.interpret is not None:
            raise ValueError(
                "interpret selects the reference's Pallas interpret mode; "
                "the port picks plain versions by device (device='cpu')")


@dataclasses.dataclass
class PipelineResult:
    scores: np.ndarray          # per-event Harris-LUT score (-inf = filtered)
    kept: np.ndarray            # survived STCF
    tos: np.ndarray             # final surface
    lut: np.ndarray             # final Harris LUT
    vdd_trace: np.ndarray       # per-chunk operating voltage
    energy_pj: float            # total dynamic energy (hw model)
    latency_ns_per_event: float # mean modelled latency
    host_syncs: int = 1         # blocking device->host transfers


def _device(cfg: PipelineConfig) -> torch.device:
    """The run's device; asking for CUDA without it raises (never a silent
    CPU run)."""
    if cfg.backend not in BACKENDS:
        raise ValueError(
            f"backend {cfg.backend!r} is not in the port: use 'fused' (the "
            f"twin of 'pallas_fused') or 'torch' (the twin of 'jnp'); "
            f"'pallas_nmc' and 'pallas_batched' need the TPU kernels K4-K7, "
            f"which are not ported yet")
    return state_mod.resolve_device(cfg.device)


def _is_online(cfg: PipelineConfig) -> bool:
    return bool(cfg.dvfs and cfg.dvfs_online)


def chunk_ts_base(ts_us: np.ndarray, cfg: PipelineConfig) -> int:
    """Per-stream rebase for device timestamps (int64 host -> int32 device),
    aligned down to a DVFS half-window multiple."""
    if len(ts_us) == 0:
        return 0
    half = cfg.dvfs_cfg.half_us
    return (int(ts_us[0]) // half) * half


def _chunk_vdd(ts, n_chunks, n_events, cfg) -> np.ndarray:
    if cfg.dvfs:
        return dvfs_mod.per_chunk_vdd(
            ts, n_chunks, cfg.chunk, cfg.dvfs_cfg, n_events=n_events
        )
    return np.full((n_chunks,), cfg.vdd, np.float64)


def _accounting(n_kept, vdd) -> tuple[float, float]:
    """Chunk-ordered float64 energy/latency accumulation (hw model)."""
    energy_pj = 0.0
    latency_ns = 0.0
    for nk, v in zip(n_kept, vdd):
        energy_pj += int(nk) * hwmodel.patch_energy_pj(float(v))
        latency_ns += int(nk) * hwmodel.patch_latency_ns(float(v))
    return energy_pj, latency_ns


class _Prepared(NamedTuple):
    cxy: np.ndarray          # (C, chunk, 2) int32
    cts: np.ndarray          # (C, chunk) int32, chunk-relative
    cval: np.ndarray         # (C, chunk) bool
    n_events: int
    vdd_arr: Optional[np.ndarray]   # (C,) float64; None in online mode
    ber: np.ndarray          # (C,) float32
    e_coef: np.ndarray       # (C,) float32
    l_coef: np.ndarray       # (C,) float32


def _prepare(xy, ts_us, cfg: PipelineConfig) -> _Prepared:
    xy = np.asarray(xy, dtype=np.int32)
    ts = np.asarray(ts_us, dtype=np.int64)
    cxy, cts64, cval, n_events = stream_mod.stack_chunks(xy, ts, cfg.chunk)
    n_chunks = cxy.shape[0]
    cts = (cts64 - chunk_ts_base(ts, cfg)).astype(np.int32)
    vdd_arr = (
        None if _is_online(cfg) else _chunk_vdd(ts, n_chunks, n_events, cfg)
    )
    ber, e_coef, l_coef = state_mod.chunk_input_riders(n_chunks, vdd_arr, cfg)
    return _Prepared(cxy, cts, cval, n_events, vdd_arr, ber, e_coef, l_coef)


def _chunk_inputs(preps: Sequence[_Prepared],
                  device) -> state_mod.ChunkInput:
    """Lane-stacked ``(C, B, ...)`` chunk tensors, uploaded once."""
    def up(field):
        return torch.from_numpy(
            np.stack([getattr(p, field) for p in preps], axis=1)
        ).to(device)

    return state_mod.ChunkInput(
        xy=up("cxy"), ts=up("cts"), valid=up("cval"), ber=up("ber"),
        energy_coef=up("e_coef"), latency_coef=up("l_coef"),
    )


def _fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy several device tensors to the host in ONE blocking transfer:
    their bytes are packed into one buffer on the device first."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[off:off + n].view(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def _vdd_trace(prep: _Prepared, vdd_idx: np.ndarray,
               cfg: PipelineConfig) -> np.ndarray:
    """Per-chunk float64 Vdd: the precomputed array, or the online picks."""
    if prep.vdd_arr is not None:
        return prep.vdd_arr
    tab = dvfs_mod.op_point_table(cfg.dvfs_cfg)
    return tab.vdd64[np.asarray(vdd_idx, np.int64)]


def _finalize(n_events, vdd_arr, surface, lut, scores, keep,
              n_kept) -> PipelineResult:
    scores = np.asarray(scores, np.float32).reshape(-1)[:n_events]
    kept = np.asarray(keep, bool).reshape(-1)[:n_events]
    energy_pj, latency_ns = _accounting(np.asarray(n_kept), vdd_arr)
    n_scored = max(int(kept.sum()), 1)
    return PipelineResult(
        scores=scores,
        kept=kept,
        tos=np.asarray(surface),
        lut=np.asarray(lut),
        vdd_trace=vdd_arr,
        energy_pj=energy_pj,
        latency_ns_per_event=latency_ns / n_scored,
        host_syncs=1,
    )


def run_pipeline_batched(
    xy: np.ndarray,
    ts_us: np.ndarray,
    cfg: PipelineConfig = PipelineConfig(),
    *,
    seeds: Optional[Sequence[int]] = None,
) -> list[PipelineResult]:
    """Run B independent equal-length streams as B lanes of one state.

    ``xy``: (B, E, 2), ``ts_us``: (B, E), each row time-sorted.  Result
    ``i`` equals ``run_pipeline(xy[i], ts_us[i], cfg)`` with ``seeds[i]``
    (default ``cfg.seed``) as that stream's PRNG seed.  One host sync.
    """
    device = _device(cfg)
    xy = np.asarray(xy, dtype=np.int32)
    ts = np.asarray(ts_us, dtype=np.int64)
    b = xy.shape[0]
    seeds = [cfg.seed] * b if seeds is None else list(seeds)
    preps = [_prepare(xy[i], ts[i], cfg) for i in range(b)]

    state = state_mod.detector_init(cfg, seed=seeds, device=device)
    fin, outs = state_mod.detector_scan(cfg, state,
                                        _chunk_inputs(preps, device))
    surface, lut, scores, keep, n_kept, vdd_idx = _fetch(   # sync #1
        fin.surface, fin.lut, outs.scores, outs.keep, outs.n_kept,
        outs.vdd_idx)

    results = []
    for i in range(b):
        vdd_arr = _vdd_trace(preps[i], vdd_idx[:, i], cfg)
        results.append(_finalize(preps[i].n_events, vdd_arr, surface[i],
                                 lut[i], scores[:, i], keep[:, i],
                                 n_kept[:, i]))
    return results


def run_pipeline(
    xy: np.ndarray,
    ts_us: np.ndarray,
    cfg: PipelineConfig = PipelineConfig(),
) -> PipelineResult:
    """Fold a time-sorted event stream through the full detector on
    ``cfg.device``; the host blocks once, on the final fetch."""
    return run_pipeline_batched(np.asarray(xy)[None], np.asarray(ts_us)[None],
                                cfg)[0]
