"""The detector's state and its one-chunk step (``repro.core.state``).

``DetectorState`` carries B camera lanes that advance in lockstep: every
tensor leaf has a leading lane axis, on the state's device.  The chunk
cursor, ``lut_ready`` and the ``ControlState`` knobs are host values shared
by the lanes — the host sets them and they advance deterministically — so
the LUT-refresh decision needs no device read and a whole stream folds with
a single host sync at the end.

``detector_step`` folds one chunk into every lane:

    [online DVFS picks the operating point] -> STCF -> TOS update
    -> [BER write errors at that point] -> score events against the latest
    LUT -> (every ``lut_every``-th chunk) rebuild the Harris LUT.

``cfg.backend == "fused"`` runs STCF/TOS/BER/score as the K1 kernel and the
refresh as the K2 kernel (``kernels.ops``); ``"torch"`` runs their plain
PyTorch versions on any device.  On CPU tensors both are plain PyTorch.

The random stream is JAX's threefry with the reference's key discipline
(one split per chunk iff injecting), so BER draws are draw-exact.
``state_from_numpy`` / ``state_to_numpy`` carry a state across from and
back to ``jax.device_get`` of a ``repro`` state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import ber as ber_mod
from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import harris as harris_mod
from repro_torch.core import hwmodel
from repro_torch.core import prng
from repro_torch.core import stcf as stcf_mod
from repro_torch.kernels import fused_step, ops

__all__ = [
    "ControlState",
    "DetectorState",
    "ChunkInput",
    "ChunkOutput",
    "control_init",
    "detector_init",
    "detector_step",
    "detector_scan",
    "chunk_input_riders",
    "resolve_device",
    "state_from_numpy",
    "state_to_numpy",
]


class ControlState(NamedTuple):
    """Degradation knobs (host values shared by the lanes of a state)."""

    lut_every: int      # Harris LUT refresh interval in chunks (>= 1)
    vdd_cap: int        # highest selectable operating-point index
    shed: bool          # suspend LUT refresh


class DetectorState(NamedTuple):
    """Everything the detector carries between chunks, for B lanes."""

    surface: torch.Tensor     # uint8  (B, H, W) — the TOS
    sae: torch.Tensor         # int32  (B, H, W) — STCF last timestamps
    lut: torch.Tensor         # float32 (B, H, W) — latest Harris response
    lut_ready: bool           # has the LUT ever been built?
    key: torch.Tensor         # int64 (B, 2) — threefry key words
    chunk_idx: int            # chunks folded so far
    rate: dvfs_mod.RateState  # (B,) int32 leaves — streaming rate estimator
    kept_total: torch.Tensor  # int32 (B,)
    energy_pj: torch.Tensor   # float32 (B,)
    latency_ns: torch.Tensor  # float32 (B,)
    ctrl: ControlState


class ChunkInput(NamedTuple):
    """One chunk for B lanes, plus its host-precomputed riders (ignored in
    online-DVFS mode)."""

    xy: torch.Tensor            # (B, E, 2) int32
    ts: torch.Tensor            # (B, E) int32, chunk-relative microseconds
    valid: torch.Tensor         # (B, E) bool
    ber: torch.Tensor           # (B,) float32 — write BER
    energy_coef: torch.Tensor   # (B,) float32 — pJ per kept event
    latency_coef: torch.Tensor  # (B,) float32 — ns per kept event


class ChunkOutput(NamedTuple):
    scores: torch.Tensor     # (B, E) float32 — LUT read per event
    keep: torch.Tensor       # (B, E) bool — survived STCF
    n_kept: torch.Tensor     # (B,) int32
    vdd_idx: torch.Tensor    # (B,) int32 — operating point (online mode)


def _online(cfg) -> bool:
    return bool(cfg.dvfs and cfg.dvfs_online)


def control_init(cfg) -> ControlState:
    """Neutral knobs: the config's refresh cadence, the full operating-point
    table (inert in fixed-Vdd mode), no shedding."""
    top = len(dvfs_mod.op_point_table(cfg.dvfs_cfg).caps) - 1 \
        if _online(cfg) else 0
    return ControlState(lut_every=int(cfg.lut_every_chunks), vdd_cap=top,
                        shed=False)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without it raises
    (never a silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but no CUDA device is "
            f"available; pass device='cpu' to run the plain versions")
    return dev


def detector_init(cfg, *, seed: Union[int, Sequence[int], None] = None,
                  device=None) -> DetectorState:
    """Fresh state on ``device`` (default ``cfg.device``); ``seed`` is one
    seed or one per lane (default ``cfg.seed``, one lane)."""
    device = resolve_device(cfg.device if device is None else device)
    if seed is None:
        seeds = [cfg.seed]
    elif isinstance(seed, (int, np.integer)):
        seeds = [int(seed)]
    else:
        seeds = [int(s) for s in seed]
    b, h, w = len(seeds), cfg.height, cfg.width
    zf = torch.zeros(b, dtype=torch.float32, device=device)
    return DetectorState(
        surface=torch.zeros((b, h, w), dtype=torch.uint8, device=device),
        sae=torch.full((b, h, w), stcf_mod.NEVER, dtype=torch.int32,
                       device=device),
        lut=torch.full((b, h, w), -torch.inf, dtype=torch.float32,
                       device=device),
        lut_ready=False,
        key=torch.stack([prng.prng_key(s, device=device) for s in seeds]),
        chunk_idx=0,
        rate=dvfs_mod.rate_state_init(b, device=device),
        kept_total=torch.zeros(b, dtype=torch.int32, device=device),
        energy_pj=zf,
        latency_ns=zf.clone(),
        ctrl=control_init(cfg),
    )


@functools.lru_cache(maxsize=None)
def _op_table(dvfs_cfg, device: torch.device) -> dict:
    """The operating-point columns on ``device``, uploaded once (a pageable
    upload inside the step would wait for the device every chunk)."""
    tab = dvfs_mod.op_point_table(dvfs_cfg)
    return {name: torch.as_tensor(getattr(tab, name), device=device)
            for name in ("caps", "ber", "energy_pj", "latency_ns")}


def _operating_point(cfg, state: DetectorState, chunk: ChunkInput):
    """This chunk's (rate, vdd_idx, ber, energy_coef, latency_coef), per
    lane: the online estimator's pick clamped at ``ctrl.vdd_cap``, or the
    precomputed riders."""
    if _online(cfg):
        tab = _op_table(cfg.dvfs_cfg, chunk.ts.device)
        rate, vdd_idx = dvfs_mod.online_vdd_from_chunk_ts(
            state.rate, chunk.ts, chunk.valid, cfg=cfg.dvfs_cfg,
            caps=tab["caps"],
        )
        vdd_idx = torch.clamp(vdd_idx, max=state.ctrl.vdd_cap)
        i = vdd_idx.long()
        return (rate, vdd_idx, tab["ber"][i], tab["energy_pj"][i],
                tab["latency_ns"][i])
    zeros = torch.zeros_like(state.kept_total)
    return (state.rate, zeros, chunk.ber, chunk.energy_coef,
            chunk.latency_coef)


def _refresh_lut(cfg, state: DetectorState, surface, lut):
    """Every ``lut_every``-th chunk (unless shed) rebuild the Harris LUT.
    Host decision; returns (lut, do_refresh)."""
    do_refresh = ((state.chunk_idx + 1) % state.ctrl.lut_every == 0
                  and not state.ctrl.shed)
    if not do_refresh:
        return lut, False
    harris = (ops.harris_response_op if cfg.backend == "fused"
              else harris_mod.harris_response)
    return harris(surface, sobel_size=cfg.sobel_size,
                  window_size=cfg.window_size, k=cfg.harris_k), True


def detector_step(cfg, state: DetectorState,
                  chunk: ChunkInput) -> tuple[DetectorState, ChunkOutput]:
    """Fold one chunk into every lane; returns the new state and outputs.

    The chunk block (STCF -> TOS -> BER -> score) is K1 through
    ``ops.fused_step_op`` on the ``"fused"`` backend and its plain
    composition ``fused_step_ref`` on ``"torch"``.  Both draw the BER bits
    here, with one key split per chunk iff injecting, as the reference does.
    """
    rate, vdd_idx, ber_c, energy_coef, latency_coef = _operating_point(
        cfg, state, chunk)
    key, bits = state.key, None
    if cfg.inject_ber:
        key, sub = prng.split(key)
        bits = ber_mod.write_error_bits(sub, tuple(state.surface.shape[1:]),
                                        ber_c)
    block = (ops.fused_step_op if cfg.backend == "fused"
             else fused_step.fused_step_ref)
    surface, sae, keep, raw = block(
        state.surface, state.sae, state.lut, chunk.xy, chunk.ts,
        chunk.valid, ber_c, bits, patch=cfg.patch, th=cfg.th,
        support=cfg.stcf_support, tw=cfg.stcf_tw_us,
        stcf_enabled=cfg.stcf_enabled,
    )

    n_kept = keep.sum(-1, dtype=torch.int32)
    scores = raw if state.lut_ready else torch.full_like(raw, -torch.inf)
    lut, do_refresh = _refresh_lut(cfg, state, surface, state.lut)
    nk = n_kept.to(torch.float32)
    new_state = DetectorState(
        surface=surface,
        sae=sae,
        lut=lut,
        lut_ready=state.lut_ready or do_refresh,
        key=key,
        chunk_idx=state.chunk_idx + 1,
        rate=rate,
        kept_total=state.kept_total + n_kept,
        energy_pj=state.energy_pj + nk * energy_coef,
        latency_ns=state.latency_ns + nk * latency_coef,
        ctrl=state.ctrl,
    )
    return new_state, ChunkOutput(scores=scores, keep=keep, n_kept=n_kept,
                                  vdd_idx=vdd_idx)


def detector_scan(cfg, state: DetectorState,
                  chunks: ChunkInput) -> tuple[DetectorState, ChunkOutput]:
    """Fold a stack of chunks (leaves ``(C, B, ...)``) in order; outputs
    are stacked ``(C, B, ...)``.  Nothing here waits for the device."""
    if chunks.xy.shape[0] == 0:
        b, e = chunks.valid.shape[1:]
        empty = torch.zeros((0, b), dtype=torch.int32,
                            device=chunks.xy.device)
        return state, ChunkOutput(
            scores=torch.zeros((0, b, e), device=chunks.xy.device),
            keep=chunks.valid, n_kept=empty, vdd_idx=empty)
    outs = []
    for c in range(chunks.xy.shape[0]):
        state, out = detector_step(cfg, state,
                                   ChunkInput(*(t[c] for t in chunks)))
        outs.append(out)
    return state, ChunkOutput(*(torch.stack(parts) for parts in zip(*outs)))


def chunk_input_riders(
    n_chunks: int, vdd_arr: Optional[np.ndarray], cfg
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host per-chunk (ber, energy_coef, latency_coef) float32 arrays;
    zeros in online mode (``vdd_arr=None``), where the step ignores them."""
    if vdd_arr is None:
        z = np.zeros((n_chunks,), np.float32)
        return z, z.copy(), z.copy()
    ber = np.asarray([hwmodel.ber_at(float(v)) for v in vdd_arr], np.float32)
    e = np.asarray([hwmodel.patch_energy_pj(float(v)) for v in vdd_arr],
                   np.float32)
    lat = np.asarray([hwmodel.patch_latency_ns(float(v)) for v in vdd_arr],
                     np.float32)
    return ber, e, lat


def _shared_host(values, name):
    arr = np.asarray(values).reshape(-1)
    if not (arr == arr[0]).all():
        raise ValueError(f"{name} differs across lanes; the port's lanes "
                         "share it")
    return arr[0].item()


def state_from_numpy(jstate, *, device="cuda") -> DetectorState:
    """A port state on ``device`` from ``jax.device_get`` of a ``repro``
    DetectorState (one stream, or lanes stacked on a leading axis)."""
    device = resolve_device(device)
    single = np.asarray(jstate.surface).ndim == 2

    def dev(a, dtype):
        t = torch.as_tensor(np.array(a), dtype=dtype, device=device)
        return t[None] if single else t

    return DetectorState(
        surface=dev(jstate.surface, torch.uint8),
        sae=dev(jstate.sae, torch.int32),
        lut=dev(jstate.lut, torch.float32),
        lut_ready=bool(_shared_host(jstate.lut_ready, "lut_ready")),
        key=dev(np.asarray(jstate.key).astype(np.int64), torch.int64),
        chunk_idx=int(_shared_host(jstate.chunk_idx, "chunk_idx")),
        rate=dvfs_mod.RateState(*(dev(r, torch.int32)
                                  for r in jstate.rate)),
        kept_total=dev(jstate.kept_total, torch.int32),
        energy_pj=dev(jstate.energy_pj, torch.float32),
        latency_ns=dev(jstate.latency_ns, torch.float32),
        ctrl=ControlState(
            lut_every=int(_shared_host(jstate.ctrl.lut_every, "lut_every")),
            vdd_cap=int(_shared_host(jstate.ctrl.vdd_cap, "vdd_cap")),
            shed=bool(_shared_host(jstate.ctrl.shed, "shed")),
        ),
    )


def state_to_numpy(state: DetectorState) -> DetectorState:
    """The state as numpy arrays in the reference's layout and dtypes (the
    lane axis dropped for a one-lane state; host values broadcast to it
    otherwise)."""
    b = state.surface.shape[0]
    single = b == 1

    def arr(t, dtype):
        a = t.detach().cpu().numpy().astype(dtype)
        return a[0] if single else a

    def host(v, dtype):
        a = np.asarray(v, dtype)
        return a if single else np.full((b,), v, dtype)

    return DetectorState(
        surface=arr(state.surface, np.uint8),
        sae=arr(state.sae, np.int32),
        lut=arr(state.lut, np.float32),
        lut_ready=host(state.lut_ready, np.bool_),
        key=arr(state.key, np.uint32),
        chunk_idx=host(state.chunk_idx, np.int32),
        rate=dvfs_mod.RateState(*(arr(r, np.int32) for r in state.rate)),
        kept_total=arr(state.kept_total, np.int32),
        energy_pj=arr(state.energy_pj, np.float32),
        latency_ns=arr(state.latency_ns, np.float32),
        ctrl=ControlState(
            lut_every=host(state.ctrl.lut_every, np.int32),
            vdd_cap=host(state.ctrl.vdd_cap, np.int32),
            shed=host(state.ctrl.shed, np.bool_),
        ),
    )
