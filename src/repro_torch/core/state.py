"""The detector's state, its one-chunk step and the pool's result rings
(``repro.core.state``).

``DetectorState`` carries B camera lanes: every tensor leaf has a leading
lane axis, on the state's device.  The chunk cursor, ``lut_ready`` and the
``ControlState`` knobs are host numpy arrays of shape ``(B,)`` — the host
sets them and they advance deterministically — so the LUT-refresh decision
needs no device read and a whole stream folds with a single host sync at
the end.  The batch pipeline's lockstep lanes are the case where all
entries are equal; the serving pool's lanes join, leave and refresh on
their own chunks.

``detector_step`` folds one chunk into every lane:

    [online DVFS picks the operating point] -> STCF -> TOS update
    -> [BER write errors at that point] -> score events against the latest
    LUT -> (every ``lut_every``-th chunk of a lane) rebuild its Harris LUT.

An optional host lane mask (the reference pool's ``_mask_tree``) leaves the
inactive lanes' every leaf as it was.

``detector_step`` is functional: the caller's state is left as it was.
``detector_step_`` (PyTorch's trailing-underscore idiom) updates the TOS
and the SAE of a state its caller owns in place, and the returned state
shares them; the entry points that fold many chunks (``detector_scan``,
``StreamingDetector``, the pool's executor) take one working copy of a
caller's state, or build their own, and step it in place, so K1 moves no
surface copy per chunk.

``cfg.backend == "fused"`` runs STCF/TOS/BER/score as the K1 kernel;
``"nmc"`` and ``"batched"`` run the reference's unfused order (plain STCF
and LUT score, the TOS update as K4 or K5 over all lanes in one launch,
then the BER write errors); these three refresh the LUT with the K2 kernel
(``kernels.ops``).  ``"torch"`` runs the plain PyTorch versions on any
device (the TOS update in its one-hot spelling when
``cfg.use_onehot_update``).  On CPU tensors every backend is plain
PyTorch.  ``select_update`` hands out a backend's standalone TOS update
(the host-loop oracle's), ``lut_refresh`` its LUT routine.

The random stream is JAX's threefry with the reference's key discipline
(one split per chunk iff injecting), so BER draws are draw-exact.  The
split and the draw are one call, ``ops.ber_draw_op`` (one launch of the
draw kernel on CUDA) on the three kernel backends and the plain
``ber_draw.ber_draw_ref`` on ``"torch"``; it runs in the span
``step.draw`` (``repro_torch.obs``), timed on the device too while the
profiler runs.
``state_from_numpy`` / ``state_to_numpy`` carry a state across from and
back to ``jax.device_get`` of a ``repro`` state (one stream, or a pool's
lanes stacked on a leading axis).

``RingState`` / ``CompactRingState`` are the pool's fixed-capacity device
result rings; ``ring_push`` / ``ring_push_compact`` write one round into
the next slot in place, with the cursors (``head``, ``count``,
``dropped``) as device scalars, as in the reference; on CUDA a push is one
launch of K3's ring push.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import ber as ber_mod
from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import harris as harris_mod
from repro_torch.core import hwmodel
from repro_torch.core import prng
from repro_torch.core import stcf as stcf_mod
from repro_torch.core import tos as tos_mod
from repro_torch.kernels import ber_draw, fused_step, ops

__all__ = [
    "BACKENDS",
    "check_backend",
    "select_update",
    "lut_refresh",
    "ControlState",
    "DetectorState",
    "ChunkInput",
    "ChunkOutput",
    "RingState",
    "CompactRingState",
    "control_init",
    "detector_init",
    "detector_step",
    "detector_step_",
    "detector_scan",
    "rate_estimate_eps",
    "ring_init",
    "ring_push",
    "compact_ring_init",
    "ring_push_compact",
    "ring_slot_order",
    "chunk_input_riders",
    "resolve_device",
    "upload",
    "lane_state",
    "set_lane_state",
    "state_from_numpy",
    "state_to_numpy",
]


class ControlState(NamedTuple):
    """Degradation knobs, one entry per lane (host arrays of shape (B,))."""

    lut_every: np.ndarray   # int32 — Harris LUT refresh interval (>= 1)
    vdd_cap: np.ndarray     # int32 — highest selectable operating point
    shed: np.ndarray        # bool  — suspend LUT refresh


class DetectorState(NamedTuple):
    """Everything the detector carries between chunks, for B lanes."""

    surface: torch.Tensor     # uint8  (B, H, W) — the TOS
    sae: torch.Tensor         # int32  (B, H, W) — STCF last timestamps
    lut: torch.Tensor         # float32 (B, H, W) — latest Harris response
    lut_ready: np.ndarray     # bool (B,) host — has the LUT ever been built?
    key: torch.Tensor         # int64 (B, 2) — threefry key words
    chunk_idx: np.ndarray     # int32 (B,) host — chunks folded so far
    rate: dvfs_mod.RateState  # (B,) int32 leaves — streaming rate estimator
    kept_total: torch.Tensor  # int32 (B,)
    energy_pj: torch.Tensor   # float32 (B,)
    latency_ns: torch.Tensor  # float32 (B,)
    ctrl: ControlState


# Tensor leaves of a DetectorState (rate's four leaves come on top).
_TENSOR_FIELDS = ("surface", "sae", "lut", "key", "kept_total", "energy_pj",
                  "latency_ns")


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


BACKENDS = ("fused", "torch", "nmc", "batched")
# The reference's backend names, each with the port's twin.
_TWINS = {"pallas_fused": "fused", "jnp": "torch", "pallas_nmc": "nmc",
          "pallas_batched": "batched"}


def check_backend(backend: str) -> None:
    """Refuse a backend the port does not have, naming the port's twin of
    a reference backend."""
    if backend not in BACKENDS:
        twin = _TWINS.get(backend)
        hint = (f"it is the reference's name; the port's twin is {twin!r}"
                if twin else f"use one of {BACKENDS}")
        raise ValueError(f"backend {backend!r} is not in the port: {hint}")


def select_update(cfg) -> Callable:
    """The standalone TOS chunk update ``(surface, xy, valid) -> surface``
    of ``cfg.backend``: ``"torch"`` the closed form (one-hot when
    ``cfg.use_onehot_update``), ``"nmc"`` / ``"batched"``
    ``ops.tos_update_op`` (K4 / K5 on CUDA tensors)."""
    check_backend(cfg.backend)
    if cfg.backend == "fused":
        raise ValueError(
            "backend 'fused' fuses the whole chunk step (STCF -> TOS -> BER "
            "-> LUT score) into one kernel — it has no standalone TOS "
            "update; route through detector_step / run_pipeline / the "
            "serving layer instead"
        )
    if cfg.backend == "torch":
        fn = _plain_update(cfg)
        return lambda s, xy, v: fn(s, xy, v, patch=cfg.patch, th=cfg.th)
    return lambda s, xy, v: ops.tos_update_op(
        s, xy, v, patch=cfg.patch, th=cfg.th, mode=cfg.backend)


def _plain_update(cfg) -> Callable:
    """The plain TOS update of backend ``"torch"``."""
    return (tos_mod.tos_update_batched_onehot if cfg.use_onehot_update
            else tos_mod.tos_update_batched)


def lut_refresh(cfg) -> Callable:
    """The Harris LUT routine of ``cfg.backend``: the plain
    ``harris_response`` on ``"torch"``, else ``ops.harris_response_op``
    (K2 on CUDA tensors)."""
    return (harris_mod.harris_response if cfg.backend == "torch"
            else ops.harris_response_op)


def _online(cfg) -> bool:
    return bool(cfg.dvfs and cfg.dvfs_online)


def _vdd_top(cfg) -> int:
    """Highest operating-point index a cap may select (0 in fixed-Vdd
    mode, where the cap is inert)."""
    return (len(dvfs_mod.op_point_table(cfg.dvfs_cfg).caps) - 1
            if _online(cfg) else 0)


def _lanes(value, b: int, dtype) -> np.ndarray:
    """A host leaf as an owned ``(b,)`` array (a scalar is broadcast)."""
    return np.array(np.broadcast_to(np.asarray(value, dtype), (b,)))


def control_init(cfg, lanes: int = 1) -> ControlState:
    """Neutral knobs: the config's refresh cadence, the full operating-point
    table (inert in fixed-Vdd mode), no shedding."""
    return ControlState(
        lut_every=_lanes(int(cfg.lut_every_chunks), lanes, np.int32),
        vdd_cap=_lanes(_vdd_top(cfg), lanes, np.int32),
        shed=_lanes(False, lanes, np.bool_))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without it raises
    (never a silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but no CUDA device is "
            f"available; pass device='cpu' to run the plain versions")
    return dev


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array on ``device``.  On CUDA it goes through
    pinned memory and does not wait for the device (PyTorch's pinned
    allocator keeps the staging buffer until the copy is done)."""
    t = torch.from_numpy(np.array(arr))
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=256)
def _cached_upload(data: bytes, dtype: str, device: torch.device):
    return upload(np.frombuffer(data, dtype=dtype), device)


def _lanes_on(arr: np.ndarray, device) -> torch.Tensor:
    """A small per-lane host array on ``device``, uploaded once per
    distinct value (masks, lane lists and knobs repeat).  Read-only."""
    arr = np.ascontiguousarray(arr)
    return _cached_upload(arr.tobytes(), arr.dtype.str, torch.device(device))


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
        lut_ready=np.zeros(b, np.bool_),
        key=torch.stack([prng.prng_key(s, device=device) for s in seeds]),
        chunk_idx=np.zeros(b, np.int32),
        rate=dvfs_mod.rate_state_init(b, device=device),
        kept_total=torch.zeros(b, dtype=torch.int32, device=device),
        energy_pj=zf,
        latency_ns=zf.clone(),
        ctrl=control_init(cfg, b),
    )


@functools.lru_cache(maxsize=None)
def _op_table(dvfs_cfg, device: torch.device) -> dict:
    """The operating-point columns on ``device``, uploaded once (a pageable
    upload inside the step would wait for the device every chunk)."""
    tab = dvfs_mod.op_point_table(dvfs_cfg)
    return {name: torch.as_tensor(getattr(tab, name), device=device)
            for name in ("caps", "ber", "energy_pj", "latency_ns")}


def _operating_point(cfg, state: DetectorState, chunk: ChunkInput,
                     vdd_cap: np.ndarray):
    """This chunk's (rate, vdd_idx, ber, energy_coef, latency_coef), per
    lane: the online estimator's pick clamped at each lane's ``vdd_cap``,
    or the precomputed riders."""
    if _online(cfg):
        tab = _op_table(cfg.dvfs_cfg, chunk.ts.device)
        rate, vdd_idx = dvfs_mod.online_vdd_from_chunk_ts(
            state.rate, chunk.ts, chunk.valid, cfg=cfg.dvfs_cfg,
            caps=tab["caps"],
        )
        if (vdd_cap < tab["caps"].shape[0] - 1).any():
            if (vdd_cap == vdd_cap[0]).all():
                vdd_idx = torch.clamp(vdd_idx, max=int(vdd_cap[0]))
            else:
                vdd_idx = torch.minimum(
                    vdd_idx, _lanes_on(vdd_cap.astype(np.int32),
                                       vdd_idx.device))
        i = vdd_idx.long()
        return (rate, vdd_idx, tab["ber"][i], tab["energy_pj"][i],
                tab["latency_ns"][i])
    zeros = torch.zeros_like(state.kept_total)
    return (state.rate, zeros, chunk.ber, chunk.energy_coef,
            chunk.latency_coef)


def _refresh_lut(cfg, state: DetectorState, surface, due: np.ndarray):
    """Rebuild the Harris LUT of the lanes whose refresh is ``due`` (a
    host decision), in one launch over just those lanes."""
    if not due.any():
        return state.lut
    harris = lut_refresh(cfg)
    kw = dict(sobel_size=cfg.sobel_size, window_size=cfg.window_size,
              k=cfg.harris_k)
    if due.all():
        return harris(surface, **kw)
    idx = _lanes_on(np.flatnonzero(due), surface.device)
    return state.lut.index_copy(0, idx, harris(surface.index_select(0, idx),
                                               **kw))


def _gate_scores(raw: torch.Tensor, lut_ready: np.ndarray) -> torch.Tensor:
    """Scores of lanes whose LUT was never built read ``-inf``."""
    if lut_ready.all():
        return raw
    if not lut_ready.any():
        return torch.full_like(raw, -torch.inf)
    ready = _lanes_on(lut_ready, raw.device)
    return torch.where(ready[:, None], raw, -torch.inf)


def _accumulate(acc: torch.Tensor, nk: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """``acc + nk * coef`` in float32 with one rounding: the reference's
    XLA contracts it into a fused multiply-add.  ``nk * coef`` is exact in
    float64 (a count below 2**24 times a float32), so one float64 add and
    the cast to float32 round as the FMA does while ``acc`` stays below
    2**16 times the product."""
    return (acc.double() + nk.double() * coef.double()).to(torch.float32)


def _keep_inactive(active: np.ndarray, new: DetectorState,
                   old: DetectorState) -> DetectorState:
    """Inactive lanes keep every tensor leaf of ``old``.  The LUT is left
    out: only active lanes refresh it.

    A leaf that ``new`` shares with ``old`` (the surfaces after an in-place
    chunk block) is taken as it is: the block was given the same lane mask
    and left the inactive lanes' pixels untouched (K1 returns at once for
    their tiles; ``fused_step_ref_`` copies back only the active lanes), so
    those lanes already hold the old values and a select would only copy
    the surface."""
    m = _lanes_on(active, old.surface.device)

    def sel(n, o):
        if n is o:
            return n
        return torch.where(m.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    picked = {f: sel(getattr(new, f), getattr(old, f))
              for f in _TENSOR_FIELDS if f != "lut"}
    rate = dvfs_mod.RateState(*map(sel, new.rate, old.rate))
    return new._replace(rate=rate, **picked)


def _tos_update_block(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                      mask=None, mode, patch, th, support, tw, stcf_enabled):
    """The chunk block of backends ``"nmc"`` / ``"batched"``, in the
    reference's unfused order: ``stcf_step`` and the LUT score per lane
    (plain), the TOS update of the kept events through
    ``ops.tos_update_op`` (K4 / K5, all lanes in one launch), then the BER
    write errors with the step's bits.  Same signature and outputs as
    ``fused_step.fused_step_ref``, but functional in both steps and blind
    to ``mask``: it returns new surfaces for every lane, and the step
    selects the inactive lanes' old ones back."""
    saes, keeps, scores = [], [], []
    for b in range(tos.shape[0]):
        sae_b, keep_b = stcf_mod.stcf_step(
            sae[b], xy[b], ts[b], valid[b], enabled=stcf_enabled,
            support=support, tw=tw,
        )
        saes.append(sae_b)
        keeps.append(keep_b)
        scores.append(harris_mod.score_events(lut[b], xy[b], keep_b))
    keep = torch.stack(keeps)
    surface = ops.tos_update_op(tos, xy, keep, patch=patch, th=th, mode=mode)
    if bits is not None:
        surface = ber_mod.apply_write_errors(surface, bits, ber)
    return surface, torch.stack(saes), keep, torch.stack(scores)


def _chunk_block(cfg, inplace: bool) -> Callable:
    """The STCF -> TOS -> BER -> score block of ``cfg.backend``; with
    ``inplace`` the fused and plain blocks update the surfaces in place."""
    backend = cfg.backend
    if backend == "fused":
        return ops.fused_step_op_ if inplace else ops.fused_step_op
    if backend == "torch":
        return functools.partial(
            fused_step.fused_step_ref_ if inplace
            else fused_step.fused_step_ref, update=_plain_update(cfg))
    if backend in ("nmc", "batched"):
        return functools.partial(_tos_update_block, mode=backend)
    raise ValueError(f"unknown backend {backend!r}")


def detector_step(cfg, state: DetectorState, chunk: ChunkInput,
                  mask: Optional[np.ndarray] = None
                  ) -> tuple[DetectorState, ChunkOutput]:
    """Fold one chunk into every lane (or the lanes of the host bool
    ``mask``); returns the new state and outputs.  ``state`` is left as it
    was.

    The chunk block (STCF -> TOS -> BER -> score) is K1 through
    ``ops.fused_step_op`` on the ``"fused"`` backend, its plain
    composition ``fused_step_ref`` on ``"torch"``, and on ``"nmc"`` /
    ``"batched"`` plain STCF and score around K4 / K5 for all lanes in one
    launch.  All draw the BER bits here, with one key split per chunk iff
    injecting, as the reference does: every lane, active or not, through
    ``ops.ber_draw_op`` (the plain ``ber_draw_ref`` on ``"torch"``).  The
    fused and plain blocks take the lane mask and leave the inactive lanes'
    surfaces alone; ``"nmc"`` / ``"batched"`` apply the bits to them too
    and the step selects their old surfaces back.  Inactive lanes' other
    leaves are selected back, their cursors do not advance and their LUT
    is not rebuilt.  While the profiler runs the step counts
    ``step.lanes_stepped`` (the state's lanes) and ``step.lanes_active``
    (the mask's) through ``obs.spans.count``.
    """
    return _step(cfg, state, chunk, mask, inplace=False)


def detector_step_(cfg, state: DetectorState, chunk: ChunkInput,
                   mask: Optional[np.ndarray] = None
                   ) -> tuple[DetectorState, ChunkOutput]:
    """``detector_step`` that updates ``state.surface`` and ``state.sae``
    in place on the ``"fused"`` and ``"torch"`` backends (K1 without its
    two surface copies); the returned state shares them.  The caller must
    own ``state`` and use only the returned state afterwards."""
    return _step(cfg, state, chunk, mask, inplace=True)


def _step(cfg, state: DetectorState, chunk: ChunkInput,
          mask: Optional[np.ndarray], *, inplace: bool
          ) -> tuple[DetectorState, ChunkOutput]:
    b = state.surface.shape[0]
    active = (np.ones(b, np.bool_) if mask is None
              else _lanes(mask, b, np.bool_))
    if obs_mod.spans.tracing():
        obs_mod.spans.count("step.lanes_stepped", b)
        obs_mod.spans.count("step.lanes_active",
                            int(np.count_nonzero(active)))
    lut_ready = _lanes(state.lut_ready, b, np.bool_)
    chunk_idx = _lanes(state.chunk_idx, b, np.int32)
    lut_every = _lanes(state.ctrl.lut_every, b, np.int32)
    shed = _lanes(state.ctrl.shed, b, np.bool_)
    vdd_cap = _lanes(state.ctrl.vdd_cap, b, np.int32)

    rate, vdd_idx, ber_c, energy_coef, latency_coef = _operating_point(
        cfg, state, chunk, vdd_cap)
    key, bits = state.key, None
    if cfg.inject_ber:
        draw = (ber_draw.ber_draw_ref if cfg.backend == "torch"
                else ops.ber_draw_op)
        with obs_mod.span("step.draw", device=state.surface.device):
            key, bits = draw(key, tuple(state.surface.shape[1:]), ber_c)
    lane_mask = (None if active.all()
                 else _lanes_on(active, state.surface.device))
    surface, sae, keep, raw = _chunk_block(cfg, inplace)(
        state.surface, state.sae, state.lut, chunk.xy, chunk.ts,
        chunk.valid, ber_c, bits, mask=lane_mask, patch=cfg.patch,
        th=cfg.th, support=cfg.stcf_support, tw=cfg.stcf_tw_us,
        stcf_enabled=cfg.stcf_enabled,
    )

    n_kept = keep.sum(-1, dtype=torch.int32)
    scores = _gate_scores(raw, lut_ready)
    due = ((chunk_idx + 1) % lut_every == 0) & ~shed & active
    lut = _refresh_lut(cfg, state, surface, due)
    new_state = DetectorState(
        surface=surface,
        sae=sae,
        lut=lut,
        lut_ready=lut_ready | due,
        key=key,
        chunk_idx=chunk_idx + active.astype(np.int32),
        rate=rate,
        kept_total=state.kept_total + n_kept,
        energy_pj=_accumulate(state.energy_pj, n_kept, energy_coef),
        latency_ns=_accumulate(state.latency_ns, n_kept, latency_coef),
        ctrl=state.ctrl,
    )
    if not active.all():
        new_state = _keep_inactive(active, new_state, state)
    return new_state, ChunkOutput(scores=scores, keep=keep, n_kept=n_kept,
                                  vdd_idx=vdd_idx)


def detector_scan(cfg, state: DetectorState,
                  chunks: ChunkInput) -> tuple[DetectorState, ChunkOutput]:
    """Fold a stack of chunks (leaves ``(C, B, ...)``) in order; outputs
    are stacked ``(C, B, ...)``.  Nothing here waits for the device.
    ``state`` is left as it was: the fold steps one working copy of its
    surfaces in place."""
    if chunks.xy.shape[0] == 0:
        b, e = chunks.valid.shape[1:]
        empty = torch.zeros((0, b), dtype=torch.int32,
                            device=chunks.xy.device)
        return state, ChunkOutput(
            scores=torch.zeros((0, b, e), device=chunks.xy.device),
            keep=chunks.valid, n_kept=empty, vdd_idx=empty)
    state = state._replace(surface=state.surface.clone(),
                           sae=state.sae.clone())
    outs = []
    for c in range(chunks.xy.shape[0]):
        state, out = detector_step_(cfg, state,
                                    ChunkInput(*(t[c] for t in chunks)))
        outs.append(out)
    return state, ChunkOutput(*(torch.stack(parts) for parts in zip(*outs)))


def rate_estimate_eps(prev1, prev2, dvfs_cfg) -> float:
    """Events/s read-out of the streaming rate estimator's closed pair
    (host arithmetic, the reference's formula): both counters saturate at
    ``2^counter_bits - 1`` and the divide is float32, as the step's."""
    sat = (1 << dvfs_cfg.counter_bits) - 1
    pair = min(int(prev1), sat) + min(int(prev2), sat)
    est_mpus = np.float32(pair) / np.float32(dvfs_cfg.tw_us)
    return float(est_mpus) * 1e6


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


def state_from_numpy(jstate, *, device="cuda") -> DetectorState:
    """A port state on ``device`` from a state of numpy arrays in the
    reference's layout: ``jax.device_get`` of a ``repro`` DetectorState,
    one stream or a pool's lanes stacked on a leading axis, or
    ``state_to_numpy`` of a port state.  Fields are read by name."""
    device = resolve_device(device)
    single = np.asarray(jstate.surface).ndim == 2
    b = 1 if single else np.asarray(jstate.surface).shape[0]

    def dev(a, dtype):
        t = torch.as_tensor(np.array(a), dtype=dtype, device=device)
        return t[None] if single else t

    return DetectorState(
        surface=dev(jstate.surface, torch.uint8),
        sae=dev(jstate.sae, torch.int32),
        lut=dev(jstate.lut, torch.float32),
        lut_ready=_lanes(jstate.lut_ready, b, np.bool_),
        key=dev(np.asarray(jstate.key).astype(np.int64), torch.int64),
        chunk_idx=_lanes(jstate.chunk_idx, b, np.int32),
        rate=dvfs_mod.RateState(*(dev(r, torch.int32)
                                  for r in jstate.rate)),
        kept_total=dev(jstate.kept_total, torch.int32),
        energy_pj=dev(jstate.energy_pj, torch.float32),
        latency_ns=dev(jstate.latency_ns, torch.float32),
        ctrl=ControlState(
            lut_every=_lanes(jstate.ctrl.lut_every, b, np.int32),
            vdd_cap=_lanes(jstate.ctrl.vdd_cap, b, np.int32),
            shed=_lanes(jstate.ctrl.shed, b, np.bool_),
        ),
    )


def state_to_numpy(state) -> DetectorState:
    """The state as owned numpy arrays in the reference's layout and
    dtypes: a one-lane state drops the lane axis (host leaves become 0-d),
    a B-lane state is the reference pool's stacked ``(B, ...)`` layout.  A
    sharded pool's state, the tuple of its shards' states in lane order,
    gives the same tree as the unsharded pool's: every lane, in global
    order."""
    if not isinstance(state, DetectorState):
        parts = [_host_state(s, single=False) for s in state]
        return _cat_lanes(parts)
    return _host_state(state, single=state.surface.shape[0] == 1)


def _cat_lanes(parts):
    """Equal-structured host trees joined along their lane axis."""
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(_cat_lanes(list(z)) for z in zip(*parts)))
    return np.concatenate(parts)


def _host_state(state: DetectorState, *, single: bool) -> DetectorState:
    b = state.surface.shape[0]

    def arr(t, dtype):
        a = t.detach().cpu().numpy().astype(dtype)
        return a[0] if single else a

    def host(v, dtype):
        a = _lanes(v, b, dtype)
        return a[0].copy() if single else a

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


def lane_state(state, lane: int) -> DetectorState:
    """Lane ``lane`` of ``state`` as a one-lane state (tensor leaves are
    views of ``state``'s, so an in-place step of ``state`` shows through
    them; host leaves are copies).  ``state`` may be a sharded pool's tuple
    of shard states, ``lane`` then a global lane index."""
    if not isinstance(state, DetectorState):
        for shard in state:
            b = shard.surface.shape[0]
            if 0 <= lane < b:
                return lane_state(shard, lane)
            lane -= b
        raise IndexError("lane index out of range")
    sl = slice(lane, lane + 1)
    host = {f: _lanes(getattr(state, f), state.surface.shape[0],
                      dt)[sl].copy()
            for f, dt in (("lut_ready", np.bool_), ("chunk_idx", np.int32))}
    ctrl = ControlState(*(
        _lanes(v, state.surface.shape[0], dt)[sl].copy()
        for v, dt in zip(state.ctrl, (np.int32, np.int32, np.bool_))))
    return state._replace(
        rate=dvfs_mod.RateState(*(r[sl] for r in state.rate)), ctrl=ctrl,
        **{f: getattr(state, f)[sl] for f in _TENSOR_FIELDS}, **host)


def set_lane_state(states: DetectorState, lane: int,
                   one: DetectorState) -> DetectorState:
    """``states`` with lane ``lane`` replaced by the one-lane state ``one``
    (the reference pool's ``at[lane].set``).  The tensor leaves of
    ``states`` are written in place; the host leaves are new arrays."""
    for f in _TENSOR_FIELDS:
        getattr(states, f)[lane].copy_(getattr(one, f)[0])
    for dst, src in zip(states.rate, one.rate):
        dst[lane].copy_(src[0])
    b = states.surface.shape[0]

    def put(many, single, dtype):
        out = _lanes(many, b, dtype)
        out[lane] = np.asarray(single, dtype).reshape(-1)[0]
        return out

    dts = (np.int32, np.int32, np.bool_)
    return states._replace(
        lut_ready=put(states.lut_ready, one.lut_ready, np.bool_),
        chunk_idx=put(states.chunk_idx, one.chunk_idx, np.int32),
        ctrl=ControlState(*(put(m, o, dt) for m, o, dt in
                            zip(states.ctrl, one.ctrl, dts))))


# -- result rings ---------------------------------------------------------


class RingState(NamedTuple):
    """Fixed-capacity device result ring of a pool bucket.

    The pool pushes one slot per executed round (the lane-stacked
    ``ChunkOutput`` plus the round's lane mask and per-lane valid counts);
    the host fetches once per drain and walks the slots oldest-first.
    Pushing onto a full ring overwrites the oldest slot and counts it in
    ``dropped``.  The cursors are int32 device scalars updated on the
    device by the push, as in the reference; the owner zeroes ``count``
    and ``dropped`` at every drain.  ``ring_init`` makes ``head``,
    ``count`` and ``dropped`` views of one int32 block of four, whose
    fourth is the push kernel's ticket (0 between pushes).
    """

    scores: torch.Tensor   # (R, lanes, chunk) float32
    keep: torch.Tensor     # (R, lanes, chunk) bool
    n_kept: torch.Tensor   # (R, lanes) int32
    vdd_idx: torch.Tensor  # (R, lanes) int32
    n_valid: torch.Tensor  # (R, lanes) int32 — valid events that round
    mask: torch.Tensor     # (R, lanes) bool — lanes that folded that round
    head: torch.Tensor     # int32 scalar — next slot to write
    count: torch.Tensor    # int32 scalar — undrained slots (saturates at R)
    dropped: torch.Tensor  # int32 scalar — rounds overwritten before a drain


class CompactRingState(NamedTuple):
    """``RingState`` plus each slot-lane's first ``cap`` kept events as
    ``(event index, score)`` records (K3), so a drain can fetch the
    records instead of the dense rows.  The dense rows are still written
    every push: they are the lossless fallback for ``n_kept > cap``."""

    scores: torch.Tensor
    keep: torch.Tensor
    n_kept: torch.Tensor   # doubles as the record count
    vdd_idx: torch.Tensor
    n_valid: torch.Tensor
    mask: torch.Tensor
    head: torch.Tensor
    count: torch.Tensor
    dropped: torch.Tensor
    c_idx: torch.Tensor    # (R, lanes, cap) int32
    c_val: torch.Tensor    # (R, lanes, cap) float32


def ring_init(rounds: int, lanes: int, chunk: int, *,
              device="cuda") -> RingState:
    """Empty ring of ``rounds`` slots for a ``lanes``-wide bucket of
    ``chunk``-event rounds."""
    if rounds < 1:
        raise ValueError("ring needs at least one slot")
    device = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    cursors = z(4)   # head, count, dropped, the push kernel's ticket
    return RingState(
        scores=z(rounds, lanes, chunk, dtype=torch.float32),
        keep=z(rounds, lanes, chunk, dtype=torch.bool),
        n_kept=z(rounds, lanes), vdd_idx=z(rounds, lanes),
        n_valid=z(rounds, lanes), mask=z(rounds, lanes, dtype=torch.bool),
        head=cursors[0], count=cursors[1], dropped=cursors[2],
    )


def compact_ring_init(rounds: int, lanes: int, chunk: int, cap: int, *,
                      device="cuda") -> CompactRingState:
    """Empty compact ring: the dense ring plus ``(cap,)`` records per
    slot-lane."""
    if not 1 <= cap <= chunk:
        raise ValueError(f"compact cap must be in [1, chunk], got {cap}")
    dense = ring_init(rounds, lanes, chunk, device=device)
    return CompactRingState(
        *dense,
        c_idx=torch.zeros((rounds, lanes, cap), dtype=torch.int32,
                          device=dense.head.device),
        c_val=torch.full((rounds, lanes, cap), -torch.inf,
                         dtype=torch.float32, device=dense.head.device),
    )


def ring_push(ring: RingState, outs: ChunkOutput, mask: torch.Tensor,
              n_valid: torch.Tensor) -> RingState:
    """Append one executed round to the ring, in place; returns ``ring``.

    ``outs`` is the round's lane-stacked ``ChunkOutput``, ``mask`` /
    ``n_valid`` its ``(lanes,)`` device rows.  A ``CompactRingState`` also
    stores the round's records.  On CUDA the whole push, records and
    cursors included, is one launch of K3's ring push
    (``ops.ring_push_op``).  The reference's ``active`` flag has no
    counterpart: the pool never pushes its padded rounds.
    """
    return ops.ring_push_op(ring, outs.scores, outs.keep, outs.n_kept,
                            outs.vdd_idx, n_valid, mask)


def ring_push_compact(ring: CompactRingState, outs: ChunkOutput,
                      mask: torch.Tensor,
                      n_valid: torch.Tensor) -> CompactRingState:
    """``ring_push`` onto a compact ring (the reference's name): the
    round's records are ranked in the same launch, so there is no
    ``compact_fn`` to bind."""
    if not isinstance(ring, CompactRingState):
        raise TypeError("ring_push_compact needs a CompactRingState")
    return ring_push(ring, outs, mask, n_valid)


def ring_slot_order(head: int, count: int, rounds: int) -> list[int]:
    """Host helper: slot indices of the ``count`` undrained rounds, oldest
    first (the order drains must distribute results in)."""
    return [(int(head) - int(count) + i) % int(rounds)
            for i in range(int(count))]
