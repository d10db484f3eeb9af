"""Stateful streaming sessions: one live event camera, served online
(``repro.serve.streaming``).

``StreamingDetector`` owns a one-lane ``DetectorState`` on its device
across arrivals (and steps its surfaces in place), accepts event slabs of
any length (a host buffer re-chunks them to the detector's fixed chunk
size), and returns per-event corner scores as chunks complete.
``flush()`` folds the partial tail, ``snapshot()`` / ``restore()``
checkpoint the whole session (state, buffer and accounting), and
``rebucket()`` hops a live session to a new chunk size through the same
path.  ``feed_device_chunk`` folds a chunk that is already on the device
(``events.stream.PrefetchingLoader(device_slabs=True)``).

Fed the same stream in any slab partition, a session produces the same
scores, final state and float64 energy books as one ``run_pipeline`` call
on the concatenated stream: streaming re-schedules the same fold.

Timebase: host timestamps are int64 microseconds; the device sees
chunk-relative int32 (base aligned to a DVFS half-window).  A session whose
relative clock passes ``REBASE_LIMIT_US`` is re-based: the SAE and the
rate estimator's window cursor shift by an explicit carry.

DVFS: only fixed-Vdd and online DVFS (``cfg.dvfs_online=True``) are
streamable; host-precomputed DVFS needs the whole stream and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import hwmodel
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core import state as state_mod
from repro_torch.core import stcf as stcf_mod
from repro_torch.obs import schema as obs_schema

__all__ = ["StreamingDetector", "session_base_us", "shift_state_base",
           "plan_rebase", "account_chunk", "REBASE_LIMIT_US"]

# Re-base a session once its chunk-relative clock passes this (us).  2**30
# leaves a full 2x headroom to int32 wrap even for pathological slabs.
REBASE_LIMIT_US = 1 << 30


def session_base_us(first_ts_us: int, cfg) -> int:
    """Timestamp base for a session whose first event is at ``first_ts_us``."""
    half = cfg.dvfs_cfg.half_us
    return (int(first_ts_us) // half) * half


def _check_streamable(cfg) -> None:
    if cfg.dvfs and not cfg.dvfs_online:
        raise ValueError(
            "host-precomputed DVFS needs the whole stream upfront and is "
            "incompatible with streaming; use dvfs_online=True (in-step "
            "controller) or dvfs=False (fixed vdd)"
        )


def shift_state_base(state: state_mod.DetectorState, delta_us: int,
                     half_us: int) -> state_mod.DetectorState:
    """Move a state's timebase forward by ``delta_us``, a non-negative
    multiple of the DVFS half-window.  The SAE's timestamps and the rate
    estimator's window cursor are the only time-bearing carries.  SAE
    entries that would fall below the 'never fired' sentinel clamp onto it:
    they are more than ``delta_us`` stale, far beyond any STCF window, so
    the clamp changes no future keep decision."""
    delta = int(delta_us)
    never = stcf_mod.NEVER
    sae = torch.where(state.sae > never // 2,
                      torch.clamp(state.sae, min=delta + never) - delta,
                      never).to(torch.int32)
    rate = state.rate._replace(
        win=(state.rate.win - delta // int(half_us)).to(torch.int32))
    return state._replace(sae=sae, rate=rate)


def plan_rebase(base: int, chunk_ts: np.ndarray, cfg) -> tuple[int, list]:
    """Decide the timebase carry before folding a chunk (shared by the
    session and the pool).  Returns ``(new_base, hops)``: int32-safe,
    half-window-aligned shifts to apply to the state in order.  A single
    chunk spanning more than int32 microseconds has no valid base and
    raises."""
    if int(chunk_ts[-1]) - base <= REBASE_LIMIT_US:
        return base, []
    new_base = session_base_us(int(chunk_ts[0]), cfg)
    hops: list[int] = []
    delta = new_base - base
    if delta <= 0:
        new_base = base
    else:
        half = cfg.dvfs_cfg.half_us
        hop_max = ((1 << 30) // half) * half
        while delta > 0:
            hop = min(delta, hop_max)
            hops.append(hop)
            delta -= hop
    if int(chunk_ts[-1]) - new_base > np.iinfo(np.int32).max:
        raise OverflowError(
            "a single chunk spans more than int32 microseconds of stream "
            "time; no timebase fits it"
        )
    return new_base, hops


def account_chunk(acc, n_kept: int, vdd_idx: int, *, online: bool,
                  tab, fixed_vdd: float) -> None:
    """Fold one chunk's output into host float64 books (shared by the
    session and the pool; the same formula as ``run_pipeline``'s).
    ``acc`` has ``kept_total`` / ``energy_pj`` / ``latency_ns`` /
    ``vdd_trace`` / ``n_chunks`` attributes."""
    vdd = float(tab.vdd64[int(vdd_idx)]) if online else float(fixed_vdd)
    nk = int(n_kept)
    acc.kept_total += nk
    acc.energy_pj += nk * hwmodel.patch_energy_pj(vdd)
    acc.latency_ns += nk * hwmodel.patch_latency_ns(vdd)
    acc.vdd_trace.append(vdd)
    acc.n_chunks += 1


class StreamingDetector:
    """One camera session: feed event slabs, get corner scores back.

    Construction puts a fresh one-lane state on ``cfg.device``.  ``feed``
    buffers slabs of any length, folds every completed chunk through
    ``detector_step`` and returns ``(scores, kept)`` for exactly the events
    those chunks consumed, in stream order, after one transfer per call.
    ``chunk=`` overrides the config's chunk size for this session.
    """

    def __init__(self, cfg, *, seed: Optional[int] = None,
                 base_ts: Optional[int] = None,
                 chunk: Optional[int] = None):
        _check_streamable(cfg)
        if chunk is not None:
            if chunk < 1:
                raise ValueError("chunk must be >= 1")
            cfg = dataclasses.replace(cfg, chunk=int(chunk))
        self._cfg = cfg
        self._tcfg = pipeline_mod._trace_cfg(cfg)
        self._device = state_mod.resolve_device(cfg.device)
        self._state = state_mod.detector_init(cfg, seed=seed,
                                              device=self._device)
        self._buf_xy = np.zeros((0, 2), np.int32)
        self._buf_ts = np.zeros((0,), np.int64)
        self._base: Optional[int] = None if base_ts is None else int(base_ts)
        self._online = bool(cfg.dvfs and cfg.dvfs_online)
        self._tab = dvfs_mod.op_point_table(cfg.dvfs_cfg)
        vdd = None if self._online else np.full((1,), cfg.vdd, np.float64)
        self._riders = tuple(
            state_mod.upload(r, self._device)
            for r in state_mod.chunk_input_riders(1, vdd, cfg))
        # Host-side float64 accounting (equal to run_pipeline's).
        self.n_events = 0
        self.n_chunks = 0
        self.kept_total = 0
        self.energy_pj = 0.0
        self.latency_ns = 0.0
        self.vdd_trace: list[float] = []
        self.rebuckets = 0            # chunk-size moves (see rebucket())

    # -- feeding ------------------------------------------------------------

    def feed(self, xy: np.ndarray, ts_us: np.ndarray
             ) -> tuple[np.ndarray, np.ndarray]:
        """Append a slab (any length, time-sorted) and fold complete chunks."""
        xy = np.asarray(xy, np.int32).reshape(-1, 2)
        ts = np.asarray(ts_us, np.int64).reshape(-1)
        if ts.size:
            if self._base is None:
                self._base = session_base_us(int(ts[0]), self._cfg)
            self._buf_xy = np.concatenate([self._buf_xy, xy], 0)
            self._buf_ts = np.concatenate([self._buf_ts, ts], 0)
            self.n_events += int(ts.size)
        return self._drain(flush_tail=False)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Fold the buffered partial tail (padded, masked invalid)."""
        return self._drain(flush_tail=True)

    def feed_device_chunk(self, xy: torch.Tensor, ts: torch.Tensor,
                          valid: torch.Tensor
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Fold one pre-chunked, pre-rebased chunk that is already on the
        session's device: ``xy (chunk, 2)`` int32, ``ts (chunk,)`` int32
        relative to the session's base, ``valid (chunk,)`` bool with the
        valid events first.

        The fast path for ``PrefetchingLoader(device_slabs=True,
        rebase_us=session_base_us(...))``, whose worker already uploaded
        the chunk.  Needs an empty host buffer (do not mix with partial
        ``feed`` slabs) and the base set to the loader's ``rebase_us``.
        Tensors on another device, of another dtype or length are refused,
        never moved.  The step reads the tensors and writes only the
        session's own state; the valid count comes back in the chunk's one
        transfer.
        """
        if self._buf_ts.size:
            raise RuntimeError(
                "feed_device_chunk cannot interleave with buffered feed() "
                "slabs; flush() first"
            )
        if self._base is None:
            raise RuntimeError(
                "set base_ts (== the loader's rebase_us) before feeding "
                "device chunks"
            )
        e, device = self._cfg.chunk, self._state.surface.device
        for name, t, dtype, shape in (("xy", xy, torch.int32, (e, 2)),
                                      ("ts", ts, torch.int32, (e,)),
                                      ("valid", valid, torch.bool, (e,))):
            if not isinstance(t, torch.Tensor) or t.device != device:
                where = t.device if isinstance(t, torch.Tensor) else type(t)
                raise ValueError(f"{name} must be a tensor on the session's "
                                 f"device {device}, got {where}")
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} must be {dtype} of shape {shape} (the "
                    f"session's chunk), got {t.dtype} {tuple(t.shape)}")
        chunk = state_mod.ChunkInput(
            xy=xy[None], ts=ts[None], valid=valid[None],
            ber=self._riders[0], energy_coef=self._riders[1],
            latency_coef=self._riders[2],
        )
        self._state, out = state_mod.detector_step_(self._tcfg, self._state,
                                                    chunk)
        return self._account([out], valid.sum(dtype=torch.int32)[None])

    # -- internals ----------------------------------------------------------

    def _maybe_rebase(self, chunk_ts: np.ndarray) -> None:
        """Re-base before folding a chunk whose relative clock ran long."""
        self._base, hops = plan_rebase(self._base, chunk_ts, self._cfg)
        for hop in hops:
            self._state = shift_state_base(self._state, hop,
                                           self._cfg.dvfs_cfg.half_us)

    def _drain(self, *, flush_tail: bool) -> tuple[np.ndarray, np.ndarray]:
        cfg = self._cfg
        outs, n_valids = [], []
        while self._buf_ts.size >= cfg.chunk:
            self._maybe_rebase(self._buf_ts[:cfg.chunk])
            outs.append(self._fold(self._buf_xy[:cfg.chunk],
                                   self._buf_ts[:cfg.chunk], cfg.chunk))
            n_valids.append(cfg.chunk)
            self._buf_xy = self._buf_xy[cfg.chunk:]
            self._buf_ts = self._buf_ts[cfg.chunk:]
        if flush_tail and self._buf_ts.size:
            self._maybe_rebase(self._buf_ts)
            n = int(self._buf_ts.size)
            xy = np.zeros((cfg.chunk, 2), np.int32)
            ts = np.full((cfg.chunk,), self._buf_ts[-1], np.int64)
            xy[:n] = self._buf_xy
            ts[:n] = self._buf_ts
            outs.append(self._fold(xy, ts, n))
            n_valids.append(n)
            self._buf_xy = self._buf_xy[:0]
            self._buf_ts = self._buf_ts[:0]
        return self._account(outs, n_valids)

    def _fold(self, xy: np.ndarray, ts: np.ndarray, n_valid: int):
        up = state_mod.upload
        chunk = state_mod.ChunkInput(
            xy=up(xy[None], self._device),
            ts=up((ts - self._base).astype(np.int32)[None], self._device),
            valid=up((np.arange(self._cfg.chunk) < n_valid)[None],
                     self._device),
            ber=self._riders[0], energy_coef=self._riders[1],
            latency_coef=self._riders[2],
        )
        self._state, out = state_mod.detector_step_(self._tcfg, self._state,
                                                    chunk)
        return out

    def _account(self, outs, n_valids) -> tuple[np.ndarray, np.ndarray]:
        """Fetch the folded chunks' outputs in one transfer and book them.
        ``n_valids`` are the chunks' valid counts: host ints, or an int32
        device tensor that rides in the same transfer (device chunks,
        whose events the session then counts)."""
        if not outs:
            return (np.zeros((0,), np.float32), np.zeros((0,), bool))
        counted = isinstance(n_valids, torch.Tensor)
        scores, keep, n_kept, vdd_idx, *rest = pipeline_mod._fetch(  # 1 sync
            *(torch.stack(parts) for parts in zip(*outs)),
            *((n_valids,) if counted else ()))
        if counted:
            n_valids = [int(n) for n in rest[0]]
            self.n_events += sum(n_valids)
        for i, n_valid in enumerate(n_valids):
            account_chunk(self, n_kept[i, 0], vdd_idx[i, 0],
                          online=self._online, tab=self._tab,
                          fixed_vdd=self._cfg.vdd)
        return (
            np.concatenate([scores[i, 0, :n] for i, n in
                            enumerate(n_valids)]).astype(np.float32),
            np.concatenate([keep[i, 0, :n] for i, n in
                            enumerate(n_valids)]).astype(bool),
        )

    # -- checkpointing ------------------------------------------------------

    def snapshot(self) -> dict:
        """Host checkpoint of the whole session (state, buffer and
        accounting); the state is owned numpy arrays in the reference's
        one-stream layout (``state.state_to_numpy``)."""
        return {
            "cfg": self._cfg,
            "state": state_mod.state_to_numpy(self._state),
            "buf_xy": self._buf_xy.copy(),
            "buf_ts": self._buf_ts.copy(),
            "base": self._base,
            "accounting": {
                "n_events": self.n_events,
                "n_chunks": self.n_chunks,
                "kept_total": self.kept_total,
                "energy_pj": self.energy_pj,
                "latency_ns": self.latency_ns,
                "vdd_trace": list(self.vdd_trace),
            },
        }

    def _load(self, snap: dict) -> None:
        """Adopt a snapshot's state, buffer and accounting (shared by
        ``restore`` and ``rebucket``); the state is copied onto the
        session's device."""
        self._state = state_mod.state_from_numpy(snap["state"],
                                                 device=self._device)
        self._buf_xy = np.asarray(snap["buf_xy"], np.int32).copy()
        self._buf_ts = np.asarray(snap["buf_ts"], np.int64).copy()
        self._base = snap["base"]
        acc = snap["accounting"]
        self.n_events = acc["n_events"]
        self.n_chunks = acc["n_chunks"]
        self.kept_total = acc["kept_total"]
        self.energy_pj = acc["energy_pj"]
        self.latency_ns = acc["latency_ns"]
        self.vdd_trace = list(acc["vdd_trace"])

    @classmethod
    def restore(cls, snap: dict) -> "StreamingDetector":
        det = cls(snap["cfg"], base_ts=snap["base"])
        det._load(snap)
        return det

    def rebucket(self, chunk: int) -> "StreamingDetector":
        """Move this live session to a new chunk size, in place, through
        the snapshot/restore path.  The state carries no chunk axis, so the
        hop is exact: buffered events re-chunk at the new size from the
        next ``feed``/``flush``.  Returns ``self``."""
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if int(chunk) == self._cfg.chunk:
            return self
        snap = self.snapshot()
        self._cfg = dataclasses.replace(self._cfg, chunk=int(chunk))
        self._tcfg = pipeline_mod._trace_cfg(self._cfg)
        self._load(snap)
        self.rebuckets += 1
        return self

    # -- degradation knobs --------------------------------------------------

    def set_control(self, *, lut_every: Optional[int] = None,
                    vdd_cap: Optional[int] = None,
                    shed: Optional[bool] = None) -> "StreamingDetector":
        """Set the session's degradation knobs (``DetectorState.ctrl``,
        host values): ``lut_every`` stretches the LUT refresh interval,
        ``vdd_cap`` caps the online-DVFS operating point (clamped to the
        table, inert in fixed-Vdd mode), ``shed`` suspends LUT refresh.
        Unset knobs keep their value.  Returns ``self``."""
        c = self._state.ctrl
        if lut_every is not None:
            c = c._replace(lut_every=np.full(1, max(1, int(lut_every)),
                                             np.int32))
        if vdd_cap is not None:
            top = len(self._tab.caps) - 1
            c = c._replace(vdd_cap=np.full(
                1, max(0, min(int(vdd_cap), top)), np.int32))
        if shed is not None:
            c = c._replace(shed=np.full(1, bool(shed), np.bool_))
        self._state = self._state._replace(ctrl=c)
        return self

    @property
    def control(self) -> dict:
        """Current degradation knobs."""
        c = self._state.ctrl
        return {"lut_every": int(np.asarray(c.lut_every).reshape(-1)[0]),
                "vdd_cap": int(np.asarray(c.vdd_cap).reshape(-1)[0]),
                "shed": bool(np.asarray(c.shed).reshape(-1)[0])}

    # -- introspection ------------------------------------------------------

    @property
    def state(self) -> state_mod.DetectorState:
        """The session's state, with copies of its surfaces: the session
        owns its own and steps them in place."""
        return self._state._replace(surface=self._state.surface.clone(),
                                    sae=self._state.sae.clone())

    @property
    def base_ts(self) -> Optional[int]:
        return self._base

    def stats(self) -> dict:
        """Session accounting: the host float64 books plus the state's
        on-device float32/int32 accumulators (``device_*``) and the in-state
        rate estimator's read-out (``events_per_s_est``, only integrated in
        online-DVFS mode), fetched in one transfer."""
        n_scored = max(self.kept_total, 1)
        s = self._state
        dev_kept, dev_energy, dev_latency, dev_p1, dev_p2 = (
            a[0] for a in pipeline_mod._fetch(
                s.kept_total, s.energy_pj, s.latency_ns, s.rate.prev1,
                s.rate.prev2))
        out = {
            "n_events": self.n_events,
            "n_chunks": self.n_chunks,
            "chunk": self._cfg.chunk,
            "rebuckets": self.rebuckets,
            "kept_total": self.kept_total,
            "energy_pj": self.energy_pj,
            "latency_ns_per_event": self.latency_ns / n_scored,
            "buffered": int(self._buf_ts.size),
            "events_per_s_est": state_mod.rate_estimate_eps(
                dev_p1, dev_p2, self._cfg.dvfs_cfg
            ),
            "device_kept_total": int(dev_kept),
            "device_energy_pj": float(dev_energy),
            "device_latency_ns": float(dev_latency),
        }
        # the export and its schema declaration may not drift apart
        if out.keys() != obs_schema.SESSION_STATS.keys():
            raise RuntimeError("session stats drifted from obs.schema")
        return out
