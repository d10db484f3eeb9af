"""DVFS controller (``repro.core.dvfs``): the operating-point table, the
host-precomputed per-chunk Vdd, and the streaming rate estimator.

``simulate_dvfs`` / ``per_chunk_vdd`` run on the host in numpy, as the
reference precomputes them before the scan.  The online estimator
(``RateState`` / ``online_vdd_from_chunk_ts``) runs on the state's device
with a leading lane axis, so the batch pipeline picks every lane's operating
point without a host round trip.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hwmodel

__all__ = [
    "DvfsConfig",
    "DvfsTrace",
    "simulate_dvfs",
    "per_chunk_vdd",
    "OpPointTable",
    "op_point_table",
    "RateState",
    "rate_state_init",
    "online_vdd_from_chunk_ts",
]


@dataclasses.dataclass(frozen=True)
class DvfsConfig:
    tw_us: int = 10_000          # TW_DVFS = 10 ms for the driving datasets
    counter_bits: int = 20
    headroom: float = 1.25       # pick a Vdd whose capacity >= rate * headroom
    vdd_floor: float = 0.6       # most aggressive operating point allowed
    vdd_ceiling: float | None = None   # highest selectable point (None = all)

    @property
    def half_us(self) -> int:
        return self.tw_us // 2   # each counter spans TW/2; stride = 50%


def _lut_points(cfg: DvfsConfig) -> list:
    """Floor/ceiling-filtered operating points, ascending Vdd."""
    lut = [p for p in hwmodel.dvfs_lut() if p["vdd"] >= cfg.vdd_floor - 1e-9]
    if cfg.vdd_ceiling is not None:
        lut = [p for p in lut if p["vdd"] <= cfg.vdd_ceiling + 1e-9]
        if not lut:
            raise ValueError(
                f"vdd_ceiling={cfg.vdd_ceiling} excludes every operating "
                f"point above vdd_floor={cfg.vdd_floor}"
            )
    return lut


@dataclasses.dataclass
class DvfsTrace:
    """Per-window trace of the controller (numpy)."""

    window_t_us: np.ndarray      # window end times
    est_meps: np.ndarray         # estimated event rate
    vdd: np.ndarray              # chosen operating voltage
    cap_meps: np.ndarray         # capacity of the chosen point
    energy_pj: np.ndarray        # dynamic energy spent in the window
    dropped: np.ndarray          # events dropped (rate > capacity)


def _pick_np(est_meps: np.ndarray, caps: np.ndarray,
             headroom: float) -> np.ndarray:
    """Lowest-Vdd entry with capacity >= est * headroom, else the highest."""
    ok = caps[None, :] >= (est_meps * np.float32(headroom))[:, None]
    return np.where(ok.any(1), ok.argmax(1), len(caps) - 1)


def simulate_dvfs(
    ts_us: np.ndarray,
    cfg: DvfsConfig = DvfsConfig(),
    *,
    use_dvfs: bool = True,
) -> DvfsTrace:
    """Run the DVFS controller over a time-sorted event stream (host).

    Counts per half-window saturate at ``2^counter_bits - 1``; the estimate
    for window ``w`` reads the closed bins ``w-2, w-1`` and divides in
    float32, as the reference does.
    """
    ts = np.asarray(ts_us, dtype=np.int64)
    if ts.ndim != 1:
        raise ValueError("ts_us must be one-dimensional")
    t_end = int(ts[-1]) + 1 if len(ts) else 1
    half = cfg.half_us
    n_win = max(2, int(np.ceil(t_end / half)) + 1)

    bins = np.clip(ts // half, 0, n_win - 1)
    counts = np.minimum(np.bincount(bins, minlength=n_win),
                        (1 << cfg.counter_bits) - 1)

    lut = _lut_points(cfg)
    caps = np.asarray([p["max_meps"] for p in lut], np.float32)
    vdds = np.asarray([p["vdd"] for p in lut])
    es = np.asarray([p["energy_pj"] for p in lut])

    closed = counts.astype(np.int64)
    pair = np.concatenate([[0, 0], closed[:-2] + closed[1:-1]])
    est_meps = pair.astype(np.float32) / np.float32(cfg.tw_us)

    if use_dvfs:
        idxs = _pick_np(est_meps, caps, cfg.headroom)
    else:
        idxs = np.full(est_meps.shape, len(lut) - 1, dtype=np.int64)

    vdd = vdds[idxs]
    cap = caps[idxs]
    served = np.minimum(counts.astype(np.float64), cap * half)
    dropped = counts - served
    energy = served * es[idxs]

    return DvfsTrace(
        window_t_us=(np.arange(n_win, dtype=np.float64) + 1) * half,
        est_meps=est_meps,
        vdd=vdd,
        cap_meps=cap,
        energy_pj=energy,
        dropped=dropped.astype(np.int64),
    )


def per_chunk_vdd(
    ts_us: np.ndarray,
    n_chunks: int,
    chunk: int,
    cfg: DvfsConfig = DvfsConfig(),
    *,
    n_events: int | None = None,
) -> np.ndarray:
    """Operating voltage of each fixed-size chunk (float64, host): the Vdd
    chosen for the half-window holding the chunk's first event."""
    ts = np.asarray(ts_us, dtype=np.int64)
    if n_events is None:
        n_events = len(ts)
    if n_chunks == 0:
        return np.zeros((0,), np.float64)
    trace = simulate_dvfs(ts, cfg)
    half = cfg.half_us
    win_of_ts = np.minimum(ts // half, len(trace.vdd) - 1)
    out = np.zeros((n_chunks,), np.float64)
    for c in range(n_chunks):
        w = int(win_of_ts[min(c * chunk, n_events - 1)]) if n_events else 0
        out[c] = float(trace.vdd[w])
    return out


class OpPointTable(NamedTuple):
    """Operating points as arrays (``vdd64`` for host books, float32 for
    everything the device consumes)."""

    vdd64: np.ndarray        # (P,) float64
    caps: np.ndarray         # (P,) float32 — capacity in Meps
    ber: np.ndarray          # (P,) float32
    energy_pj: np.ndarray    # (P,) float32 — energy per kept event
    latency_ns: np.ndarray   # (P,) float32 — latency per kept event


@functools.lru_cache(maxsize=None)
def op_point_table(cfg: DvfsConfig = DvfsConfig()) -> OpPointTable:
    """Host-side table of the controller's selectable operating points."""
    lut = _lut_points(cfg)
    return OpPointTable(
        vdd64=np.asarray([p["vdd"] for p in lut], np.float64),
        caps=np.asarray([p["max_meps"] for p in lut], np.float32),
        ber=np.asarray([p["ber"] for p in lut], np.float32),
        energy_pj=np.asarray([p["energy_pj"] for p in lut], np.float32),
        latency_ns=np.asarray(
            [hwmodel.patch_latency_ns(p["vdd"]) for p in lut], np.float32
        ),
    )


class RateState(NamedTuple):
    """Streaming twin of the paper's 3-counter round-robin estimator.

    Int32 tensors with a leading lane axis: ``win`` is the half-window of
    the latest integrated event, ``cur`` its (open) count, ``prev1`` /
    ``prev2`` the two most recently closed half-windows.
    """

    win: torch.Tensor
    cur: torch.Tensor
    prev1: torch.Tensor
    prev2: torch.Tensor


def rate_state_init(lanes: int = 1, *, device=None) -> RateState:
    return RateState(*(torch.zeros(lanes, dtype=torch.int32, device=device)
                       for _ in range(4)))


def _select(conds, vals, default):
    """``jnp.select`` on tensors: the first true condition's value."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def online_vdd_from_chunk_ts(
    rate: RateState,
    ts: torch.Tensor,
    valid: torch.Tensor,
    *,
    cfg: DvfsConfig,
    caps: torch.Tensor,
) -> tuple[RateState, torch.Tensor]:
    """One streaming controller step for every lane at once.

    ``ts`` / ``valid`` are ``(lanes, E)`` chunk-relative int32 timestamps
    and the valid mask; ``caps`` the ``(P,)`` float32 capacities on the same
    device.  Returns the new carry and the ``(lanes,)`` int32 operating-point
    index, bit-exact against ``repro.core.dvfs.online_vdd_from_chunk_ts``.

    The rate divide is spelled as a multiply by the float32 reciprocal of
    ``tw``: XLA folds the reference's divide by a constant into exactly that
    multiply, and the pick must match it bit for bit.
    """
    half = cfg.half_us
    sat = (1 << cfg.counter_bits) - 1
    has = valid.any(-1)
    zero = torch.zeros_like(rate.cur)

    w_first = torch.div(ts[:, 0], half, rounding_mode="floor")
    d = w_first - rate.win
    cur = torch.where(d == 0, rate.cur, zero)
    p1 = _select([d == 0, d == 1], [rate.prev1, rate.cur], zero)
    p2 = _select([d == 0, d == 1, d == 2],
                 [rate.prev2, rate.prev1, rate.cur], zero)

    pair = torch.clamp(p1, max=sat) + torch.clamp(p2, max=sat)
    inv_tw = float(np.float32(1.0) / np.float32(cfg.tw_us))
    est_meps = pair.to(torch.float32) * inv_tw
    need = est_meps * float(np.float32(cfg.headroom))
    ok = (caps[None, :] >= need[:, None]).to(torch.int32)
    idx = torch.where(ok.any(-1), ok.argmax(-1),
                      torch.full_like(ok[:, 0], caps.shape[0] - 1))

    w_last = torch.div(ts[:, -1], half, rounding_mode="floor")
    win_of = torch.div(ts, half, rounding_mode="floor")

    def count(k):
        return (valid & (win_of == (w_last - k)[:, None])).sum(
            -1, dtype=torch.int32)

    n0, n1, n2 = count(0), count(1), count(2)
    e = w_last - w_first
    cur2 = n0 + torch.where(e == 0, cur, zero)
    p1b = n1 + _select([e == 0, e == 1], [p1, cur], zero)
    p2b = n2 + _select([e == 0, e == 1, e == 2], [p2, p1, cur], zero)

    new = RateState(
        win=torch.where(has, w_last, rate.win).to(torch.int32),
        cur=torch.where(has, cur2, rate.cur).to(torch.int32),
        prev1=torch.where(has, p1b, rate.prev1).to(torch.int32),
        prev2=torch.where(has, p2b, rate.prev2).to(torch.int32),
    )
    return new, idx.to(torch.int32)
