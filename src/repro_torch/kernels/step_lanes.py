"""The detector step's per-lane scalar chains: CUDA launchers and their
plain PyTorch versions.

``dvfs_pick_*`` is the step's online DVFS pick, before the chunk block:
every lane's rate-estimator step (``dvfs.online_vdd_from_chunk_ts``), its
operating point clamped at the lane's cap, the lane mask's select of the
estimator (inactive lanes keep theirs) and the point's BER, energy and
latency coefficients.  ``step_books_*`` runs after the block: every lane's
kept count, and the active lanes' kept total and energy and latency books.

``dvfs_pick_ref`` / ``step_books_ref`` are the plain versions, the step's
former tensor ops.  ``dvfs_pick_cuda`` / ``step_books_cuda`` launch
``csrc/step_lanes.cu``, one launch each, bit-exact to them (the source
gives the arithmetic, design and bound).  They replace no TPU kernel: the
JAX package leaves these chains to XLA, which fuses them.

Shapes (B lanes, E events): ``rate`` a ``dvfs.RateState`` of ``(B,)``
int32 rows, ``ts`` ``(B, E)`` int32, ``valid`` / ``keep`` ``(B, E)`` bool,
the books and coefficients ``(B,)``; ``cap`` is None (no lane capped), an
int for every lane, or a ``(B,)`` int32 row on the lanes' device; ``mask``
None (every lane active) or a ``(B,)`` bool row.  Both spellings return new
tensors and leave their inputs as they were; the launchers write each
call's outputs as rows of one int32 and one float32 block.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import dvfs as dvfs_mod
from repro_torch.kernels import _build

__all__ = ["op_table", "dvfs_pick_ref", "dvfs_pick_cuda", "step_books_ref",
           "step_books_cuda", "MAX_POINTS"]

MAX_POINTS = 8        # operating points the pick kernel's table may hold

_COLUMNS = ("caps", "ber", "energy_pj", "latency_ns")


@functools.lru_cache(maxsize=None)
def op_table(dvfs_cfg, device: torch.device) -> dict:
    """The operating-point columns on ``device``, uploaded once (a pageable
    upload inside the step would wait for the device every chunk), and
    ``"packed"``, the four as one ``(4, P)`` float32 block."""
    tab = dvfs_mod.op_point_table(dvfs_cfg)
    packed = torch.as_tensor(np.stack([getattr(tab, n) for n in _COLUMNS]),
                             dtype=torch.float32, device=device)
    return {**{n: packed[i] for i, n in enumerate(_COLUMNS)},
            "packed": packed}


def dvfs_pick_ref(rate, ts, valid, *, cfg, cap=None, mask=None):
    """Plain version: ``(rate, vdd_idx, ber, energy_coef, latency_coef)``."""
    tab = op_table(cfg, ts.device)
    new, vdd_idx = dvfs_mod.online_vdd_from_chunk_ts(
        rate, ts, valid, cfg=cfg, caps=tab["caps"])
    if cap is not None:
        vdd_idx = (torch.clamp(vdd_idx, max=cap) if isinstance(cap, int)
                   else torch.minimum(vdd_idx, cap))
    if mask is not None:
        new = dvfs_mod.RateState(*(torch.where(mask, n, o)
                                   for n, o in zip(new, rate)))
    i = vdd_idx.long()
    return (new, vdd_idx, tab["ber"][i], tab["energy_pj"][i],
            tab["latency_ns"][i])


def _accumulate(acc: torch.Tensor, nk: torch.Tensor,
               coef: torch.Tensor) -> torch.Tensor:
    """``acc + nk * coef`` in float32 with one rounding: the reference's
    XLA contracts it into a fused multiply-add.  ``nk * coef`` is exact in
    float64 (a count below 2**24 times a float32), so one float64 add and
    the cast to float32 round as the FMA does while ``acc`` stays below
    2**16 times the product."""
    return (acc.double() + nk.double() * coef.double()).to(torch.float32)


def step_books_ref(keep, kept_total, energy_pj, latency_ns, energy_coef,
                   latency_coef, mask=None):
    """Plain version: ``(n_kept, kept_total, energy_pj, latency_ns)``."""
    n_kept = keep.sum(-1, dtype=torch.int32)
    books = (kept_total + n_kept,
             _accumulate(energy_pj, n_kept, energy_coef),
             _accumulate(latency_ns, n_kept, latency_coef))
    if mask is not None:
        books = tuple(torch.where(mask, n, o) for n, o in
                      zip(books, (kept_total, energy_pj, latency_ns)))
    return (n_kept, *books)


_FNS: dict = {}
_ARGTYPES = {
    "dvfs_pick": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                  + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]),
    "step_books": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}


def _fn(name: str):
    """``<name>_launch`` of the built library, its argtypes set once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("step_lanes"), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(index, shape, rows) -> None:
    """Raise unless every ``(name, tensor, dtype)`` of ``rows`` is a
    contiguous tensor of ``dtype`` and ``shape`` on CUDA device ``index``
    (what the launch hands the kernel as a bare pointer)."""
    for name, t, dtype in rows:
        if (t.dtype != dtype or t.shape != shape or t.get_device() != index
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on cuda:{index}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _events(ts_or_keep, what):
    """``(device index, B, E)`` of a ``(B, E)`` CUDA tensor."""
    index = ts_or_keep.get_device()
    if index < 0:
        raise ValueError(f"{what} needs CUDA tensors, got "
                         f"{ts_or_keep.device}")
    if ts_or_keep.dim() != 2 or 0 in ts_or_keep.shape:
        raise ValueError(f"{what} needs (B, E) events with B, E >= 1, got "
                         f"{tuple(ts_or_keep.shape)}")
    b, e = ts_or_keep.shape
    return index, b, e


def dvfs_pick_cuda(rate, ts, valid, *, cfg, cap=None, mask=None):
    """Launch ``dvfs_pick_kernel`` on the tensors' CUDA device and current
    stream: ``(rate, vdd_idx, ber, energy_coef, latency_coef)``.  A cap
    below ``-P`` has no point to read: an int one is refused here, and the
    step refuses a row holding one on the host (the kernel reads point 0
    for it rather than outside the table)."""
    index, b, e = _events(ts, "dvfs_pick_cuda")
    lanes = torch.Size((b,))
    table = op_table(cfg, ts.device)["packed"]
    p = table.shape[1]
    if not 1 <= p <= MAX_POINTS:
        raise ValueError(f"{p} operating points; the pick takes "
                         f"1..{MAX_POINTS}")
    if cfg.half_us < 1:
        raise ValueError(f"half window {cfg.half_us} us; needs >= 1")
    rows = [(f"rate.{n}", r, torch.int32)
            for n, r in zip(dvfs_mod.RateState._fields, rate)]
    cap_ptr, cap_int = 0, p - 1
    if isinstance(cap, int):
        cap_int = cap
    elif cap is not None:
        rows.append(("cap", cap, torch.int32))
        cap_ptr = cap.data_ptr()
    if mask is not None:
        rows.append(("mask", mask, torch.bool))
    _check(index, lanes, rows)
    _check(index, ts.shape, (("ts", ts, torch.int32),
                             ("valid", valid, torch.bool)))
    if cap_int < -p:
        raise ValueError(f"cap {cap_int} is below the table's {p} points")
    out_i = torch.empty((5, b), dtype=torch.int32, device=ts.device)
    out_f = torch.empty((3, b), dtype=torch.float32, device=ts.device)
    sat = (1 << cfg.counter_bits) - 1
    inv_tw = float(np.float32(1.0) / np.float32(cfg.tw_us))
    _build.launch(_fn("dvfs_pick"), index, *(r.data_ptr() for r in rate),
                  ts.data_ptr(), valid.data_ptr(), table.data_ptr(), cap_ptr,
                  0 if mask is None else mask.data_ptr(), out_i.data_ptr(),
                  out_f.data_ptr(), b, e, p, cfg.half_us, sat, inv_tw,
                  float(np.float32(cfg.headroom)), cap_int)
    win, cur, prev1, prev2, vdd_idx = out_i.unbind(0)
    return (dvfs_mod.RateState(win, cur, prev1, prev2), vdd_idx,
            *out_f.unbind(0))


def step_books_cuda(keep, kept_total, energy_pj, latency_ns, energy_coef,
                    latency_coef, mask=None):
    """Launch ``step_books_kernel`` on the tensors' CUDA device and current
    stream: ``(n_kept, kept_total, energy_pj, latency_ns)``."""
    index, b, e = _events(keep, "step_books_cuda")
    rows = [("kept_total", kept_total, torch.int32),
            ("energy_pj", energy_pj, torch.float32),
            ("latency_ns", latency_ns, torch.float32),
            ("energy_coef", energy_coef, torch.float32),
            ("latency_coef", latency_coef, torch.float32)]
    if mask is not None:
        rows.append(("mask", mask, torch.bool))
    _check(index, torch.Size((b,)), rows)
    _check(index, keep.shape, (("keep", keep, torch.bool),))
    out_i = torch.empty((2, b), dtype=torch.int32, device=keep.device)
    out_f = torch.empty((2, b), dtype=torch.float32, device=keep.device)
    _build.launch(_fn("step_books"), index, keep.data_ptr(),
                  *(t.data_ptr() for _, t, _ in rows[:5]),
                  0 if mask is None else mask.data_ptr(), out_i.data_ptr(),
                  out_f.data_ptr(), b, e)
    return (*out_i.unbind(0), *out_f.unbind(0))
