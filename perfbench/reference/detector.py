"""Plain reference of the served detector: one camera lane per row of a
lane batch, chunk by chunk, in plain PyTorch (any device) and numpy.

Per chunk of a lane (the paper's pipeline, as the configuration states
it).  A chunk is ``chunk`` consecutive events, or, where a lane's chunk
schedule is given, the next size it lists: a pool that moves a lane between
chunk buckets folds it in chunks of each bucket in turn, and a flushed lane
ends on a partial chunk.  The lane's chunk count runs on across a move:
``c`` below counts every chunk the lane folded.

1. DVFS: the lane's rate estimate reads the events of the two half-windows
   (``tw_us / 2``) before the chunk's first event; the operating point is
   the lowest voltage whose capacity covers ``estimate * headroom``.  It
   fixes the chunk's write-error rate, energy and latency per patch.
2. STCF: an event is kept iff at least ``support`` of its 8 neighbours
   last fired within ``tw`` microseconds before it (earlier events of the
   chunk count as they arrive); every event stamps its pixel.
3. TOS (Algorithm 1): each kept event, in order, decrements its 7x7 patch,
   zeroes the values that fall below ``th`` and sets its centre to 255.
4. Write errors: every nonzero pixel is written back through its 5-bit
   code (value - 224), each bit flipping with the chunk's rate, drawn by
   threefry from the lane's key (one split per chunk: chunk ``c`` draws
   with the ``c``-th key of the lane's chain).
5. Scores: a kept event reads the Harris LUT built before this chunk
   (-inf while none has been built, and for dropped events).
6. After chunk ``c`` with ``(c + 1) % lut_every == 0`` the LUT is rebuilt
   from the surface:
   extended 5x5 Sobel gradients of ``tos / 255`` over a zero-padded frame,
   their products averaged over a 5x5 window, ``R = det - k * trace**2``.
7. Books: kept events times the operating point's energy and latency per
   patch, summed in float64 (host) and in a float32 accumulator rounded
   once per chunk (the device's).

``dtype`` is the precision of the Harris response and of the device books:
float64 is the reference; a lower one (bfloat16) is the control, whose
host books are float32.  Values are rounded to it after every operation.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import hwmodel, threefry

UNFIRED = -(1 << 62)


@dataclasses.dataclass(frozen=True)
class Params:
    height: int
    width: int
    chunk: int
    patch: int
    th: int
    lut_every: int
    stcf_tw_us: int
    stcf_support: int
    sobel: int
    window: int
    harris_k: float
    dvfs_tw_us: int
    dvfs_headroom: float
    vdd_floor: float
    counter_bits: int
    inject_ber: bool
    dvfs: bool = True           # online DVFS; else every chunk at ``vdd``
    vdd: float = 1.2
    stcf: bool = True           # STCF off: every valid event is kept


@dataclasses.dataclass
class LaneResult:
    scores: np.ndarray        # (N,) float64, -inf where not scored
    kept: np.ndarray          # (N,) bool
    n_chunks: int
    kept_total: int
    energy_pj: float          # float64 books
    latency_ns: float
    dev_energy_pj: float      # the chunk-rounded accumulator
    dev_latency_ns: float
    vdd_idx: np.ndarray       # (n_chunks,)
    surface: np.ndarray       # final TOS


def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float64 else x.to(dtype).to(torch.float64)


def operating_points(p: Params, ts: np.ndarray,
                     starts: np.ndarray = None) -> np.ndarray:
    """Operating-point index in ``table(p)`` of each chunk of one lane's
    time-sorted ``ts`` (int64 us), the chunks starting at the event indices
    ``starts`` (default: every ``p.chunk`` events, the length then a
    multiple of the chunk)."""
    if starts is None:
        starts = np.arange(0, len(ts), p.chunk)
    starts = np.asarray(starts, np.int64)
    if not p.dvfs:
        return np.zeros(len(starts), np.int64)
    tab = hwmodel.op_points(p.vdd_floor)
    half = p.dvfs_tw_us // 2
    sat = (1 << p.counter_bits) - 1
    win = ts // half
    first = win[starts]
    est = np.zeros(len(starts))
    for back in (1, 2):
        lo = np.searchsorted(win, first - back, "left")
        hi = np.searchsorted(win, first - back, "right")
        est += np.minimum(np.clip(starts, lo, hi) - lo, sat)
    need = est / p.dvfs_tw_us * p.dvfs_headroom
    ok = tab["cap_meps"][None, :] >= need[:, None]
    return np.where(ok.any(1), ok.argmax(1), len(tab["vdd"]) - 1)


def table(p: Params) -> dict:
    """The selectable operating points: the DVFS table, or the one fixed
    point."""
    if p.dvfs:
        return hwmodel.op_points(p.vdd_floor)
    return {"vdd": np.array([p.vdd]),
            "ber": np.array([hwmodel.ber_at(p.vdd)]),
            "energy_pj": np.array([hwmodel.patch_energy_pj(p.vdd)]),
            "latency_ns": np.array([hwmodel.patch_latency_ns(p.vdd)])}


def sobel(size: int) -> tuple[np.ndarray, np.ndarray]:
    """Extended Sobel taps (x, y): binomial smoothing across, the
    difference of binomials along, each normalised to unit absolute sum."""
    smooth = np.array([math.comb(size - 1, i) for i in range(size)], float)
    lower = np.array([math.comb(size - 2, i) for i in range(size - 1)], float)
    deriv = np.concatenate([lower, [0.0]]) - np.concatenate([[0.0], lower])
    gx = np.outer(smooth, deriv)
    return gx / np.abs(gx).sum(), gx.T / np.abs(gx).sum()


def harris(tos: torch.Tensor, p: Params, dtype) -> torch.Tensor:
    """Harris response of ``(L, H, W)`` uint8 surfaces, float64 tensors
    rounded to ``dtype`` after every operation."""
    gx_k, gy_k = sobel(p.sobel)
    halo = p.sobel // 2 + p.window // 2
    q = lambda x: _round_to(x, dtype)   # noqa: E731
    img = q(tos.to(torch.float64) / 255.0)
    img = F.pad(img[:, None], (halo,) * 4)
    ker = torch.tensor(np.stack([gx_k, gy_k])[:, None], dtype=torch.float64,
                       device=tos.device)
    g = q(F.conv2d(img, ker))
    gx, gy = g[:, :1], g[:, 1:]
    prods = torch.cat([q(gx * gx), q(gy * gy), q(gx * gy)], 1)
    box = torch.full((3, 1, p.window, p.window), 1.0 / p.window ** 2,
                     dtype=torch.float64, device=tos.device)
    s = q(F.conv2d(prods, box, groups=3))
    a, b, c = s[:, 0], s[:, 1], s[:, 2]
    det = q(q(a * b) - q(c * c))
    tr = q(a + b)
    return q(det - q(p.harris_k * q(tr * tr)))


def _box_counts(counts: torch.Tensor, r: int) -> torch.Tensor:
    """Sum of ``counts (L, H, W)`` over the (2r+1)^2 box around each pixel
    (clipped at the frame) by an integral image."""
    lanes, h, w = counts.shape
    ii = torch.zeros((lanes, h + 2 * r + 1, w + 2 * r + 1), dtype=torch.int64,
                     device=counts.device)
    ii[:, r + 1:r + 1 + h, r + 1:r + 1 + w] = counts
    ii = ii.cumsum(1).cumsum(2)
    d = 2 * r + 1
    return (ii[:, d:, d:] - ii[:, :-d, d:] - ii[:, d:, :-d]
            + ii[:, :-d, :-d])[:, :h, :w]


PAIR_ELEMS = 1 << 24      # (lanes, E, E) elements a step holds at once


def lane_groups(chunks) -> list:
    """Runs of consecutive lanes stepped together: a run grows while its
    pairwise tensors, ``(lanes, E, E)`` at the run's widest chunk, hold at
    most ``PAIR_ELEMS`` elements."""
    groups, widest = [], 0
    for i, sizes in enumerate(chunks):
        w = int(max(sizes, default=1))
        wider = max(widest, w)
        if groups and (len(groups[-1]) + 1) * wider ** 2 <= PAIR_ELEMS:
            groups[-1].append(i)
            widest = wider
        else:
            groups.append([i])
            widest = w
    return groups


class _Draws:
    """The write errors' Bernoulli bits, drawn for a block of chunks at
    once.  Only a nonzero pixel is written back, and a pixel that is zero
    at a block's start can only turn nonzero as some event's centre, so
    the block's draws are made at those pixels alone (the counters of the
    threefry stream at pixel ``p``, bit ``b`` are ``5 p + b``); a chunk
    then applies the bits of its pixels that are nonzero.  ``flat`` holds
    every event's pixel, ``bounds[i, c]`` lane ``i``'s first event of its
    chunk ``c`` (its event count past its last chunk)."""

    MAX_WORDS = 1 << 25       # draws held at once, per block

    def __init__(self, keys, p23, injects, flat, bounds, h, w, widest):
        self.keys, self.p23, self.injects = keys, p23, injects
        self.flat, self.bounds = flat, bounds
        self.lanes, self.hw, self.e = keys.shape[0], h * w, widest
        self.dev = keys.device
        self.weights = 1 << torch.arange(5, device=self.dev)
        self.pos = torch.arange(flat.shape[1], device=self.dev)
        self.start = self.stop = 0
        self.most = keys.shape[1]

    def _block(self, c: int, tos: torch.Tensor) -> None:
        lanes, e, dev = self.lanes, self.e, self.dev
        cand = (tos > 0).reshape(lanes, -1)
        n0 = int(cand.sum())
        k = max(1, min(self.most - c, self.MAX_WORDS
                       // max(1, 5 * (n0 + lanes * e * 4))))
        # the centres of the block's events, lane by lane
        inside = ((self.pos[None, :] >= self.bounds[:, c, None])
                  & (self.pos[None, :] < self.bounds[:, c + k, None]))
        lane_of = torch.arange(lanes, device=dev)[:, None] * self.hw
        cand = cand.clone().reshape(-1)
        cand[(lane_of + self.flat)[inside]] = True
        cand = cand.reshape(lanes, -1)
        li, pix = torch.nonzero(cand, as_tuple=True)
        slot = torch.full((lanes, self.hw), -1, dtype=torch.int64,
                          device=dev)
        slot[li, pix] = torch.arange(li.numel(), device=dev)
        ctr = pix[None, :, None] * 5 + torch.arange(5, device=dev)
        key = self.keys[:, c:c + k]                           # (L, k, 2)
        k0 = key[li, :, 0].T[:, :, None]
        k1 = key[li, :, 1].T[:, :, None]
        m = threefry.words_torch(k0, k1, ctr) >> 9           # (k, n, 5)
        flips = (m.to(torch.float64)
                 < self.p23[li, c:c + k].T[:, :, None]).long()
        self.bits = (flips * self.weights).sum(2)             # (k, n)
        self.slot, self.start, self.stop = slot, c, c + k

    def apply(self, c: int, tos: torch.Tensor) -> torch.Tensor:
        """``tos`` after chunk ``c``'s write-back."""
        if not self.start <= c < self.stop:
            self._block(c, tos)
        flat = tos.reshape(self.lanes, -1)
        live = (flat > 0) & self.injects[:, c, None]
        li, pix = torch.nonzero(live, as_tuple=True)
        code = (flat[li, pix] - 224) ^ self.bits[c - self.start,
                                                 self.slot[li, pix]]
        flat[li, pix] = torch.where(code > 0, code + 224,
                                    torch.zeros_like(code))
        return tos


class Reference:
    """Lanes of the reference detector, stepped chunk by chunk."""

    def __init__(self, p: Params, seeds, *, device="cpu",
                 dtype=torch.float64):
        self.p = p
        self.seeds = list(seeds)
        self.device = torch.device(device)
        self.dtype = dtype
        self.tab = table(p)

    def run(self, xy_lanes, ts_lanes, chunks=None) -> list[LaneResult]:
        """Fold every lane's events (lists of ``(N_i, 2)`` int32 xy and
        ``(N_i,)`` int64 ts).  ``chunks[i]`` lists lane ``i``'s chunk sizes
        in stream order, summing to ``N_i``; without it every chunk is
        ``p.chunk`` and each ``N_i`` must be a multiple of it.  Lanes step
        together in the runs of ``lane_groups``, each chunk padded with
        invalid events to the step's widest."""
        p = self.p
        if chunks is None:
            if any(len(t) % p.chunk for t in ts_lanes):
                raise ValueError("every lane's length must be a multiple "
                                 "of the chunk")
            chunks = [[p.chunk] * (len(t) // p.chunk) for t in ts_lanes]
        chunks = [np.asarray(c, np.int64).reshape(-1) for c in chunks]
        if len(chunks) != len(self.seeds) or len(ts_lanes) != len(chunks):
            raise ValueError("one chunk schedule and one stream per seed")
        for t, c in zip(ts_lanes, chunks):
            if (c < 1).any() or int(c.sum()) != len(t):
                raise ValueError("a lane's chunk sizes must be positive and "
                                 "sum to its events")
        if p.height * p.width * 5 >= 1 << 32:
            raise ValueError("frame too large for one counter word")
        out = [None] * len(chunks)
        for group in lane_groups(chunks):
            res = self._run_group([xy_lanes[i] for i in group],
                                  [ts_lanes[i] for i in group],
                                  [chunks[i] for i in group],
                                  [self.seeds[i] for i in group])
            for i, r in zip(group, res):
                out[i] = r
        return out

    def _run_group(self, xy_lanes, ts_lanes, chunks, seeds) -> list:
        p, dev = self.p, self.device
        lanes, h, w = len(seeds), p.height, p.width
        n_chunks = [len(c) for c in chunks]
        totals = [int(c.sum()) for c in chunks]
        most, longest = max(n_chunks), max(totals)
        # bounds[i, c]: lane i's first event of chunk c; its total after
        bounds = np.zeros((lanes, most + 1), np.int64)
        xy_all = torch.zeros((lanes, longest, 2), dtype=torch.int64)
        ts_all = torch.zeros((lanes, longest), dtype=torch.int64)
        vidx = np.zeros((lanes, most), np.int64)
        for i in range(lanes):
            n, ts_i = totals[i], np.asarray(ts_lanes[i], np.int64)
            bounds[i, 1:] = n
            bounds[i, 1:n_chunks[i] + 1] = np.cumsum(chunks[i])
            xy_all[i, :n] = torch.from_numpy(np.asarray(xy_lanes[i],
                                                        np.int64))
            ts_all[i, :n] = torch.from_numpy(ts_i)
            vidx[i, :n_chunks[i]] = operating_points(
                p, ts_i, bounds[i, :n_chunks[i]])
        widths = np.diff(bounds, axis=1)                     # (L, C)
        step_e = widths.max(0) if most else np.zeros(0, np.int64)
        xy_all, ts_all = xy_all.to(dev), ts_all.to(dev)
        active = torch.from_numpy(widths > 0)
        ber = self.tab["ber"][vidx]                          # (L, C)
        p23 = torch.from_numpy(ber.astype(np.float32).astype(np.float64)
                               * 2.0 ** 23).to(dev)
        injects = torch.from_numpy((ber > 0) & active.numpy()).to(dev)
        keys = torch.from_numpy(threefry.key_chain(seeds, most).astype(
            np.int64)).to(dev)                               # (L, C, 2)
        act_all = active.to(dev)
        bnd = torch.from_numpy(bounds).to(dev)
        wid = torch.from_numpy(widths).to(dev)
        lut_due = np.array([p.lut_every > 0 and (c + 1) % p.lut_every == 0
                            for c in range(most)])

        tos = torch.zeros((lanes, h, w), dtype=torch.int64, device=dev)
        sae = torch.full((lanes, h, w), UNFIRED, dtype=torch.int64,
                         device=dev)
        lut = torch.full((lanes, h, w), -np.inf, dtype=torch.float64,
                         device=dev)
        ready = torch.zeros(lanes, dtype=torch.bool, device=dev)
        lane_ar = torch.arange(lanes, device=dev)
        # every event's score and keep flag, at its place in its lane's
        # stream; a padding event writes the spare column past the end
        sc_out = torch.full((lanes, longest + 1), -np.inf,
                            dtype=torch.float64, device=dev)
        kp_out = torch.zeros((lanes, longest + 1), dtype=torch.bool,
                             device=dev)
        r = p.patch // 2
        neigh = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if (dy, dx) != (0, 0)]
        ndy = torch.tensor([d[0] for d in neigh], device=dev)
        ndx = torch.tensor([d[1] for d in neigh], device=dev)
        ncode = torch.tensor([(dy + 1) * 3 + dx + 1 for dy, dx in neigh],
                             device=dev)
        draws = _Draws(keys, p23, injects,
                       xy_all[..., 1] * w + xy_all[..., 0], bnd, h, w,
                       int(step_e.max(initial=1)))
        pairs = {}
        n_kept = []
        for c in range(most):
            e = int(step_e[c])
            if e not in pairs:
                ar = torch.arange(e, device=dev)
                pairs[e] = (ar, ar[None, :] < ar[:, None],   # [i, j]: j < i
                            ar[None, :] > ar[:, None])       # [i, j]: j > i
            ar, earlier, later = pairs[e]
            act = act_all[:, c]
            pos = bnd[:, c, None] + ar[None, :]
            valid = ar[None, :] < wid[:, c, None]
            idx = torch.where(valid, pos, torch.zeros_like(pos))
            xy = xy_all.gather(1, idx[..., None].expand(lanes, e, 2))
            ts = ts_all.gather(1, idx)
            x, y = xy[..., 0], xy[..., 1]

            # STCF: a neighbour counts if it fired within tw before the
            # event, in an earlier chunk (the SAE) or earlier in this one.
            dxp = x[:, None, :] - x[:, :, None]              # (L, i, j)
            dyp = y[:, None, :] - y[:, :, None]
            adj = (dxp.abs() <= 1) & (dyp.abs() <= 1)
            hit = (adj & earlier & valid[:, None, :]
                   & (ts[:, :, None] - ts[:, None, :] <= p.stcf_tw_us))
            code = torch.where(hit, (dyp + 1) * 3 + dxp + 1,
                               torch.full_like(dxp, 4))
            from_chunk = torch.zeros((lanes, e, 9), dtype=torch.int64,
                                     device=dev).scatter_reduce(
                2, code, hit.long(), "amax")
            qy, qx = y[..., None] + ndy, x[..., None] + ndx  # (L, E, 8)
            inb = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
            last = sae.reshape(lanes, -1).gather(
                1, (qy.clamp(0, h - 1) * w + qx.clamp(0, w - 1)).reshape(
                    lanes, -1)).reshape(lanes, e, 8)
            from_sae = inb & (last > UNFIRED) & (
                ts[..., None] - last <= p.stcf_tw_us)
            n_recent = (from_sae | (from_chunk[..., ncode] > 0)).sum(2)
            keep = ((n_recent >= p.stcf_support) if p.stcf else valid) & valid
            flat = y * w + x
            stamp = torch.where(valid, ts, torch.full_like(ts, UNFIRED))
            sae = sae.reshape(lanes, -1).scatter_reduce(
                1, flat, stamp, "amax").reshape(lanes, h, w)

            # Scores from the LUT built before this chunk.
            raw = lut[lane_ar[:, None], y, x]
            sc = torch.where(keep & ready[:, None], raw,
                             torch.full_like(raw, -np.inf))

            # TOS: background minus its cover count, overlaid by the last
            # centre write at each pixel minus the patches that follow it.
            counts = torch.zeros((lanes, h * w), dtype=torch.int64,
                                 device=dev)
            counts.scatter_add_(1, flat, keep.long())
            cover = _box_counts(counts.reshape(lanes, h, w), r)
            bg = tos - cover
            bg = torch.where(bg >= p.th, bg, torch.zeros_like(bg))
            covers = ((dxp.abs() <= r) & (dyp.abs() <= r) & later
                      & keep[:, None, :] & keep[:, :, None])
            centre = 255 - covers.sum(2)
            centre = torch.where(centre >= p.th, centre,
                                 torch.zeros_like(centre))
            idx = ar.expand(lanes, e)
            last_at = torch.full((lanes, h * w), -1, dtype=torch.int64,
                                 device=dev).scatter_reduce(
                1, flat, torch.where(keep, idx, torch.full_like(idx, -1)),
                "amax")
            is_last = keep & (last_at.gather(1, flat) == idx)
            new = bg.reshape(lanes, -1)
            li, ei = torch.nonzero(is_last, as_tuple=True)
            # one event per pixel is the last, so each write is unique
            new[li, flat[li, ei]] = centre[li, ei]
            tos = torch.where(act[:, None, None], new.reshape(lanes, h, w),
                              tos)

            # Write errors on the nonzero pixels of the injecting lanes.
            if p.inject_ber:
                tos = draws.apply(c, tos)

            if lut_due[c]:
                lut = torch.where(act[:, None, None],
                                  harris(tos, p, self.dtype), lut)
                ready |= act
            spare = torch.where(valid, pos, torch.full_like(pos, longest))
            sc_out.scatter_(1, spare, sc)
            kp_out.scatter_(1, spare, keep)
            n_kept.append(keep.sum(1))
        nk = (torch.stack(n_kept).cpu().numpy() if most
              else np.zeros((0, lanes), np.int64))           # (C, L)
        return self._finish(sc_out[:, :longest].cpu().numpy(),
                            kp_out[:, :longest].cpu().numpy(), nk,
                            n_chunks, totals, vidx, tos)

    def _finish(self, sc_all, kp_all, nk, n_chunks, totals, vidx,
                tos) -> list:
        """Per-lane outputs and books, chunk by chunk in stream order."""
        lanes, most = len(n_chunks), max(n_chunks)
        coef = np.stack([self.tab["energy_pj"], self.tab["latency_ns"]], 1)
        acc_dtype = (torch.float32 if self.dtype == torch.float64
                     else self.dtype)
        coef_acc = torch.from_numpy(coef).to(acc_dtype).to(torch.float64)
        host = np.float64 if self.dtype == torch.float64 else np.float32
        books = np.zeros((lanes, 2), host)
        acc = torch.zeros((lanes, 2), dtype=torch.float64)
        for c in range(most):
            act = np.array([c < n for n in n_chunks])
            books[act] += (nk[c, act, None] * coef[vidx[act, c]]).astype(
                host)
            step = (acc + torch.from_numpy(nk[c, :, None].astype(np.float64))
                    * coef_acc[vidx[:, c]]).to(acc_dtype).to(torch.float64)
            acc = torch.where(torch.from_numpy(act)[:, None], step, acc)
        surf = tos.to(torch.uint8).cpu().numpy()
        out = []
        for i in range(lanes):
            k = kp_all[i, :totals[i]].copy()
            out.append(LaneResult(
                scores=sc_all[i, :totals[i]].copy(), kept=k,
                n_chunks=n_chunks[i], kept_total=int(k.sum()),
                energy_pj=float(books[i, 0]), latency_ns=float(books[i, 1]),
                dev_energy_pj=float(acc[i, 0]),
                dev_latency_ns=float(acc[i, 1]),
                vdd_idx=vidx[i, :n_chunks[i]], surface=surf[i]))
        return out
