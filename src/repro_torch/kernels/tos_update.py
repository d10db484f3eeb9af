"""K4-K7, the chunked TOS update on its own: CUDA launchers and plain
versions.

The reference's secondary backends fold a chunk's kept events into the
surface without the rest of the step (``repro.kernels.tos_update``):

* K4 ``nmc_stream``: each event, in stream order, decrements its P x P
  patch (values below ``th`` drop to 0) and sets its centre to 255;
* K5 ``batched_fused``: the order-exact closed form, ``tos - k_total``
  clamped at ``th`` with the precomputed centre values overlaid
  (``centre >= 0``), where ``k_total`` counts the events whose patch
  covers a pixel;
* K6 ``nmc_stream_binned`` / K7 ``batched_fused_binned``: K4 / K5 over
  each 128 x 128 tile's own bin of at most ``cap`` events — the first
  ``cap`` valid events, in stream order, whose patch touches the tile
  (halo ``r``).  Tiles are those of the surface padded to multiples of
  128, as in the reference; ``cap=0`` means ``cap=E``, which is lossless.

``*_cuda`` launch ``csrc/tos_update.cu`` (K4, K6: the replay's closed form
over 64 x 64 tiles, every event in parallel; ``th >= 0`` only) and
``csrc/tos_count.cu`` (K5, K7: counts on the tensor cores).  ``*_ref`` are
the plain versions, written as the TPU kernels are: over the padded
128 x 128 tiles, a serial replay of each tile's events (K4, K6) or a
float32 row-band x column-band product of each tile's events (K5, K7),
then cropped.

Shapes (B lanes, H x W surface, E events): tos ``(B,H,W)`` uint8, xy
``(B,E,2)`` int32 as (x=col, y=row), valid ``(B,E)`` bool, centre
``(B,H,W)`` int32 (-1 where no event is centred).  Outputs are new
``(B,H,W)`` uint8 tensors.  ``bin_events_to_tiles`` is the reference's
binning with a leading lane axis.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tos import TOS_MAX
from repro_torch.kernels import _build

__all__ = [
    "TILE",
    "MAX_EVENTS",
    "bin_events_to_tiles",
    "nmc_stream_ref",
    "nmc_stream_cuda",
    "nmc_stream_binned_ref",
    "nmc_stream_binned_cuda",
    "batched_fused_ref",
    "batched_fused_cuda",
    "batched_fused_binned_ref",
    "batched_fused_binned_cuda",
]

TILE = 128           # the reference's tile edge; K6/K7 bin per such tile
MAX_EVENTS = 8192    # a block stages its tile's events in shared memory


def _grid(h: int, w: int) -> tuple[int, int]:
    return -(-h // TILE), -(-w // TILE)


def bin_events_to_tiles(xy, valid, *, grid_hw, patch: int, cap: int):
    """Bucket each lane's events by the 128 x 128 tiles their patch touches.

    Returns ``(binned (B, n_tiles, cap, 3) int32, overflow (B, n_tiles)
    bool)``: row ``j`` of a tile's bin is its j-th hit in stream order as
    ``(x, y, 1)``, rows past the hits carry ``ok = 0``; ``overflow`` flags
    tiles with more than ``cap`` hits (the rest are dropped).
    """
    r = (patch - 1) // 2
    ty, tx = grid_hw
    e = xy.shape[-2]
    ti = torch.arange(ty * tx, device=xy.device)
    ty0 = (ti // tx * TILE)[:, None]
    tx0 = (ti % tx * TILE)[:, None]
    x = xy[..., 0].to(torch.int32)[..., None, :]
    y = xy[..., 1].to(torch.int32)[..., None, :]
    hit = ((x >= tx0 - r) & (x < tx0 + TILE + r)
           & (y >= ty0 - r) & (y < ty0 + TILE + r)
           & valid[..., None, :])                       # (B, n_tiles, E)
    counts = hit.sum(-1)
    order = torch.sort((~hit).to(torch.uint8), dim=-1, stable=True).indices
    take = order[..., :cap]                             # hits first, in order
    ok = torch.gather(hit, -1, take)
    ev = torch.cat([xy.to(torch.int32), valid.to(torch.int32)[..., None]], -1)
    ev = ev[..., None, :, :].expand(*hit.shape, 3)
    binned = torch.gather(ev, -2, take[..., None].expand(*take.shape, 3))
    binned[..., 2] = ok.to(torch.int32)
    return binned, counts > cap


def _padded_tiles(tos: torch.Tensor) -> torch.Tensor:
    """``(B, H, W)`` -> int32 zero-padded ``(B, ty, TILE, tx, TILE)``."""
    b, h, w = tos.shape
    ty, tx = _grid(h, w)
    out = torch.zeros((b, ty * TILE, tx * TILE), dtype=torch.int32,
                      device=tos.device)
    out[:, :h, :w] = tos
    return out.reshape(b, ty, TILE, tx, TILE)


def _crop(tiles: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, ty, _, tx, _ = tiles.shape
    out = tiles.reshape(b, ty * TILE, tx * TILE)[:, :h, :w]
    return out.to(torch.uint8).contiguous()


def _all_events(xy, valid) -> torch.Tensor:
    """Every event for every tile: ``(B, 1, 1, E, 3)``."""
    ev = torch.cat([xy.to(torch.int32), valid.to(torch.int32)[..., None]], -1)
    return ev[:, None, None]


def _binned_events(xy, valid, h, w, patch, cap) -> torch.Tensor:
    """Each tile's bin: ``(B, ty, tx, cap, 3)``."""
    ty, tx = _grid(h, w)
    binned, _ = bin_events_to_tiles(xy, valid, grid_hw=(ty, tx), patch=patch,
                                    cap=cap or xy.shape[-2])
    return binned.reshape(xy.shape[0], ty, tx, -1, 3)


def _coords(tiles: torch.Tensor):
    """Global row and column indices broadcast over ``(B, ty, TILE, tx,
    TILE)``."""
    _, ty, _, tx, _ = tiles.shape
    rows = torch.arange(ty * TILE, device=tiles.device)
    cols = torch.arange(tx * TILE, device=tiles.device)
    return (rows.reshape(1, ty, TILE, 1, 1), cols.reshape(1, 1, 1, tx, TILE))


def _nmc_replay(tiles, ev, *, patch: int, th: int) -> torch.Tensor:
    """The TPU kernel's loop: each tile replays its events ``ev (B, ty|1,
    tx|1, n, 3)`` one by one over the whole tile."""
    r = (patch - 1) // 2
    rows, cols = _coords(tiles)
    surf = tiles
    for i in range(ev.shape[-2]):
        x, y, ok = (ev[..., i, k][:, :, None, :, None] for k in range(3))
        ok = ok > 0
        inside = ((rows - y).abs() <= r) & ((cols - x).abs() <= r) & ok
        dec = surf - 1
        dec = torch.where(dec >= th, dec, torch.zeros_like(dec))
        surf = torch.where(inside, dec, surf)
        centre = (rows == y) & (cols == x) & ok
        surf = torch.where(centre, torch.full_like(surf, TOS_MAX), surf)
    return surf


def _band_update(tiles, ev, centre, *, patch: int, th: int) -> torch.Tensor:
    """The TPU kernel's MXU form: per tile, ``k_total = RowBand^T @
    ColBand`` over its events ``ev (B, ty|1, tx|1, n, 3)`` in float32 (0/1
    operands, exact counts), then the threshold and the centre overlay."""
    r = (patch - 1) // 2
    rows, cols = _coords(tiles)
    x, y = ev[..., 0, None], ev[..., 1, None]          # (B, ty|1, tx|1, n, 1)
    ok = ev[..., 2, None] > 0
    row_band = (((rows.reshape(1, -1, 1, 1, TILE) - y).abs() <= r)
                & ok).to(torch.float32)                  # (B, ty, tx|1, n, T)
    col_band = (((cols.reshape(1, 1, -1, 1, TILE) - x).abs() <= r)
                & ok).to(torch.float32)                  # (B, ty|1, tx, n, T)
    k_total = torch.matmul(row_band.transpose(-1, -2), col_band)
    k_total = k_total.to(torch.int32).permute(0, 1, 3, 2, 4)
    bg = tiles - k_total
    bg = torch.where(bg >= th, bg, torch.zeros_like(bg))
    c = _padded_tiles(centre.to(torch.int32) + 1) - 1  # pad with -1
    return torch.where(c >= 0, c, bg)


def nmc_stream_ref(tos, xy, valid, *, patch: int, th: int):
    """Plain K4: every tile replays the whole chunk."""
    h, w = tos.shape[-2:]
    return _crop(_nmc_replay(_padded_tiles(tos), _all_events(xy, valid),
                             patch=patch, th=th), h, w)


def nmc_stream_binned_ref(tos, xy, valid, *, patch: int, th: int,
                          cap: int = 0):
    """Plain K6: every tile replays its own bin of at most ``cap``."""
    h, w = tos.shape[-2:]
    ev = _binned_events(xy, valid, h, w, patch, cap)
    return _crop(_nmc_replay(_padded_tiles(tos), ev, patch=patch, th=th),
                 h, w)


def batched_fused_ref(tos, xy, valid, centre, *, patch: int, th: int):
    """Plain K5: counts over the whole chunk, threshold, centre overlay."""
    h, w = tos.shape[-2:]
    return _crop(_band_update(_padded_tiles(tos), _all_events(xy, valid),
                              centre, patch=patch, th=th), h, w)


def batched_fused_binned_ref(tos, xy, valid, centre, *, patch: int, th: int,
                             cap: int = 0):
    """Plain K7: K5's counts over each tile's own bin."""
    h, w = tos.shape[-2:]
    ev = _binned_events(xy, valid, h, w, patch, cap)
    return _crop(_band_update(_padded_tiles(tos), ev, centre, patch=patch,
                              th=th), h, w)


# -- CUDA launchers --------------------------------------------------------

# kernel -> (source in csrc/, C entry point)
_ENTRY = {
    "nmc_stream": ("tos_update", "nmc_stream_launch"),
    "nmc_stream_binned": ("tos_update", "nmc_stream_binned_launch"),
    "batched_fused": ("tos_count", "batched_fused_launch"),
    "batched_fused_binned": ("tos_count", "batched_fused_binned_launch"),
}


def _lib(name: str):
    source, entry = _ENTRY[name]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        # tos_in, xy, valid, centre, tos_out; B, H, W, E, patch, th, cap
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, tos, xy, valid, centre, *, patch, th, cap):
    if name.startswith("nmc") and th < 0:
        raise ValueError(f"{name} needs th >= 0 (the replay's closed form), "
                         f"got {th}")
    device = tos.device
    if device.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {device}")
    b, h, w = tos.shape
    e = xy.shape[1]
    if not 1 <= e <= MAX_EVENTS:
        raise ValueError(f"chunk of {e} events; {name} takes 1..{MAX_EVENTS}")
    if patch % 2 != 1 or not 1 <= patch <= 31:
        raise ValueError(f"patch must be odd in [1, 31], got {patch}")
    cap = cap or e
    if not 1 <= cap <= e:
        raise ValueError(f"cap must be in [0, {e}], got {cap}")
    _build.check_tensor(tos, "tos", torch.uint8, (b, h, w), device)
    _build.check_tensor(xy, "xy", torch.int32, (b, e, 2), device)
    _build.check_tensor(valid, "valid", torch.bool, (b, e), device)
    if centre is not None:
        _build.check_tensor(centre, "centre", torch.int32, (b, h, w), device)
    out = torch.empty_like(tos)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib(name)(
            tos.data_ptr(), xy.data_ptr(), valid.data_ptr(),
            None if centre is None else centre.data_ptr(), out.data_ptr(),
            b, h, w, e, patch, th, cap, stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[name][1]} failed: CUDA error {err}")
    return out


def nmc_stream_cuda(tos, xy, valid, *, patch: int, th: int):
    """Launch K4 on the tensors' CUDA device and current stream."""
    return _launch("nmc_stream", tos, xy, valid, None, patch=patch, th=th,
                   cap=0)


def nmc_stream_binned_cuda(tos, xy, valid, *, patch: int, th: int,
                           cap: int = 0):
    """Launch K6 (``cap=0``: lossless)."""
    return _launch("nmc_stream_binned", tos, xy, valid, None, patch=patch,
                   th=th, cap=cap)


def batched_fused_cuda(tos, xy, valid, centre, *, patch: int, th: int):
    """Launch K5."""
    return _launch("batched_fused", tos, xy, valid, centre, patch=patch,
                   th=th, cap=0)


def batched_fused_binned_cuda(tos, xy, valid, centre, *, patch: int, th: int,
                              cap: int = 0):
    """Launch K7 (``cap=0``: lossless)."""
    return _launch("batched_fused_binned", tos, xy, valid, centre,
                   patch=patch, th=th, cap=cap)
