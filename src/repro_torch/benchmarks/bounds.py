"""The H100's published rates and the least time each port kernel's work
could take on it: one set of rates and one byte accounting, shared by
``chip_smoke.py`` (the kernels' ``bound_ms``) and the TOS-kernel cost model
(``benchmarks.bench_tos_kernels``).

Rates are NVIDIA's data sheet for the H100 SXM part, dense, at its full
700 W power limit: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor
cores, 989 TFLOP/s fp16 on the tensor cores; integer operations at 64 INT32
lanes per SM over 132 SMs at the 1.98 GHz boost clock.

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over ``MEM_BPS``, and the
operations it does over the peak rate of their type.  Where the work
depends on the data, the counts are this call's.  Each function returns
milliseconds and which of the two bounds it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MEM_BPS", "FP32_OPS", "FP32_ROUNDED", "INT32_OPS",
           "TENSOR_FP16_FLOPS", "HBM_BYTES", "ICI_BW", "VMEM_BYTES",
           "covered", "k1_work", "k1_bound", "k2_bound", "k3_bound",
           "push_bound", "tos_bound", "DISPATCH_OPS", "ber_draw_bound"]

MEM_BPS = 3.35e12            # H100 SXM HBM3, bytes/s (data sheet)
FP32_OPS = 66.9e12           # H100 SXM float32 outside the tensor cores
FP32_ROUNDED = FP32_OPS / 2  # separately rounded adds or multiplies: the
                             # peak counts an FMA as two operations
INT32_OPS = 132 * 64 * 1.98e9   # 64 INT32 lanes per SM, 132 SMs, 1.98 GHz
TENSOR_FP16_FLOPS = 989e12   # H100 SXM dense fp16 on the tensor cores
                             # (bf16 is the same rate)
HBM_BYTES = 80e9             # H100 SXM device memory, 80 GB (data sheet)
ICI_BW = 450e9               # NVLink 4, bytes/s per direction (data sheet:
                             # 900 GB/s bidirectional per card)
"""The NVLink rate between the cards of one node.  A 16x16 mesh spans 32
eight-card nodes, whose links to each other are their network cards',
which are slower: a collective term at this rate is a lower bound."""
VMEM_BYTES = 228 * 1024      # shared memory per SM, 228 KiB (Hopper tuning
                             # guide): the card's nearest thing to VMEM
DISPATCH_OPS = 2 * INT32_OPS  # 4 schedulers issue 32 lanes a clock per
                             # SM: an integer add may go to the FMA pipe
                             # (IMAD) beside the 64-lane integer ALU pipe
THREEFRY_OPS = 72   # one threefry2x32 block: 2 key adds, 20 rounds of add,
                    # rotate and xor, 5 injections of two adds
THREEFRY_ALU = 40   # its rotates and xors: only the ALU pipe issues them
DRAW_OPS = THREEFRY_OPS + 4  # one write-error bit: a block, then the xor
                             # of its words, shift, compare and bit set
DRAW_ALU = THREEFRY_ALU + 2  # of which on the ALU pipe alone: + xor, shift


def _bound(nbytes, t_ops):
    t_b = nbytes / MEM_BPS
    return max(t_b, t_ops) * 1e3, ("bytes" if t_b >= t_ops else "operations")


def covered(xy, mask, radius, h, w) -> int:
    """Distinct pixels within ``radius`` (square) of the masked events, per
    lane summed; ``xy (B, E, 2)`` and ``mask (B, E)`` numpy arrays."""
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


def k1_work(b, h, w, e, patch, xy, valid, keep, inject):
    """One K1 call's work, updating the surfaces in place (the step drops
    the old state): ``(bytes, integer operations, bytes out of place)``.
    Events read and keep/scores written once; the SAE read over the valid
    events' 3x3 neighbourhoods and written at their centres; the LUT read
    at the kept centres; the TOS read and written over the kept patches, or
    over every pixel with the bits when injecting.  Operations: nine SAE
    tests per event, the patch writes, and four per pixel for BER.  Pixel
    counts are this chunk's distinct ones.  The out-of-place call reads and
    copies both surfaces whole."""
    r = patch // 2
    ev = b * e * (8 + 4 + 1) + b * e * (1 + 4)
    nbytes = ev + 4 * covered(xy, valid, 1, h, w)
    nbytes += 4 * covered(xy, valid, 0, h, w) + 4 * covered(xy, keep, 0, h, w)
    if inject:
        nbytes += b * h * w * (1 + 4 + 1) + b * 4
    else:
        nbytes += 2 * covered(xy, keep, r, h, w)
    ops = 9 * int(valid.sum()) + int(keep.sum()) * patch * patch + (
        b * h * w * 4 if inject else 0)
    out_of_place = ev + b * h * w * 2 * (1 + 4) + 4 * int(keep.sum())
    out_of_place += (b * h * w * 4 + b * 4) if inject else 0
    return nbytes, ops, out_of_place


def k1_bound(b, h, w, e, patch, xy, valid, keep, inject):
    """Least time for one K1 call's work (``k1_work``): ``(ms, what bounds
    it, ms of the out-of-place call's bytes)``."""
    nbytes, ops, out_of_place = k1_work(b, h, w, e, patch, xy, valid, keep,
                                        inject)
    return (*_bound(nbytes, ops / INT32_OPS), out_of_place / MEM_BPS * 1e3)


def k2_bound(b, h, w, sobel=5, window=5):
    """Least time for one K2 call at its exact rounding contract: tos read
    and R written once (bytes), against the float32 operations the
    bit-equal spelling needs, each separately rounded add or multiply one
    instruction (``FP32_ROUNDED``): ``/255`` per pixel; on the gradient
    region (the surface plus the window halo) a multiply and an add per
    nonzero Sobel tap of gx and gy and the three products
    ``wtap * (g * g)``; per pixel 3 x window^2 adds and the 7-operation
    det/trace tail.  Returns (bound ms, what bounds it, bytes ms,
    operations ms)."""
    from repro_torch.core.harris import sobel_kernels
    gx, gy = sobel_kernels(sobel)
    rw = window // 2
    grad = b * (h + 2 * rw) * (w + 2 * rw)
    pix = b * h * w
    ops = (pix + grad * (2 * np.count_nonzero(gx) + 2 * np.count_nonzero(gy)
                         + 6) + pix * (3 * window * window + 7))
    t_b, t_o = pix * (1 + 4) / MEM_BPS, int(ops) / FP32_ROUNDED
    return (*_bound(pix * (1 + 4), t_o), t_b * 1e3, t_o * 1e3)


def k3_bound(keep, cap):
    """Least time for one K3 call on this ``keep`` (bool tensor, rows x E):
    every keep byte read once, the float32 scores of each row's first
    ``min(kept, cap)`` kept events read (no other score is needed), the
    records (int32 index, float32 score) and the count written once; the
    integer work (a compare, a ballot and a popcount per event) is far
    below the bytes."""
    rows, e = keep.shape
    read = int(keep.sum(dim=1).clamp(max=cap).sum())
    nbytes = rows * (e + cap * 8 + 4) + 4 * read
    return _bound(nbytes, rows * e * 3 / INT32_OPS)


def push_bound(lanes, e, cap):
    """Least time for one ring push: the round's rows read once (scores,
    keep, three int32 and one bool per lane) and written once into the
    slot, the ``cap`` records per lane written (compact ring, ``cap`` > 0)
    and the three cursors read and written; no arithmetic to speak of."""
    row = lanes * (e * 5 + 13)
    nbytes = 2 * row + lanes * cap * 8 + 24
    return nbytes / MEM_BPS * 1e3, "bytes"


def tos_bound(b, h, w, e, patch, keep, *, centre):
    """Least time for one K4-K7 call: the surface read and the new one
    written once, the events (xy int32, valid bool) read once, and for
    K5/K7 the int32 centre surface read once; integer operations, a
    compare and an update per kept event's patch pixel (``keep`` is the
    call's valid mask), are far below."""
    nbytes = b * h * w * (2 + (4 if centre else 0)) + b * e * (8 + 1)
    ops = 2 * int(keep.sum()) * patch * patch
    return _bound(nbytes, ops / INT32_OPS)


def ber_draw_bound(b, h, w):
    """Least time for one write-error draw (``kernels.ber_draw``): per
    lane two threefry blocks for the key split, per pixel five bits of
    ``DRAW_OPS`` each.  The operations take the longer of their rotates and
    xors (``DRAW_ALU`` a bit) at the ALU pipe's ``INT32_OPS`` and all of
    them at the issue rate ``DISPATCH_OPS``; the bytes are the keys and
    rates read and the new keys and int32 masks written once.  Returns (bound ms,
    what bounds it, bytes ms, operations ms)."""
    alu = b * (2 * THREEFRY_ALU + 5 * h * w * DRAW_ALU)
    ops = b * (2 * THREEFRY_OPS + 5 * h * w * DRAW_OPS)
    nbytes = b * (16 + 4 + 16 + 4 * h * w)
    t_b = nbytes / MEM_BPS
    t_o = max(alu / INT32_OPS, ops / DISPATCH_OPS)
    return (*_bound(nbytes, t_o), t_b * 1e3, t_o * 1e3)
