"""Device timing on the card, shared by ``chip_smoke.py`` and the TOS-kernel
cost model (``benchmarks.bench_tos_kernels``).

``cuda_ms`` times back-to-back calls with CUDA events (the device's wait
for the host to enqueue included); ``device_split`` / ``device_ms`` sum the
device time of every kernel and copy a call launches, from the profiler;
``launch_floor_ms`` is an empty kernel's launch by CUDA events.  All need a
CUDA device.  ``device_rows`` is the device records of a finished profile,
which every device sum in the repository reads.
"""
from __future__ import annotations

import sys

__all__ = ["cuda_ms", "device_ms", "device_rows", "device_split",
           "launch_floor_ms", "EVENT_FALLBACKS"]

# Times per call that ``device_split`` took by CUDA events because the
# profiler recorded nothing.
EVENT_FALLBACKS: list[float] = []


def device_rows(prof) -> list:
    """The device rows of ``prof.key_averages()``: kernels, copies and
    memsets.  A ``record_function`` range (a ``repro_torch.obs`` span) that
    launched device work also has a device-side row, a user annotation as
    long as the range; those rows are left out, as torch's own table leaves
    them out, since they would count the range's kernels again."""
    return [r for r in prof.key_averages()
            if str(r.device_type).endswith("CUDA")
            and not getattr(r, "is_user_annotation", False)]


def cuda_ms(fn, iters=30, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=30, warmup=3) -> float:
    """Mean device time per call of ``fn``: the summed device time of every
    kernel and copy it launches, from the profiler, over ``iters``
    back-to-back calls.  Unlike ``cuda_ms`` it does not count the gaps in
    which the device waits for the host to enqueue the next call."""
    return device_split(fn, (), iters, warmup)[0]


def device_split(fn, names, iters=30, warmup=3, windows=3):
    """``device_ms`` of ``fn`` and the device time per call of each kernel
    whose name holds one of ``names`` (ms).  The profiler now and then
    returns a window with no device record at all, or drops some records:
    every call launches the same kernels and copies, so a window counts
    only if each device record's count is a multiple of ``iters``.  An
    incomplete window is profiled again, up to ``windows`` times in all.
    If none is complete, the time per call comes from CUDA events over the
    same loop (launch gaps included, noted in ``EVENT_FALLBACKS`` and
    printed to stderr) and each kernel's share is ``None``: not
    measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        total = sum(r.self_device_time_total for r in rows) / 1e3 / iters
        if total > 0 and all(r.count % iters == 0 for r in rows):
            break
    else:
        total = cuda_ms(fn, iters, warmup=0)
        EVENT_FALLBACKS.append(total)
        print(f"[profile] the profiler recorded no complete window in "
              f"{windows}; {total:.5f} ms per call by CUDA events instead "
              f"(launch gaps included)", file=sys.stderr)
        return total, {n: None for n in names}
    per = {n: sum(r.self_device_time_total for r in rows if n in r.key)
           / 1e3 / iters for n in names}
    return total, per


def launch_floor_ms(iters=200) -> float:
    """Time per launch of an empty kernel (``torch.cuda._sleep(0)``, a spin
    of zero cycles) by CUDA events over back-to-back launches: what one
    more kernel launch costs a host-driven step."""
    import torch
    return cuda_ms(lambda: torch.cuda._sleep(0), iters=iters, warmup=10)
