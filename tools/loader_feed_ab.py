#!/usr/bin/env python3
"""Time a session fed through the prefetching loader against the host
``feed`` path, and the loader with its worker finished before the feed.

    python3 tools/loader_feed_ab.py [--reps N] [--duration-us US]

Needs one NVIDIA GPU with ``nvcc``.  On the 80 ms shapes stream (chunk
512, online DVFS, no BER) it times, in turns, ``N`` runs each of:

  * ``host``: ``StreamingDetector.feed`` in chunk-sized slabs, then
    ``flush`` (one upload and one fetch per chunk, on the consumer);
  * ``loader``: ``PrefetchingLoader(device_slabs=True)`` and
    ``feed_device_chunk``, the worker uploading while the session folds;
  * ``preloaded``: the same loader with a queue deep enough for the whole
    stream, its worker joined before the clock starts, so the session
    folds chunks that are already on the card with no second thread
    running.

Every run's scores must equal the batch scan's.  Prints events/s per run
and the median of each, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--duration-us", type=int, default=80_000)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("loader_feed_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import pipeline
    from repro_torch.events import stream as stream_mod
    from repro_torch.events import synthetic
    from repro_torch.serve import StreamingDetector, session_base_us

    print(chip_smoke.nvidia_smi())
    st = synthetic.shapes_stream(duration_us=args.duration_us, seed=0)
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2, dvfs=True,
                                  dvfs_online=True)
    batch = pipeline.run_pipeline(st.xy, st.ts, cfg)
    base = session_base_us(int(st.ts[0]), cfg)
    n_chunks = -(-len(st) // cfg.chunk)

    def host():
        det = StreamingDetector(cfg)
        t0 = time.perf_counter()
        parts = [det.feed(st.xy[i:i + cfg.chunk], st.ts[i:i + cfg.chunk])[0]
                 for i in range(0, len(st), cfg.chunk)]
        parts.append(det.flush()[0])
        return time.perf_counter() - t0, parts

    def loader(depth=2, preload=False):
        det = StreamingDetector(cfg, base_ts=base)
        ld = stream_mod.PrefetchingLoader(st, cfg.chunk, depth=depth,
                                          device_slabs=True, rebase_us=base)
        if preload:
            ld._thread.join(timeout=60)
            assert not ld._thread.is_alive()
        t0 = time.perf_counter()
        parts = [det.feed_device_chunk(*c)[0] for c in ld]
        dt = time.perf_counter() - t0
        ld.close()
        return dt, parts

    runs = {"host": host, "loader": loader,
            "preloaded": lambda: loader(depth=n_chunks + 1, preload=True)}
    for fn in runs.values():
        fn()                                   # warm
    rates = {name: [] for name in runs}
    for _ in range(args.reps):
        for name, fn in runs.items():
            dt, parts = fn()
            if not np.array_equal(np.concatenate(parts), batch.scores):
                raise AssertionError(f"{name}: scores differ from the scan")
            rates[name].append(len(st) / dt)
    for name, r in rates.items():
        print(f"{name}: {len(st)} events in {n_chunks} chunks, events/s "
              + ", ".join(f"{x:.0f}" for x in r)
              + f"; median {statistics.median(r):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
