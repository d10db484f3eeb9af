"""Camera streams for the benchmark, made from ``--seed``.

A config's ``stream`` names its generator, the module
``perfbench/generators/<generator>.py``, and gives its parameters.  A lane
replays its stream in a loop: pass ``k`` is the stream with every
timestamp advanced by ``k`` durations, so the stream time keeps rising and
generation costs the same whatever the window's length.
"""
from __future__ import annotations

import numpy as np

from perfbench.lib import manifest


class Replay:
    """One lane's stream, replayed in a loop with rising timestamps."""

    def __init__(self, xy: np.ndarray, ts: np.ndarray, duration_us: int):
        self.xy, self.ts, self.duration = xy, ts, int(duration_us)
        self.n = len(ts)

    def take(self, start: int, stop: int) -> tuple[np.ndarray, np.ndarray]:
        """Events ``[start, stop)`` of the endless replay."""
        idx = np.arange(start, stop)
        passes, pos = np.divmod(idx, self.n)
        return self.xy[pos], self.ts[pos] + passes * self.duration


def lane_streams(stream: dict, sensor: dict, cameras: int, seed: int,
                 root=manifest.ROOT):
    """The cameras' replays and their detector seeds, both drawn from
    ``seed``: stream seeds first, then one key seed per lane (int32 range,
    as the detector's key takes them)."""
    rng = np.random.default_rng(seed)
    stream_seeds = rng.integers(0, 2**31 - 1, cameras)
    key_seeds = [int(s) for s in rng.integers(0, 2**31 - 1, cameras)]
    kw = {k: v for k, v in stream.items() if k != "generator"}
    gen = manifest.generator(stream["generator"], root).generate
    lanes = []
    for s in stream_seeds:
        xy, ts = gen(height=sensor["height"], width=sensor["width"],
                     seed=int(s), **kw)
        lanes.append(Replay(xy, ts, kw["duration_us"]))
    return lanes, key_seeds
