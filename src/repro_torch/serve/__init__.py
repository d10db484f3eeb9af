"""Serving layer (``repro.serve``): streaming sessions and the multi-camera
pool, on the card.

  streaming — ``StreamingDetector``: one live camera session; feed event
              slabs of any length, scores come back as chunks complete;
              flush, snapshot/restore, timebase re-basing, a per-session
              ``chunk=``, ``rebucket()`` and ``set_control()``.
  runtime   — ``PoolRuntime``: the pool's data plane.  N sessions through
              per-bucket executors whose rounds land in device result
              rings (one transfer per drain), drained inline (``"sync"``)
              or by a reader thread on its own CUDA stream (``"async"``),
              with dense or compact (K3 records) readout and a pipelined
              stage -> dispatch pump.
  scheduler — placement policy: ``"static"``, or ``"adaptive"`` (live
              bucket migration from the measured event rate).
  pool      — ``DetectorPool``: the façade wiring the two together.
"""
from repro_torch.serve.pool import DetectorPool  # noqa: F401
from repro_torch.serve.runtime import PoolRuntime  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    AdaptiveScheduler,
    StaticScheduler,
)
from repro_torch.serve.streaming import (  # noqa: F401
    StreamingDetector,
    session_base_us,
)

__all__ = ["DetectorPool", "PoolRuntime", "StaticScheduler",
           "AdaptiveScheduler", "StreamingDetector", "session_base_us"]
