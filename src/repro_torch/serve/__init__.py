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
  scheduler — the control plane: ``"static"``, ``"adaptive"`` (live
              bucket migration from the measured event rate),
              ``"ladder"`` (``DegradationLadder``: QoS-ordered degradation
              under backlog pressure, packing at its top level; tuned by
              ``LadderConfig``) and ``"pack"`` (``PackScheduler``: fleet
              packing that cuts padded H2D uploads), the last two acting
              on the runtime's per-pump ``Observation`` through
              ``Action`` records.
  pool      — ``DetectorPool``: the façade wiring the two together.
"""
from repro_torch.serve.pool import DetectorPool  # noqa: F401
from repro_torch.serve.runtime import PoolRuntime  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    Action,
    AdaptiveScheduler,
    DegradationLadder,
    LadderConfig,
    Observation,
    PackScheduler,
    StaticScheduler,
)
from repro_torch.serve.streaming import (  # noqa: F401
    StreamingDetector,
    session_base_us,
)

__all__ = [
    "StreamingDetector",
    "DetectorPool",
    "PoolRuntime",
    "StaticScheduler",
    "AdaptiveScheduler",
    "DegradationLadder",
    "PackScheduler",
    "LadderConfig",
    "Observation",
    "Action",
    "session_base_us",
]
