"""Fault tolerance and elasticity of the train loop (the port of
``repro.train.fault_tolerance``; host-side, the step stays functional).

  * ``TrainSupervisor`` wraps the train loop: periodic async checkpoints,
    crash-consistent resume (LATEST pointer + deterministic data cursor),
    bounded retry of transient step failures, straggler detection via a
    step-time EWMA.  It waits on each step's loss inside the retry, so an
    asynchronous CUDA error is caught by the step that raised it.  Leaves
    restored from a checkpoint go back onto the device and dtype of the
    leaves they replace.
  * ``StragglerMonitor``: per-step wall-time EWMA + spike detection.
  * ``elastic_remesh``: given a device count that shrank, the largest
    (data, model) layout that still fits, the model axis fixed.  It
    describes the layout (``Mesh``); binding it to ``torch.distributed``
    is the mesh tools' work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_mod

__all__ = ["StragglerMonitor", "TrainSupervisor", "elastic_remesh", "Mesh"]


class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``factor`` x EWMA."""

    def __init__(self, alpha: float = 0.1, factor: float = 2.5):
        self.alpha = alpha
        self.factor = factor
        self.ewma: Optional[float] = None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (
            self.ewma is not None and dt > self.factor * self.ewma
        )
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt
        )
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) device layout: ``devices`` is a data x model object
    array of ``torch.device``; ``shape`` maps each axis name to its size."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _devices() -> list[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def elastic_remesh(n_devices: int, *, model: int = 16,
                   axis_names=("data", "model")) -> Mesh:
    """Largest (data, model) layout fitting n_devices with a fixed model
    axis: the model axis (TP/EP) is topology-locked, the data axis absorbs
    node loss (256 -> 240 devices gives data=15)."""
    model = min(model, n_devices)
    data = max(1, n_devices // model)
    devs = np.empty(data * model, dtype=object)
    devs[:] = _devices()[: data * model]
    return Mesh(devs.reshape(data, model), tuple(axis_names))


def _wait(x) -> None:
    """Wait for ``x`` (a step's loss) to be computed; raises the device's
    error if the step failed there."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _onto(restored, like):
    """A restored leaf on ``like``'s device and in its dtype."""
    if isinstance(like, torch.Tensor):
        return restored.to(device=like.device, dtype=like.dtype)
    return restored


def _map_like(fn, tree, like):
    """``fn(leaf, like_leaf)`` over two trees of one structure (dicts,
    tuples, lists)."""
    if isinstance(like, dict):
        return {k: _map_like(fn, tree[k], like[k]) for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_map_like(fn, t, l) for t, l in zip(tree, like))
    return fn(tree, like)


@dataclasses.dataclass
class TrainSupervisor:
    """Checkpointed, restartable, straggler-aware train loop driver."""

    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 2
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)

    def run(
        self,
        step_fn: Callable,            # (params, opt_state, batch) -> (p, s, metrics)
        params,
        opt_state,
        batch_fn: Callable[[int], dict],   # step -> batch (deterministic!)
        n_steps: int,
        *,
        start_step: Optional[int] = None,
        on_metrics: Optional[Callable[[int, dict], None]] = None,
    ):
        step = start_step if start_step is not None else 0
        # Crash-consistent resume: LATEST + the data cursor in `extra`.
        latest = ckpt_mod.latest_step(self.ckpt_dir)
        if start_step is None and latest is not None:
            like = (params, opt_state)
            restored, extra = ckpt_mod.restore(self.ckpt_dir, like)
            params, opt_state = _map_like(_onto, restored, like)
            step = int(extra.get("data_cursor", latest))

        pending = None
        while step < n_steps:
            batch = batch_fn(step)
            t0 = time.perf_counter()
            attempt = 0
            while True:
                try:
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                    _wait(metrics["loss"])
                    break
                except Exception:
                    attempt += 1
                    if attempt > self.max_retries:
                        raise
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            if on_metrics:
                on_metrics(step, {**{k: float(v) for k, v in metrics.items()},
                                  "dt": dt})

            step += 1
            if step % self.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = ckpt_mod.save_async(
                    self.ckpt_dir, step, (params, opt_state),
                    extra={"data_cursor": step},
                )
        if pending is not None:
            pending.join()
        ckpt_mod.save(self.ckpt_dir, step, (params, opt_state),
                      extra={"data_cursor": step})
        return params, opt_state

