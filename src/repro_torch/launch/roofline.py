"""Roofline terms from the dry-run's counts (the port of
``repro.launch.roofline``).

Per (arch x shape x mesh) cell, all terms in *seconds per step*:

    compute    = dot_FLOPs_per_device / PEAK_BF16
    memory     = HBM_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / ICI_BW

The counts come from ``repro_torch.utils.hlo_analysis`` (one device's
operations, counted as they run) and the rates are the H100's
(``launch.mesh.HW``).  MODEL_FLOPS is the analytic 6·N_active·D (train) /
2·N_active·D (inference), so MODEL/counted FLOPs exposes remat recompute
and padding waste.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HW
from repro_torch.models.common import ModelConfig, _leaves
from repro_torch.models.transformer import init_spec
from repro_torch.utils.hlo_analysis import HloStats

__all__ = ["count_params", "model_flops", "roofline_terms", "RooflineReport"]


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the spec tree.

    'active' discounts routed experts to top_k/n_experts of their size
    (shared experts and everything else count fully) and excludes the
    embedding + head tables (standard 6ND convention).
    """
    total = 0
    active = 0
    for path, s in _leaves(init_spec(cfg)):
        names = "/".join(path)
        n = 1
        for d in s.shape:
            n *= d
        total += n
        if "embed" == names or "lm_head" in names:
            continue
        if "moe/" in names + "/" and any(
            names.endswith(f"moe/{w}") for w in ("wg", "wu", "wd")
        ):
            active += n * cfg.top_k / max(cfg.n_experts, 1)
        else:
            active += n
    return int(total), int(active)


def model_flops(cfg: ModelConfig, kind: str, seq: int, batch: int) -> float:
    """Analytic MODEL_FLOPS per step: 6·N_active·D train, 2·N_active·D fwd.

    encdec: the decoder processes min(seq, max_target_len) tokens and the
    encoder its fixed frame count — `seq` alone would be wrong either way.
    """
    _, n_active = count_params(cfg)
    if cfg.family == "encdec" and kind != "decode":
        tokens = batch * (min(seq, cfg.max_target_len) + cfg.n_audio_frames)
    elif kind == "decode":
        tokens = batch * 1
    else:
        tokens = batch * seq
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_dev: float
    useful_ratio: float            # MODEL / (counted * chips)
    collective_breakdown: dict
    hbm_bytes_per_dev: float
    note: str = ""

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    arch: str, shape: str, mesh_name: str, chips: int,
    stats: HloStats, cfg: ModelConfig, kind: str, seq: int, batch: int,
    note: str = "",
) -> RooflineReport:
    compute_s = stats.dot_flops / HW.PEAK_BF16_FLOPS
    memory_s = stats.hbm_bytes / HW.HBM_BW
    collective_s = stats.total_collective_bytes / HW.ICI_BW
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, kind, seq, batch)
    hlo_total = stats.dot_flops * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf,
        hlo_flops_per_dev=stats.dot_flops,
        useful_ratio=(mf / hlo_total) if hlo_total else 0.0,
        collective_breakdown=dict(stats.collective_bytes),
        hbm_bytes_per_dev=stats.hbm_bytes,
        note=note,
    )
