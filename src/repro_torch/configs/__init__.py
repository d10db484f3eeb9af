"""Architecture configs of the LM scaffold (the port of ``repro.configs``):
the 10 public architectures, plus a reduced smoke variant of each family.

``get(name)`` returns the full ModelConfig; ``get_smoke(name)`` a reduced
config of the same family for CPU tests; ``SHAPES`` the input-shape grid.
Every ``CONFIG`` and ``SMOKE`` keeps the reference's values field for
field; the dtypes are ``torch.bfloat16`` (``ModelConfig``'s default).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = [
    "olmoe_1b_7b",
    "deepseek_v3_671b",
    "phi_3_vision_4_2b",
    "whisper_tiny",
    "qwen2_5_3b",
    "granite_20b",
    "qwen2_0_5b",
    "stablelm_3b",
    "mamba2_370m",
    "zamba2_1_2b",
]

# Assigned shape grid: name -> (kind, seq_len, global_batch)
SHAPES = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}

# Archs allowed to run long_500k (sub-quadratic decode); the pure
# full-attention archs skip it.
LONG_CONTEXT_OK = {"mamba2_370m", "zamba2_1_2b"}


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.SMOKE


def cells(include_skipped: bool = False):
    """The 40 (arch x shape) cells; skipped cells flagged."""
    out = []
    for a in ARCHS:
        cfg = get(a)
        for s, (kind, seq, gb) in SHAPES.items():
            skip = None
            if s == "long_500k" and a not in LONG_CONTEXT_OK:
                skip = "full-attention arch: 500k dense decode excluded per brief"
            out.append({"arch": a, "shape": s, "kind": kind, "seq": seq,
                        "batch": gb, "skip": skip})
    return out if include_skipped else [c for c in out if c["skip"] is None]
