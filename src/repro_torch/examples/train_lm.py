"""Train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
        [--device cpu]

The port of the reference's ``examples/train_lm.py``: the framework's
production path (the train CLI under its local mesh, AdamW + cosine
schedule, remat'd layers, async checkpointing with crash-consistent
resume, straggler monitoring) on the card (``--device cuda``, the
default) or the host.  The dataset is a synthetic random-walk language
(deterministic per step, so resumable), so the loss falling from ~uniform
(ln 4096 = 8.3) toward the process entropy is a real learning signal.
``--ckpt-dir`` defaults to a directory of the port's own, so a run never
resumes from the reference's checkpoints.  ``main(argv)`` returns the
final parameters.
"""
import argparse
import math
import os
import sys
import tempfile
import types

from repro_torch import configs
from repro_torch.launch import train as train_mod
from repro_torch.models.common import ModelConfig, ParamSpec, _leaves
from repro_torch.models.transformer import init_spec

# ~100M params: 12L, d=768, 12H, ff=2048, vocab 4096 (tied).
CONFIG = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv=4, d_ff=2048, vocab=4096, tie_embeddings=True,
    loss_chunk=64, remat="dots",
)


def register(cfg: ModelConfig = CONFIG) -> str:
    """Register ``cfg`` as the config module ``repro_torch.configs.lm_100m``
    (its ``CONFIG`` and ``SMOKE``), where ``configs.get`` finds it; returns
    the arch name."""
    mod = types.ModuleType(f"{configs.__name__}.lm_100m")
    mod.CONFIG = cfg
    mod.SMOKE = cfg
    sys.modules[mod.__name__] = mod
    return "lm_100m"


def n_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, counted from its ``init_spec`` leaves."""
    return sum(math.prod(s.shape) for _, s in _leaves(init_spec(cfg))
               if isinstance(s, ParamSpec))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu to run on the host)")
    args = ap.parse_args(argv)

    arch = register(CONFIG)
    print(f"model: {n_params(CONFIG) / 1e6:.1f}M params")
    return train_mod.main([
        "--arch", arch, "--steps", str(args.steps),
        "--batch", "4", "--seq", "128", "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
