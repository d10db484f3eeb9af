#!/usr/bin/env python3
"""Does the LM train CLI's loss fall at full width, and at which rate?

    python3 tools/lm_train_lr.py [--arch qwen2-0.5b] [--steps 30]
                                 [--lr 3e-4,1e-3,3e-3]

Needs one NVIDIA GPU.  Runs ``repro_torch.launch.train.main`` at the
config's published width and the CLI's defaults (batch 8, seq 256) once
per learning rate, each in a fresh checkpoint directory (one final save,
no periodic one), and prints every step's loss with the first-3 and
last-3 means; then the same number of steps of ``make_train_step`` on one
fixed batch (the stream's first) at the CLI's schedule and the first rate.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", default="3e-4,1e-3,3e-3")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("lm_train_lr: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.launch import train as cli
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    losses: list[float] = []

    class Recording(cli.TrainSupervisor):
        def run(self, *a, on_metrics, **k):
            def both(step, m):
                losses.append(m["loss"])
                on_metrics(step, m)
            return super().run(*a, on_metrics=both, **k)

    cli.TrainSupervisor = Recording
    rates = [float(x) for x in args.lr.split(",")]
    for lr in rates:
        losses.clear()
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--arch", args.arch, "--steps", str(args.steps),
                      "--lr", str(lr), "--ckpt-every", str(args.steps + 1),
                      "--ckpt-dir", d])
        print(f"CLI stream, lr {lr}: first-3 mean {np.mean(losses[:3]):.4f}"
              f" -> last-3 mean {np.mean(losses[-3:]):.4f}; losses "
              f"{[round(x, 4) for x in losses]}")

    cfg = configs.get(args.arch)
    dev = torch.device("cuda")
    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt = AdamWConfig(lr=rates[0], total_steps=args.steps,
                      warmup_steps=min(20, args.steps // 10 + 1))
    state = adamw_init(params, opt)
    batch = cli.synthetic_batch_fn(cfg, 8, 256, device=dev)(0)
    step = make_train_step(cfg, opt)
    fixed = []
    for _ in range(args.steps):
        params, state, m = step(params, state, batch)
        fixed.append(float(m["loss"]))
    print(f"one fixed batch, lr {rates[0]}: first-3 mean "
          f"{np.mean(fixed[:3]):.4f} -> last-3 mean {np.mean(fixed[-3:]):.4f};"
          f" losses {[round(x, 4) for x in fixed]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
