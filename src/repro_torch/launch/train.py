"""End-to-end LM training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--smoke]

The port of ``repro.launch.train``, with its flags, defaults, printed
lines and return value (the final parameters), on one card (``--device
cuda``, the default; ``--device cpu`` runs on the host): random weights
from seed 0, AdamW, deterministic synthetic LM data, async checkpoints
and crash-consistent resume, straggler monitoring
(``repro_torch.train.fault_tolerance.TrainSupervisor``).  A directory
whose ``LATEST`` is already at ``--steps`` resumes there and takes no
step.  As in the reference, every step runs under the local mesh
(``make_local_mesh(data=world size)``: 1x1 on one card) and its sharding
rules; the parameters stay plain tensors, so the rules place nothing and
the results equal those of a run without a mesh.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.state import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, world_size
from repro_torch.meshctx import use_mesh_rules
from repro_torch.models import transformer as T
from repro_torch.train.fault_tolerance import TrainSupervisor
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step


def synthetic_batch_fn(cfg, batch, seq, *, seed=0, device="cuda"):
    """Deterministic step->batch function (checkpoint-resume friendly):
    a bigram-ish random-walk language so the loss actually falls.  The
    reference's numpy draws, as tensors on ``device``."""
    vocab = cfg.vocab
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    def fn(step: int):
        rng = np.random.default_rng(seed + step)
        start = rng.integers(0, vocab, (batch, 1))
        steps = rng.integers(-3, 4, (batch, seq))
        toks = np.abs(start + np.cumsum(steps, 1)) % vocab
        b = {
            "tokens": put(toks, torch.int32),
            "labels": put(np.roll(toks, -1, 1), torch.int32),
            "mask": torch.ones((batch, seq), dtype=torch.float32,
                               device=dev),
        }
        if cfg.family == "vlm":
            b["img_embeds"] = torch.zeros(
                (batch, cfg.n_img_tokens, cfg.d_model), dtype=cfg.act_dtype,
                device=dev)
        if cfg.family == "encdec":
            b["frames"] = put(
                rng.normal(0, 1, (batch, cfg.n_audio_frames, cfg.d_model)),
                cfg.act_dtype)
        return b

    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the arch family")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu to run on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if cfg.family == "encdec":
        args.seq = min(args.seq, cfg.max_target_len)

    mesh = make_local_mesh(data=world_size(), device=dev)
    rules = sh.make_rules(cfg, mesh, global_batch=args.batch)

    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)
    opt_state = adamw_init(params, opt_cfg)

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              compress_grads=args.compress_grads)

    def mesh_step(params, opt_state, batch):
        with use_mesh_rules(mesh, rules):
            return step_fn(params, opt_state, batch)

    losses = []

    def on_metrics(step, m):
        losses.append(m["loss"])
        if step % 10 == 0:
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m.get('grad_norm', 0):.2f}  dt {m['dt']*1e3:.0f}ms",
                  flush=True)

    sup = TrainSupervisor(args.ckpt_dir, ckpt_every=args.ckpt_every)
    params, opt_state = sup.run(
        mesh_step, params, opt_state,
        synthetic_batch_fn(cfg, args.batch, args.seq, device=dev),
        args.steps, on_metrics=on_metrics,
    )
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
              f"last-{k} mean {np.mean(losses[-k:]):.4f}")
        if sup.monitor.flagged:
            print(f"straggler steps flagged: {sup.monitor.flagged[:5]}")
    return params


if __name__ == "__main__":
    main()
