"""Batched LM serving driver: prefill-free decode of a token batch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --steps 32 [--smoke] [--temperature 0.8] [--kv-quant]

The port of ``repro.launch.serve``, with its flags, defaults, seeds and
printed lines, on one card (``--device cuda``, the default; ``--device
cpu`` runs on the host): random weights from seed 0, start tokens from
``numpy.random.default_rng(0)``, then ``--steps`` serve steps, each with
its own split of the threefry key ``PRNGKey(1)`` (used when
``--temperature`` > 0).  As in the reference, the steps run under the
local mesh (``make_local_mesh(data=world size)``: 1x1 on one card) and
its sharding rules; the parameters stay plain tensors, so the rules place
nothing and the results equal those of a run without a mesh.
``main(argv)`` returns the decoded ``seqs`` (batch, steps + 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.state import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, world_size
from repro_torch.meshctx import use_mesh_rules
from repro_torch.models import transformer as T
from repro_torch.train.train_step import make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (attention families)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu to run on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    mesh = make_local_mesh(data=world_size(), device=dev)
    rules = sh.make_rules(cfg, mesh, global_batch=args.batch)

    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    cache = T.zeros_cache(cfg, args.batch, args.cache_len, dev)
    step = make_serve_step(cfg, greedy=args.temperature == 0.0,
                           temperature=max(args.temperature, 1e-6))

    toks = torch.from_numpy(
        np.random.default_rng(0).integers(1, cfg.vocab, (args.batch, 1))
    ).to(device=dev, dtype=torch.int32)
    key = prng.prng_key(1, device=dev)
    out = [toks[:, 0]]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with use_mesh_rules(mesh, rules):
        t0 = time.perf_counter()
        for pos in range(args.steps):
            key, sub = prng.split(key)
            toks, logits, cache = step(params, toks, cache, pos, sub)
            out.append(toks[:, 0])
        seqs = torch.stack(out, 1).cpu().numpy()   # waits for the last step
        dt = time.perf_counter() - t0

    print(f"decoded {args.steps} steps x batch {args.batch} in {dt:.2f}s "
          f"({args.steps * args.batch / dt:.1f} tok/s)")
    for b in range(min(args.batch, 4)):
        print(f"  seq[{b}]: {seqs[b, :16].tolist()}...")
    return seqs


if __name__ == "__main__":
    main()
