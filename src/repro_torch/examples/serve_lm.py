"""Serve a small LM with batched greedy decoding (KV cache / SSM state).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        --arch zamba2-1.2b [--device cpu]

The port of the reference's ``examples/serve_lm.py``: decodes a token
batch with the family-appropriate cache (GQA KV cache for dense archs,
compressed-latent cache for MLA, O(1) recurrent state for mamba2,
ring-buffer sliding-window KV + SSM state for zamba2) through the port's
serve CLI at the smoke config, batch 4, cache 64, on the card (``--device
cuda``, the default) or the host.  ``main(argv)`` returns the CLI's
decoded ``seqs``.
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu to run on the host)")
    args = ap.parse_args(argv)
    return serve_mod.main([
        "--arch", args.arch, "--smoke", "--batch", "4",
        "--steps", str(args.steps), "--cache-len", "64",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
