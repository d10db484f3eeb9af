#!/usr/bin/env python3
"""Where the time of K1 (``src/repro_torch/csrc/fused_step.cu``) goes.

    python3 tools/fused_step_phases.py

Needs one NVIDIA GPU with ``nvcc``.  Builds K1 as it is and variants of it
with one phase of its tile pass (``fused_tile_kernel``) cut out, then
times each on the same inputs as ``chip_smoke.py`` times K1 (1280x720 B=1
and the DAVIS240 x16 pool's 180x240 B=16, E=512, with BER and without),
every call on a fresh copy of the same state, in turns over three rounds.
A reading is the profiler's device time per call of each of K1's two
kernels (the mean of 30 calls); each line gives the median of the rounds.
Variants:

  kernel       K1 as it is (checked against its plain version);
  no_sae       no SAE scatter;
  no_staging   no event staging: an empty list, so no counts either;
  no_counts    the list is built but not counted over the tile;
  no_surface   no surface load or store (and no BER);
  empty        every tile block returns at once: the launch floor.

Only ``kernel`` computes K1; the others say what a phase costs.  Prints the
card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CUTS = {
    "no_sae": [("      if (stcf_enabled && x[q] >= bx0",
                "      if (0 && stcf_enabled && x[q] >= bx0")],
    "no_staging": [("for (int e0 = 0, pass = 0; e0 < E;",
                    "for (int e0 = 0, pass = 0; e0 < 0;")],
    "no_counts": [("for (int n = tid; n < n_list; n += THREADS)",
                   "for (int n = tid; n < 0; n += THREADS)"),
                  ("for (int n = warp; n < n_list; n += WARPS)",
                   "for (int n = warp; n < 0; n += WARPS)")],
    "no_surface": [("  if (inject && mine) {", "  if (0) {"),
                   ("  if (!inject && mine) {", "  if (0) {"),
                   ("  if (!mine) return;\n", "  return;\n")],
    "empty": [("  if (mask != nullptr && !mask[b]) return;",
               "  if (H > 0) return;")],
}


def variants(src: str) -> dict[str, str]:
    """The kernel source with one phase cut out, by name."""
    out = {"kernel": src}
    for name, edits in CUTS.items():
        v = src
        for old, new in edits:
            if v.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            v = v.replace(old, new)
        out[name] = v
    return out


def build(sources: dict[str, str], out_dir: Path) -> dict:
    """Compile every variant in parallel; returns the K1 entry points."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"fused_step_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"fused_step_{name}.so")) \
            .fused_step_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_step_phases: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import fused_step

    print(cs.nvidia_smi())
    src = (ROOT / "src/repro_torch/csrc/fused_step.cu").read_text()
    fns = build(variants(src), ROOT / "build" / "kernels" / "variants")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    kw = dict(patch=7, th=225, support=2, tw=5000, stcf_enabled=True)
    for b, h, w in ((1, 720, 1280), (16, 180, 240)):
        ins, ber, bits = cs.k1_inputs(rng, b, h, w, 512, dev, inject=True)
        lut, xy, ts, valid = ins[2:]
        keep = torch.empty((b, 512), dtype=torch.bool, device=dev)
        scores = torch.empty((b, 512), dtype=torch.float32, device=dev)
        rec = torch.empty((b, 512, 2), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn, inject, calls=123):
            states = iter([(ins[0].clone(), ins[1].clone())
                           for _ in range(calls)])

            def call():
                tos, sae = next(states)
                err = fn(tos.data_ptr(), sae.data_ptr(), lut.data_ptr(),
                         xy.data_ptr(), ts.data_ptr(), valid.data_ptr(),
                         bits.data_ptr() if inject else None,
                         ber.data_ptr() if inject else None, None,
                         keep.data_ptr(), scores.data_ptr(),
                         rec.data_ptr(), b, h, w, 512,
                         7, 225, 2, 5000, 1, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return tos, sae
            return call

        got = launch(fns["kernel"], True, calls=1)()
        want = fused_step.fused_step_ref(*ins, ber, bits, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                              want[1])):
            raise AssertionError("the kernel differs from its plain version")
        for inject in (True, False):
            us = {name: {k: [] for k in cs.K1_KERNELS} for name in fns}
            for _ in range(3):
                for name, fn in fns.items():
                    per = cs.device_split(launch(fn, inject), cs.K1_KERNELS)[1]
                    for k, t in per.items():
                        us[name][k].append(t * 1e3)
            print(f"[phases] {w}x{h} B={b} E=512 BER "
                  f"{'on' if inject else 'off'} ({int(want[2].sum())} kept), "
                  f"device us per call, median of three (stcf_score / "
                  f"fused_tile): " + "; ".join(
                      f"{name} " + " / ".join(
                          f"{sorted(ts)[1]:.3f}" for ts in d.values())
                      for name, d in us.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
