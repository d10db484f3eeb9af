#!/usr/bin/env python3
"""Where the time of K4 (``src/repro_torch/csrc/tos_update.cu``) goes.

    python3 tools/nmc_phases.py [--before OTHER/tos_update.cu]

Needs one NVIDIA GPU with ``nvcc``.  Builds the kernel as it is and
variants of it with one phase cut out, then times each on the same inputs
(1280x720 and 180x240 at B=1, and 180x240 at B=16, E=512, K1's kept
events, as ``chip_smoke.py`` times K4), in turns over five rounds.  A
reading is the profiler's device time per launch (the mean of 100
back-to-back launches); each line gives the median of the rounds and every
round, ``-`` where the profiler returned no device record for the window.
Variants:

  kernel        the kernel as it is (checked against its plain version);
  no_staging    no event staging: an empty list, so the tile is copied;
  no_counts     the list is staged, the closed form is not computed;
  empty         every block returns at once: the launch floor;
  tile64/tile32 the kernel with 64x64 (32x32) tiles at every shape;
  before        with ``--before``, another version of the same source
                (say, a parent commit's), checked like ``kernel``.

Only ``kernel``, ``tile64``, ``tile32`` and ``before`` compute K4 (each
is checked against the plain version); the others say what a phase
costs.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def variants(src: str) -> dict[str, str]:
    """The kernel source with one phase cut out, by name."""
    cuts = {
        "no_staging": [("for (int e0 = 0, pass = 0; e0 < E;",
                        "for (int e0 = 0, pass = 0; e0 < 0;")],
        "no_counts": [("if (n_list > 0) {   // uniform",
                       "if (n_list < 0) {   // uniform")],
        "empty": [("  const int b = blockIdx.z;\n",
                   "  if (H > 0) return;\n  const int b = blockIdx.z;\n")],
        "tile64": [("const bool small = E > 16 * tiles64;",
                    "const bool small = false;")],
        "tile32": [("const bool small = E > 16 * tiles64;",
                    "const bool small = true;")],
    }
    out = {"kernel": src}
    for name, edits in cuts.items():
        v = src
        for old, new in edits:
            if v.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            v = v.replace(old, new)
        out[name] = v
    return out


def build(sources: dict[str, str], out_dir: Path) -> dict:
    """Compile every variant in parallel; returns the K4 entry points."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"tos_update_{name}.cu"
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        fn = ctypes.CDLL(str(out_dir / f"tos_update_{name}.so")) \
            .nmc_stream_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def median(readings: list[float]) -> float:
    """The median of the readings the profiler recorded (non-zero)."""
    kept = sorted(t for t in readings if t > 0)
    if not kept:
        raise RuntimeError("the profiler recorded no device time")
    return kept[len(kept) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", type=Path, default=None,
                    help="another tos_update.cu to time beside this one")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("nmc_phases: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import fused_step, tos_update

    print(cs.nvidia_smi())
    sources = variants((ROOT / "src/repro_torch/csrc/tos_update.cu")
                       .read_text())
    if args.before is not None:
        sources["before"] = args.before.read_text()
    fns = build(sources, ROOT / "build" / "kernels" / "nmc_variants")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    kw = dict(patch=7, th=225, support=2, tw=5000, stcf_enabled=True)
    for b, h, w in ((1, 720, 1280), (1, 180, 240), (16, 180, 240)):
        ins, ber, bits = cs.k1_inputs(rng, b, h, w, 512, dev, inject=True)
        keep = fused_step.fused_step_cuda(*ins, ber, bits, **kw)[2]
        tos, xy = ins[0], ins[3]
        out = torch.empty_like(tos)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn):
            def call():
                err = fn(tos.data_ptr(), xy.data_ptr(), keep.data_ptr(),
                         None, out.data_ptr(), b, h, w, 512, 7, 225, 512,
                         stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call

        want = tos_update.nmc_stream_ref(tos, xy, keep, patch=7, th=225)
        for name in ("kernel", "tile64", "tile32", "before"):
            if name in fns:
                out.zero_()
                launch(fns[name])()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version at B={b} {h}x{w}")
        calls = {name: launch(fn) for name, fn in fns.items()}
        us = {name: [] for name in calls}
        for _ in range(5):
            for name, call in calls.items():
                us[name].append(cs.device_ms(call, iters=100, warmup=10)
                                * 1e3)
        bound, by = cs.tos_bound(b, h, w, 512, 7, keep, centre=False)
        print(f"[phases] {w}x{h} B={b} E=512 ({int(keep.sum())} kept; "
              f"bound {bound * 1e3:.3f} us by {by}), device us per launch, "
              f"median (five rounds): " + "; ".join(
                  f"{name} {median(ts):.3f} ("
                  + "/".join(f"{t:.3f}" if t > 0 else "-" for t in ts) + ")"
                  for name, ts in us.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
