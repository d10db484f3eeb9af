#!/usr/bin/env python3
"""Where the time of K5 (``src/repro_torch/csrc/tos_count.cu``) goes.

    python3 tools/tos_count_phases.py

Needs one NVIDIA GPU with ``nvcc``.  Builds the kernel as it is and
variants of it with one phase cut out, then times each on the same inputs
(1280x720 and 180x240, B=1, E=512, K1's kept events, as ``chip_smoke.py``
times K5), in turns over five rounds, beside one fp16 ``torch.bmm`` of the
one-hot bands.  A reading is the profiler's device time per launch (the
mean of 100 back-to-back launches); each line gives the median of the
rounds and every round, ``-`` where the profiler returned no device record
for the window.  Variants:

  kernel        the kernel as it is (checked against its plain version);
  late_events   the first pass's events loaded after the surface copies
                are issued, not before them;
  no_events     no event staging: an empty list, so no counts either;
  no_copies     no surface copies into shared memory;
  no_store      no store of the output tile;
  empty         every block returns at once: the launch floor.

Only ``kernel`` computes K5; the others say what a phase costs.  Prints the
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

EARLY = "  load_events(lxy, lval, E, tid * EPT, nx, ny, nv);\n"
STAGE = "  // (1) stage this tile's kept events in stream order.\n"


def variants(src: str) -> dict[str, str]:
    """The kernel source with one phase cut out, by name."""
    cuts = {
        "late_events": [(EARLY, ""), (STAGE, EARLY + STAGE)],
        "no_events": [("for (int e0 = 0, pass = 0; e0 < E;",
                       "for (int e0 = 0, pass = 0; e0 < 0;")],
        "no_copies": [('asm volatile("cp.async.cg',
                       'if (0) asm volatile("cp.async.cg')],
        "no_store": [("if (gy < H && gx < W)\n      *reinterpret_cast<uint4*>",
                      "if (gy < 0)\n      *reinterpret_cast<uint4*>")],
        "empty": [("  const int b = blockIdx.z;\n",
                   "  if (H > 0) return;\n  const int b = blockIdx.z;\n")],
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
    """Compile every variant in parallel; returns the K5 entry points."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"tos_count_{name}.cu"
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
        fn = ctypes.CDLL(str(out_dir / f"tos_count_{name}.so")) \
            .batched_fused_launch
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
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tos_count_phases: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import fused_step, ops, tos_update

    print(cs.nvidia_smi())
    src = (ROOT / "src/repro_torch/csrc/tos_count.cu").read_text()
    fns = build(variants(src), ROOT / "build" / "kernels" / "variants")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    kw = dict(patch=7, th=225, support=2, tw=5000, stcf_enabled=True)
    for h, w in ((720, 1280), (180, 240)):
        ins, ber, bits = cs.k1_inputs(rng, 1, h, w, 512, dev, inject=True)
        keep = fused_step.fused_step_cuda(*ins, ber, bits, **kw)[2]
        tos, xy = ins[0], ins[3]
        centre = ops.centre_surface((h, w), xy, keep, patch=7, th=225)
        out = torch.empty_like(tos)
        row_band, col_band = cs.one_hot_bands(xy, keep, h, w, 7, torch.half)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn):
            def call():
                err = fn(tos.data_ptr(), xy.data_ptr(), keep.data_ptr(),
                         centre.data_ptr(), out.data_ptr(), 1, h, w, 512, 7,
                         225, 512, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call

        launch(fns["kernel"])()
        want = tos_update.batched_fused_ref(tos, xy, keep, centre, patch=7,
                                            th=225)
        if not torch.equal(out, want):
            raise AssertionError("the kernel differs from its plain version")
        calls = {"bmm": lambda: torch.bmm(row_band, col_band)}
        calls.update({name: launch(fn) for name, fn in fns.items()})
        us = {name: [] for name in calls}
        for _ in range(5):
            for name, call in calls.items():
                us[name].append(cs.device_ms(call, iters=100, warmup=10)
                                * 1e3)
        print(f"[phases] {w}x{h} B=1 E=512 ({int(keep.sum())} kept), device "
              f"us per launch, median (five rounds): " + "; ".join(
                  f"{name} {median(ts):.3f} ("
                  + "/".join(f"{t:.3f}" if t > 0 else "-" for t in ts) + ")"
                  for name, ts in us.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
