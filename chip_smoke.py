#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) with ``nvcc`` (CUDA toolkit).
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of this repository.  Phases, each printing its own lines:

  1. environment: the card's name and power limit, and the ``nvcc`` build
     of the six kernel sources (``csrc/*.cu``, built in parallel for
     ``sm_90a``);
  1b. the LM scaffold's serving path (M11a; plain PyTorch, no kernel of
     the port lies on it), lines ``[lm]``: the precision switches (TF32
     must be off); the serve CLI (``repro_torch.launch.serve.main``) at
     ``qwen2-0.5b``'s published width (24 layers, d 896, vocab 151,936,
     bf16), batch 4, cache 128, 32 steps: greedy, ``--kv-quant`` and
     ``--temperature 0.8`` (tok/s, ms per step), two greedy runs equal, and
     a decode step's kernel and copy launches, device busy time and wall;
     a 64-token ``forward_prefill_cache`` handed to 8 greedy decode steps
     at that width, card against host on the same weights (the host fed
     the card's tokens) within ``LM_BF16`` of the largest logit, two card
     runs bit-equal; every other family at full width with its depth cut
     (``LM_DEPTH``; DeepSeek-V3 at its smoke config, since one layer of
     its experts is ~22 GB of bf16) in float32, 4 decode steps card
     against host within ``LM_F32``; and ``forward_prefill`` of 2,048
     tokens at qwen2-0.5b's width, 2 layers, through the blockwise
     attention, card against host;
  1c. the LM scaffold's training path (M11b; plain PyTorch autograd and
     AdamW, no kernel of the port), lines ``[train]``: the train CLI
     (``repro_torch.launch.train.main``) at qwen2-0.5b's width, batch 8,
     seq 256, 30 steps, checkpoints every 15 in a fresh directory (ms per
     step, median of steps 4-30, tokens/s, peak memory, first-3 and
     last-3 mean loss, the seconds of the async and the final saves), then
     a second call on that directory that must take no step and return
     bit-equal parameters; ``--microbatches 2 --compress-grads``, 4 steps,
     finite losses; remat ``none`` / ``dots`` / ``full``, one step each
     (ms, peak memory; the gradients bit-equal, else the differing leaves
     named and held to the host bound; ``full``'s peak below ``none``'s);
     30 steps on one fixed batch, whose loss must fall (the CLI's
     random-walk stream leaves it at ln(vocab) over 30 steps), with a
     profiled step (launches, device busy, unprofiled wall, idle share);
     one float32 step at full width, 2 layers, batch 2, seq 64, card
     against host within the CPU tests' bounds (``TRAIN_*``);
  1d. the LM examples (M11d), lines ``[lm_examples]``: ``serve_lm`` at its
     defaults (mamba2-370m smoke, batch 4, cache 64, 24 steps) and with
     ``--arch zamba2-1.2b`` (tok/s, ms per step), replayed on the CLI's
     tokens in bf16 on the card and the host and in float32 on the host
     within ``[lm]``'s bf16 bound; ``train_lm`` in full (lm-100m, 300
     steps, batch 4, seq 128, lr 1e-3, checkpoints at 100, 200 and 300:
     ms per step, tokens/s, peak memory, the CLI's first-30 -> last-30
     mean loss);
  1e. the mesh layer (M11c-1a), lines ``[mesh]``: the serve and train CLIs
     on their 1x1 mesh (NCCL) against the same CLIs with the mesh left
     inactive (seqs, losses and final parameters bit-equal); olmoe-1b-7b
     at full width, 2 layers, float32, ``moe_a2a=True`` on the mesh (its
     all-to-alls counted) against ``moe_apply`` without it: logits, aux
     and a train step's gradients;
  1f. the dry-run and roofline tools (M11c-2), lines ``[dryrun]``: ``python
     -m repro_torch.launch.dryrun`` on qwen2-0.5b ``train_4k`` and
     olmoe-1b-7b ``decode_32k`` at full size on the 16x16 single-pod mesh
     (a fake world of 256 in each of two processes, side by side): every
     record ok, its three roofline terms, dominant term and useful ratio
     printed; the per-device counter over one real qwen2-0.5b train step
     on the card (batch 8 x seq 256, remat ``dots``, the 1x1 mesh) and
     over the same step on fake tensors: dot FLOPs, HBM bytes, collective
     bytes and collectives equal, the terms beside the profiled device
     busy time and the counted bytes beside ``max_memory_allocated``; the
     runner's ``roofline(dryrun)`` rows over the records, with
     ``dryrun_cells_ok`` equal to the ok records;
  2. K1 (fused chunk step) in place (``fused_step_cuda_``), functional
     and under a lane mask against its plain PyTorch version on the card,
     on ``K1_CASES`` (180x240 and 1280x720 at 1 and 4 lanes; E of 1, 300
     and 8192; patches 1, 3 and 31; 8192 events in one 64x64 tile; ragged
     37x101 and 720x330; STCF off; 16 lanes with a mask), each with BER
     off, on, and 0 in every other lane: every output equal, masked lanes
     byte-identical, the functional call's inputs untouched;
  3. K2 (Harris response) against its plain version at Sobel 3/5/7 x
     window 1/3/5/7, at 37x101, 180x240 and 1280x720, 1 and 4 lanes, bit
     for bit, Sobel 1 refused; K3 (stream compaction) against its plain
     version over rows x events x cap x density: every output equal; K3's
     ring push (one launch: slot writes, records, cursors) against the
     plain push on ``PUSH_CASES`` (R 1-8, L 1-64, E 37/512/8192, dense
     and cap 1/E/8/E, aligned and offset rows, sequences that wrap the
     ring and pass a drain's reset): every leaf and cursor equal;
     K4-K7 (the TOS update on its own: NMC replay, closed form, and both
     binned per 128x128 tile) against their plain versions at both sizes,
     512 events, 1 and 4 lanes, the binned ones with ``cap = E`` and with
     a ``cap`` that truncates, then K4-K7 on the edge cases of their 64x64
     tiles (``TOS_EDGE_CASES``: E of 1, 300 and 8192, patches 1, 3 and
     31, 8192 events in one 128-tile, ragged sizes, 4 lanes, a background
     below ``th``; K6 and K7 with ``cap`` E, 1 and half the busiest tile's
     hits): every output equal;
  3d. the write-error draw (``csrc/ber_draw.cu``: every lane's key split
     and 5-bit masks in one launch) against its plain chain
     (``prng.split`` and ``ber.write_error_bits``) on ``BER_DRAW_CASES``
     (1280x720 x4, DAVIS240 x16, 1280x720 x1) at 0.6 V's rate, at 0.8
     V's (0) and the two mixed lane by lane, three chained draws each: new
     keys and masks equal;
  3e. the step's pick and books kernels (``csrc/step_lanes.cu``) against
     their plain chains (``step_lanes.dvfs_pick_ref`` / ``step_books_ref``)
     on ``STEP_LANES_CASES`` (1280x720's E=512 x4, DAVIS240 x16 at E=128,
     512 and 2048 with a partial lane mask and per-lane caps): every
     output equal over chained steps;
  4. end to end on the DAVIS240 sensor (180x240): ``run_pipeline`` with
     BER at a fixed 0.6 V and with online DVFS, on the card and on the CPU
     (plain versions), held to the parity bounds; PR-AUC printed;
  5. end to end at 1280x720 (an HD event sensor): events/s and ms per
     chunk; the launch counts of phases 4-5 must be nonzero for both
     kernels; then the TOS-update backends ``"nmc"`` (K4) and ``"batched"``
     (K5): DAVIS240 runs equal to the card's ``"fused"`` runs on every
     output and to the CPU within the bounds, an HD run of each (events/s,
     ms per chunk), and the HD stream folded through
     ``ops.tos_update_op(mode="nmc_binned" / "batched_binned")`` (K6, K7)
     equal to the lossless modes; K4-K7 must each be launched;
  6. the serving path: ``DetectorPool`` with 16 DAVIS240 lanes (online
     DVFS with BER; async dense, async compact, sync dense, all equal) and
     4 lanes at 1280x720 (fixed 1.2 V, compact), held against the same
     pool on the CPU on a prefix of the same feeds; events/s, ms per pump
     round (median and spread of three runs, all equal), D2H bytes per
     fetch, overflow slots, and the idle share of a window: 1 - the
     profiler's device busy time over the same window's unprofiled wall;
     the serving path must launch K1, K2 and K3, and push each pool
     round with exactly one K3 launch;
  6b. the adaptive pool (``policy="adaptive"``) at the DAVIS240 x16
     pool's width: buckets 128/512/2048, every lane connecting at 128, on
     ``synthetic.ramp_stream`` feeds that move half the lanes up to 2048
     and down to 512 and the other half down to 128 and up to 2048, one
     half-window per pump, lane 1 shedding with ``lut_every`` 3 and lane
     2 capped at operating point 0; async dense and compact, three runs
     each, all equal; events/s, ms per round, migrations, shed events and
     the host time of a poll that stages a move; every lane of the first
     half must migrate at least twice, K1-K3 must launch, one K3 push per
     round; a 14-half-window prefix equal to the same pool on the CPU
     (kept, migration logs, ``pool_stats()``; scores within the bound)
     and lane 0 equal to a ``StreamingDetector`` that ``rebucket()``s at
     its logged boundaries;
  6c. the ladder and pack pools at the same width and buckets, 6 lanes
     connecting at 128, 6 at 512 and 4 at 2048 (premium under the
     ladder): ``policy="ladder"`` (default ``LadderConfig``) on
     ``synthetic.burst_stream`` feeds (1,000 events per half-window, 3x
     over half-windows 10-25), one half-window per lane and
     ``pump_rounds(16)`` per step, then the reference's recovery recipe;
     sync dense and compact, three runs each, all equal, and one async
     run; the level must reach its top and return to 0, premium lanes stay
     at tier 0 with neutral knobs, packed lanes go home, one block shape
     per executor, one K3 push per round; ms per round, events/s, the
     level trajectory, transitions, shed events, pack moves, H2D padding
     per round, and K1/K2/K3 launches (and K2's lanes) per round at each
     level; then ``policy="pack"`` on flat 150-event feeds with less H2D
     padding than the same feeds never packed and a packed lane equal to
     its ``rebucket`` replay; the pack run and an 8-half-window prefix of
     the ladder run equal to the same pools on the CPU;
  6d. the serving CLI (``repro_torch.launch.serve_events.main``) at the
     DAVIS240 sensor with ``--dvfs``, 16 sessions over 200 ms on
     ``fused``: ``--policy static`` (async dense and compact), ``adaptive
     --buckets 64,256,1024 --connect-chunk 64``, ``ladder --burst-factor 2
     --qos standard,premium --slab 1024`` and ``pack --buckets
     64,256,1024``, then a static run on ``--backend nmc`` and one on
     ``batched`` at 4 sessions (K4, K5): kev/s, serving-round p50/p99,
     rounds per fetch, D2H MB, migrations, ladder transitions, pack moves
     and K1-K5 launches per run (one K3 push per pool round); then every
     run again at 4 sessions over 20 ms on the card and on the CPU, equal
     in the metrics records apart from wall clocks, the log lines, the
     lane report (bucket, qos, tier, migrations, log) and the executors;
     the quickstart on the card, its lines equal to the CPU run's (PR-AUC
     within 1e-3);
  6e. the fleet scenarios (``repro_torch.benchmarks.scenarios``):
     ``rows(smoke=True)`` equal to ``benchmarks/BENCH_smoke_baseline.json``
     in every row but the ``p99`` ones, then each scenario at full size,
     timed, its structural rows equal to the reference's full-size run
     (``benchmarks/BENCH_serving.json``);
  6f. the serving bench (``repro_torch.benchmarks.bench_streaming``):
     ``rows(smoke=True)`` with the baseline's row names and its 32
     structural rows equal to the baseline's, then the full-size rows
     (pools of 1, 4 and 16), printed, their structural rows equal to the
     reference's full-size run;
  6g. the loader path (``events.stream.PrefetchingLoader``): its chunks
     of the shapes stream moved past int32 microseconds equal to
     ``chunk_iterator``'s after the rebase, on the card, int32 / int32 /
     bool; a worker error raised after two uploaded chunks (the overflow
     guard) and one raised before any are re-raised on the consumer;
     ``close()`` on a half-consumed loader returns within 5 s with the
     worker dead; then the 80 ms shapes stream (online DVFS) fed through
     the loader and ``StreamingDetector.feed_device_chunk`` against the
     host ``feed`` path in chunk-sized slabs, two runs each in turns, both
     equal to the batch scan: events/s of each, recorded, no claim;
  6h. the end-to-end example (``repro_torch.examples.corner_detection_e2e
     .main``) at the reference's size (80 ms, both datasets): its lines,
     PR-AUC at 1.2 V and at 0.6 V with BER, and every flag ``True`` (the
     scan on ``fused`` bit-exact to the host-loop oracle on ``nmc``, the
     session, the device-slab feed, the compact and bucketed pools, the
     adaptive migration and the ladder's premium lane); then the oracle
     on ``batched`` against the scan, every output equal; K1-K5 must each
     be launched;
  6i. the paper benches (``bench_hwmodel``, ``bench_throughput``,
     ``bench_dvfs``, ``bench_auc``) at full size, held to the reference's
     full-size rows (``benchmarks/BENCH_serving.json``): the model rows
     within 1e-12 relative, the pipeline rows' host syncs 94 and 1, the
     Fig. 11 rows within 1e-3 (AUC) and 2e-3 (delta) of
     ``tests/data/fig11_reference.json`` (the reference's rows under the
     installed jax; the committed baselines' BER rows were drawn with the
     non-partitionable threefry) and the error-free ones of the baseline
     too; the one-hot TOS update bit-equal to ``tos_update_batched`` on
     the card at ``bench_throughput``'s 180x240, E=1024 inputs; wall-time
     rows printed;
  6j. the TOS-kernel cost model (``repro_torch.benchmarks.
     bench_tos_kernels``) at full size: its rows with the reference's
     names, the bin, unfused-byte and round-trip rows equal to
     ``benchmarks/BENCH_serving.json``, the device time of K4, K6, K5 and
     K1 (in place, no BER) on the reference's binned chunk beside each
     bound, the launch floor, K1's op calls per chunk of a fold (the gated
     ``fused_roundtrips_per_chunk``, 1) and its kernel launches per chunk
     from the profiler (2: ``stcf_score_kernel``, ``fused_tile_kernel``);
  6k. the regression gate: ``python -m repro_torch.benchmarks.run --smoke
     --check-regression benchmarks/BENCH_smoke_baseline.json`` in its own
     process must exit 0 with every gated baseline row checked;
  6l. the rest of the core (M10): evFAST and evARC on the card equal to
     the CPU and eHarris within the bound over the 80 ms shapes_dof stream,
     each one's PR-AUC and us/event beside NMC-TOS's from 6h;
     ``TosStream.update`` through K4-K7 equal to the plain closed form;
     ``stcf_sequential`` equal to ``stcf_chunked`` and to the CPU; the BER
     draws at 0.6-0.62 V and ``corner_lut`` as on the CPU;
  6m. the lane mesh (M11c-1b), lines ``[lanes]``: the DAVIS240 x16 pool
     (100 ms feeds, async compact, two runs of each layout in turns, then
     sync dense once) with ``shard=False``, with ``shard=True`` (a 1-wide
     lane mesh) and on a mesh that repeats the card twice, every layout's
     kept, scores and ``pool_stats()`` equal to the unsharded pool's
     (``sharded`` / ``devices`` apart); K1-K3 launches and host ms per
     pump round of each, one K3 push per round and shard; ``shard="auto"``
     over every card where there is more than one, else a line that says
     it is unchecked;
  7. per-kernel times beside the plain versions' times and a bound from
     bytes and operations (K3's ring push also by host time per push over
     back-to-back pushes ending in a synchronise): CUDA events over
     back-to-back calls (the JSON's ``ms`` and ``plain_ms``, as in the
     first slice) and the device time
     per call from the profiler (``device_ms``, ``plain_device_ms``, which
     leave out the device's wait for the host to enqueue); K1 in place on
     fresh copies of one state, per pass, at 1280x720 with and without BER
     and at the DAVIS240 x16 pool's shape; K2 at 1280x720 and DAVIS240 x16
     beside its byte bound and its operation floor at the exact rounding
     contract; K4-K7 at 1280x720 and DAVIS240, B=1, and K4/K6 also at
     the DAVIS240 x16 pool's shape, each beside its byte bound; for K5 and
     K7 also one ``torch.bmm`` of the fp16 one-hot bands, the counts part
     only, as the library yardstick, at 1280x720 and at DAVIS240; a
     profile of the HD step (K1 per pass, K2, device-to-device copies per
     chunk); the write-error draw at 1280x720 x1 and x4 and DAVIS240 x16
     (kernel by CUDA events and by the profiler, the plain chain's time
     and launches, the bound from ``bounds.ber_draw_bound``); the pick and
     books kernels on ``STEP_LANES_CASES`` (events, device and host per
     call beside the plain chains' and their launches, the bound from
     ``bounds.step_lanes_bound``), and the JSON summary line.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The H100's rates, the kernels' bounds and the device timers are the
# port's own (shared with the TOS-kernel cost model); numpy and the
# standard library only, until a function is called.
from repro_torch.benchmarks.bounds import (k1_bound, k2_bound,  # noqa: E402
                                           k3_bound, push_bound,
                                           step_lanes_bound, tos_bound)
from repro_torch.benchmarks.timing import (cuda_ms, device_ms,  # noqa: E402
                                           device_rows, device_split)

REL = 1e-5                   # LUT / score bound: |delta| <= REL * max|ref|


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# K1's two kernels, as the profiler names them.
K1_KERNELS = ("stcf_score_kernel", "fused_tile_kernel")


def k1_inputs(rng, b, h, w, e, dev, *, inject):
    """A busy mid-stream state and one clustered chunk per lane."""
    import numpy as np
    import torch
    from repro_torch.core import ber as ber_mod
    from repro_torch.core import prng
    from repro_torch.core.stcf import NEVER
    tos = np.zeros((b, h, w), np.uint8)
    hot = rng.random((b, h, w)) < 0.3
    tos[hot] = rng.integers(225, 256, hot.sum())
    sae = np.full((b, h, w), NEVER, np.int32)
    seen = rng.random((b, h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    lut = rng.standard_normal((b, h, w)).astype(np.float32)
    centres = rng.integers(0, (w, h), (b, 8, 2))
    pick = centres[np.arange(b)[:, None], rng.integers(0, 8, (b, e))]
    xy = np.clip(pick + rng.integers(-6, 7, (b, e, 2)), 0, (w - 1, h - 1))
    ts = np.sort(rng.integers(25_000, 40_000, (b, e)), axis=1)
    valid = np.arange(e)[None].repeat(b, 0) < e - 7
    t = [torch.from_numpy(a).to(dev) for a in
         (tos, sae, lut, xy.astype(np.int32), ts.astype(np.int32), valid)]
    ber = torch.full((b,), 0.025 if inject else 0.0, device=dev)
    keys = torch.stack([prng.prng_key(i, device=dev) for i in range(b)])
    bits = (ber_mod.write_error_bits(keys, (h, w), ber) if inject else None)
    return t, ber, bits


# (rounds, lanes, E) of the ring-push cases, each dense and with cap 1,
# E/8 and E, with aligned rows and with rows one element into their
# buffers: one slot, a ragged row (scalar copies), the pools' shapes, the
# longest chunk, a wide pool.
PUSH_CASES = ((1, 1, 37), (3, 4, 512), (8, 16, 512), (2, 3, 8192),
              (3, 64, 37))


def push_rows(rng, lanes, e, dev, step, offset=0):
    """One round's lane rows on ``dev`` (scores, keep, n_kept, vdd_idx,
    n_valid, mask): push 0 keeps nothing, push 1 everything, later ones a
    random share per lane; with ``offset`` each row tensor starts one
    element into its buffer, so no row is 16-byte aligned."""
    import numpy as np
    import torch
    density = {0: 0.0, 1: 1.0}.get(step, rng.random((lanes, 1)))
    keep = rng.random((lanes, e)) < density
    out = []
    for a in (rng.standard_normal((lanes, e)).astype(np.float32), keep,
              keep.sum(-1).astype(np.int32),
              rng.integers(0, 9, lanes).astype(np.int32),
              rng.integers(0, e + 1, lanes).astype(np.int32),
              rng.random(lanes) < 0.7):
        t = torch.from_numpy(a)
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        out.append(buf[offset:].view(t.shape).copy_(t))
    return out


def push_phase(rng, dev, cases=PUSH_CASES):
    """K3's ring push (``compact.ring_push_cuda``) against the plain push
    on the same rows, after every push of a sequence of 2R + 3 that wraps
    the ring and zeroes ``count`` / ``dropped`` (a drain's ``_reset_ring``)
    after push R: every leaf, records and cursors included, equal.
    Returns (max |delta| over the records' finite scores, checks)."""
    import torch
    from repro_torch.core import state
    from repro_torch.kernels import compact
    from repro_torch.serve.runtime import PoolRuntime
    err, n = 0.0, 0
    for rounds, lanes, e in cases:
        for cap in (None, 1, e // 8, e):
            for offset in (0, 1):
                if cap is None:
                    rings = [state.ring_init(rounds, lanes, e, device=dev)
                             for _ in range(2)]
                else:
                    rings = [state.compact_ring_init(rounds, lanes, e, cap,
                                                     device=dev)
                             for _ in range(2)]
                got, want = rings
                for step in range(2 * rounds + 3):
                    if step == rounds + 1:
                        for r in rings:
                            PoolRuntime._reset_ring(r)
                    rows = push_rows(rng, lanes, e, dev, step, offset)
                    compact.ring_push_cuda(got, *rows)
                    compact.ring_push_ref(want, *rows)
                    sync(dev)
                    for name in type(got)._fields:
                        if not torch.equal(getattr(got, name),
                                           getattr(want, name)):
                            raise AssertionError(
                                f"ring push {name} differs after push "
                                f"{step} at R={rounds} L={lanes} E={e} "
                                f"cap={cap} offset={offset}")
                    n += 1
                if int(got.dropped) == 0:
                    raise AssertionError("the push sequence dropped nothing")
                if cap is not None:
                    fin = torch.isfinite(want.c_val)
                    if fin.any():
                        err = max(err, float(
                            (got.c_val - want.c_val)[fin].abs().max()))
    print(f"[K3 push] {n} pushes (R x L x E in {list(cases)}, dense and "
          f"cap 1/E/8/E, aligned and offset rows, 2R+3 pushes with a "
          f"reset): every leaf and cursor equal to the plain push")
    return err, n


def host_ms(fn, n=2000, warmup=20) -> float:
    """Host time per call of ``fn`` (ms): ``perf_counter`` over ``n``
    back-to-back calls ending in a synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def push_timing(smi, dev, kept_frac, rounds=8, e=512, cap=64):
    """Host time per push and device time per launch of K3's ring push at
    the pools' widths (4 and 16 lanes of 512, cap 64, 8 slots), dense and
    compact, beside the plain push on the card and the split route (K3's
    standalone compaction, then the plain slot writes and cursor ops)."""
    import numpy as np
    import torch
    from repro_torch.core import state
    from repro_torch.kernels import compact
    out = {}
    for lanes in (4, 16):
        rows = push_rows(np.random.default_rng(lanes), lanes, e, dev, 2)
        rows[1].copy_(torch.rand(rows[1].shape, device=dev) < kept_frac)
        rows[2].copy_(rows[1].sum(-1))
        t = {}
        for mode, c in (("dense", 0), ("compact", cap)):
            ring = (state.compact_ring_init(rounds, lanes, e, c, device=dev)
                    if c else state.ring_init(rounds, lanes, e, device=dev))
            twin = (state.compact_ring_init(rounds, lanes, e, c, device=dev)
                    if c else state.ring_init(rounds, lanes, e, device=dev))
            push = (lambda r=ring: compact.ring_push_cuda(r, *rows))
            plain = (lambda r=twin: compact.ring_push_ref(r, *rows))
            bms, by = push_bound(lanes, e, c)
            t[mode] = dict(
                host_ms=host_ms(push), ms=cuda_ms(push, iters=200),
                device_ms=device_ms(push, iters=200),
                plain_host_ms=host_ms(plain, n=500),
                plain_ms=cuda_ms(plain, iters=100),
                plain_device_ms=device_ms(plain, iters=100),
                bound_ms=bms, bound_by=by)
            if c:
                t[mode]["split_host_ms"] = host_ms(
                    lambda r=twin: compact.ring_push_ref(
                        r, *rows, compact_fn=compact.compact_cuda), n=500)
            x = t[mode]
            split = (f"; split route (standalone K3 + plain writes) "
                     f"{x['split_host_ms']:.5f} ms host" if c else "")
            print(f"[time] {smi}: K3 ring push {mode} R={rounds} L={lanes} "
                  f"E={e}{f' cap={c}' if c else ''}: {x['host_ms']:.5f} ms "
                  f"host per push, {x['ms']:.5f} ms by CUDA events, "
                  f"{x['device_ms']:.5f} ms device per launch; plain "
                  f"{x['plain_host_ms']:.5f} ms host, "
                  f"{x['plain_device_ms']:.5f} ms device{split}; bound "
                  f"{x['bound_ms']:.7f} ms by {x['bound_by']}")
        out[f"L{lanes}"] = t
    return out


def sync(dev) -> None:
    """Wait for ``dev`` (a no-op on the CPU)."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def tos_kernel_phase(rng, dev, sizes=((180, 240), (720, 1280)),
                     lanes=(1, 4)):
    """Phase 3c: K4-K7 against their plain versions; returns max |delta|.
    Smaller arguments (and the plain versions standing in for the kernels)
    rehearse it on the CPU."""
    import torch
    from repro_torch.kernels import ops, tos_update
    kw = dict(patch=7, th=225)
    err, n = 0, 0
    for h, w in sizes:
        for b in lanes:
            t = k1_inputs(rng, b, h, w, 512, dev, inject=False)[0]
            tos, xy, valid = t[0], t[3], t[5]
            centre = ops.centre_surface((h, w), xy, valid, **kw)
            bins, _ = tos_update.bin_events_to_tiles(
                xy, valid, grid_hw=tos_update._grid(h, w), patch=7, cap=512)
            hits = bins[..., 2].sum(-1)
            trunc = int(hits.max()) // 2
            cases = [(m, 0) for m in ops.TOS_MODES] + [
                ("nmc_binned", trunc), ("batched_binned", trunc)]
            for mode, cap in cases:
                name = ops.TOS_MODES[mode]
                extra = (centre,) if mode.startswith("batched") else ()
                ckw = dict(kw, cap=cap) if mode.endswith("binned") else kw
                plain = getattr(tos_update, f"{name}_ref")(
                    tos, xy, valid, *extra, **ckw)
                got = getattr(tos_update, f"{name}_cuda")(
                    tos, xy, valid, *extra, **ckw)
                sync(dev)
                if not torch.equal(plain, got):
                    raise AssertionError(f"{name} differs at {h}x{w} B={b} "
                                         f"cap={cap}")
                err = max(err, int((plain.int() - got.int()).abs().max()))
                n += 1
            print(f"[K4-K7] {h}x{w} B={b}: nmc, batched, nmc_binned, "
                  f"batched_binned equal to plain (cap E, and cap {trunc} "
                  f"dropping hits in {int((hits > trunc).sum())} of "
                  f"{hits.numel()} lane-tiles)")
    print(f"[K4-K7] {n} cases equal")
    return float(err)


def one_hot_bands(xy, valid, h, w, patch, dtype):
    """The closed form's operands over the whole surface: ``row_band (B, H,
    E)`` and ``col_band (B, E, W)``, 1 where a valid event's patch covers
    the row / column; ``row_band @ col_band`` is the cover count."""
    import torch
    r = (patch - 1) // 2
    rows = torch.arange(h, device=xy.device)
    cols = torch.arange(w, device=xy.device)
    row_band = (((rows[None, :, None] - xy[..., 1][:, None, :]).abs() <= r)
                & valid[:, None, :]).to(dtype)
    col_band = (((cols[None, None, :] - xy[..., 0][:, :, None]).abs() <= r)
                & valid[:, :, None]).to(dtype)
    return row_band, col_band


# K5/K7 edge cases for the 64x64 tiles of csrc/tos_count.cu: (what, B, H,
# W, E, patch, event layout, background below th).
TOS_EDGE_CASES = (
    ("one event", 1, 720, 1280, 1, 7, "spread", False),
    ("E=300", 1, 720, 1280, 300, 7, "clusters", False),
    ("E=8192", 1, 720, 1280, 8192, 7, "clusters", False),
    ("patch 1", 1, 180, 240, 512, 1, "clusters", False),
    ("patch 3", 1, 180, 240, 512, 3, "clusters", False),
    ("patch 31", 1, 180, 240, 512, 31, "clusters", False),
    ("8192 events in one 128-tile", 1, 720, 1280, 8192, 7, "one_tile",
     False),
    ("ragged 37x101", 2, 37, 101, 300, 7, "spread", False),
    ("720 rows, W=330", 1, 720, 330, 512, 9, "clusters", False),
    ("B=4", 4, 720, 1280, 300, 5, "clusters", False),
    ("background below th", 2, 180, 240, 512, 7, "clusters", True),
)


def tos_edge_inputs(rng, b, h, w, e, layout, below_th, dev, th=225):
    """A surface and a chunk per lane.  ``layout``: ``spread`` (uniform),
    ``clusters`` (eight centres, +-6 px) or ``one_tile`` (every event in a
    12 x 12 square on 64-tile borders inside the 128-tile at x 128..255,
    y 0..127, so counts reach the thousands).  ``below_th``: a uniform
    0..255 background instead of {0} U [th, 255]."""
    import numpy as np
    import torch
    tos = rng.integers(0, 256, (b, h, w))
    if not below_th:
        tos = np.where(rng.random((b, h, w)) < 0.3,
                       rng.integers(th, 256, (b, h, w)), 0)
    if layout == "spread":
        xy = np.stack([rng.integers(0, w, (b, e)),
                       rng.integers(0, h, (b, e))], -1)
    elif layout == "clusters":
        centres = rng.integers(0, (w, h), (b, 8, 2))
        pick = centres[np.arange(b)[:, None], rng.integers(0, 8, (b, e))]
        xy = np.clip(pick + rng.integers(-6, 7, (b, e, 2)), 0,
                     (w - 1, h - 1))
    else:
        xy = np.array([186, 58]) + rng.integers(0, 12, (b, e, 2))
    valid = rng.random((b, e)) < 0.9
    valid[:, 0] = True
    return [torch.from_numpy(a).to(dev) for a in
            (tos.astype(np.uint8), xy.astype(np.int32), valid)]


def tos_edge_phase(rng, dev, cases=TOS_EDGE_CASES):
    """Phase 3c, second part: K5 and K7, K4 and K6 (the binned ones with
    cap E, 1 and half the busiest 128-tile's hits) against their plain
    versions on ``cases``; returns (K5/K7 max |delta|, K4/K6 max |delta|,
    cases checked).  Small cases with the plain versions standing in for
    the kernels rehearse it on the CPU."""
    import torch
    from repro_torch.kernels import ops, tos_update
    err = {"batched": 0, "nmc": 0}
    n = 0
    for what, b, h, w, e, patch, layout, below in cases:
        tos, xy, valid = tos_edge_inputs(rng, b, h, w, e, layout, below, dev)
        kw = dict(patch=patch, th=225)
        centre = ops.centre_surface((h, w), xy, valid, **kw)
        bins, _ = tos_update.bin_events_to_tiles(
            xy, valid, grid_hw=tos_update._grid(h, w), patch=patch, cap=e)
        busiest = int(bins[..., 2].sum(-1).max())
        caps = ({}, {}, dict(cap=1), dict(cap=max(1, busiest // 2)))
        for kind, name, extra in (("batched", "batched_fused", (centre,)),
                                  ("nmc", "nmc_stream", ())):
            for binned, ckw in zip((False, True, True, True), caps):
                fn = f"{name}_binned" if binned else name
                plain = getattr(tos_update, f"{fn}_ref")(
                    tos, xy, valid, *extra, **kw, **ckw)
                got = getattr(tos_update, f"{fn}_cuda")(
                    tos, xy, valid, *extra, **kw, **ckw)
                sync(dev)
                if not torch.equal(plain, got):
                    raise AssertionError(f"{fn} {ckw} differs: {what}")
                err[kind] = max(err[kind],
                                int((plain.int() - got.int()).abs().max()))
                n += 1
        row_band, col_band = one_hot_bands(xy, valid, h, w, patch,
                                           torch.float32)
        top = int(torch.bmm(row_band, col_band).max())
        print(f"[K4-K7] {what}: B={b} {h}x{w} E={e} patch {patch}: batched, "
              f"nmc and both binned (cap E, 1, {max(1, busiest // 2)}) "
              f"equal to plain; busiest 128-tile {busiest} hits, largest "
              f"cover count {top}")
    print(f"[K4-K7] {n} edge cases equal")
    return float(err["batched"]), float(err["nmc"]), n


# K1 cases for csrc/fused_step.cu's two passes: (what, B, H, W, E, patch,
# event layout, stcf_enabled, lane mask).  Each runs with BER off, on in
# every lane, and on with ber = 0 in every other lane.  The first four are
# the first slice's cases.
K1_CASES = (
    ("DAVIS240", 1, 180, 240, 512, 7, "clusters", True, False),
    ("DAVIS240 x4", 4, 180, 240, 512, 7, "clusters", True, False),
    ("HD", 1, 720, 1280, 512, 7, "clusters", True, False),
    ("HD x4", 4, 720, 1280, 512, 7, "clusters", True, False),
    ("one event", 1, 720, 1280, 1, 7, "spread", True, False),
    ("E=300", 1, 720, 1280, 300, 7, "clusters", True, False),
    ("E=8192", 1, 720, 1280, 8192, 7, "clusters", True, False),
    ("patch 1", 1, 180, 240, 512, 1, "clusters", True, False),
    ("patch 3", 1, 180, 240, 512, 3, "clusters", True, False),
    ("patch 31", 1, 180, 240, 512, 31, "clusters", True, False),
    ("8192 events in one 64x64 tile", 1, 720, 1280, 8192, 7, "one_tile",
     True, False),
    ("ragged 37x101", 2, 37, 101, 300, 7, "spread", True, False),
    ("720 rows, W=330", 1, 720, 330, 512, 9, "clusters", True, False),
    ("stcf_enabled=False", 2, 180, 240, 512, 7, "clusters", False, False),
    ("B=16 with a lane mask", 16, 180, 240, 512, 7, "clusters", True, True),
)


def k1_case_inputs(rng, b, h, w, e, layout, dev):
    """A busy mid-stream state and one chunk per lane (``layout`` as in
    ``tos_edge_inputs``; ``one_tile`` puts every event in a 12 x 12 square
    inside the 64x64 tile at x 64..127, y 0..63)."""
    import numpy as np
    import torch
    from repro_torch.core.stcf import NEVER
    tos = np.where(rng.random((b, h, w)) < 0.3,
                   rng.integers(225, 256, (b, h, w)), 0)
    sae = np.full((b, h, w), NEVER, np.int32)
    seen = rng.random((b, h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    lut = rng.standard_normal((b, h, w)).astype(np.float32)
    if layout == "spread":
        xy = np.stack([rng.integers(0, w, (b, e)),
                       rng.integers(0, h, (b, e))], -1)
    elif layout == "clusters":
        centres = rng.integers(0, (w, h), (b, 8, 2))
        pick = centres[np.arange(b)[:, None], rng.integers(0, 8, (b, e))]
        xy = np.clip(pick + rng.integers(-6, 7, (b, e, 2)), 0,
                     (w - 1, h - 1))
    else:
        xy = np.array([90, 26]) + rng.integers(0, 12, (b, e, 2))
    ts = np.sort(rng.integers(25_000, 40_000, (b, e)), axis=1)
    valid = rng.random((b, e)) < 0.9
    valid[:, 0] = True
    return [torch.from_numpy(a).to(dev) for a in
            (tos.astype(np.uint8), sae, lut, xy.astype(np.int32),
             ts.astype(np.int32), valid)]


def k1_phase(rng, dev, cases=K1_CASES):
    """Phase 2: K1 in place (``fused_step_cuda_``), functional
    (``fused_step_cuda``) and, where the case has one, under a lane mask,
    against ``fused_step_ref`` bit for bit; masked lanes must come out
    byte-identical and the functional call must leave its inputs alone.
    Returns (max |delta|, checks).  Small cases with the plain versions
    standing in for the kernels rehearse it on the CPU."""
    import torch
    from repro_torch.core import ber as ber_mod
    from repro_torch.core import prng
    from repro_torch.kernels import fused_step
    err, n = 0.0, 0
    for what, b, h, w, e, patch, layout, stcf, masked in cases:
        ins = k1_case_inputs(rng, b, h, w, e, layout, dev)
        kw = dict(patch=patch, th=225, support=2, tw=5000,
                  stcf_enabled=stcf)
        keys = torch.stack([prng.prng_key(i, device=dev) for i in range(b)])
        mask = (torch.arange(b, device=dev) % 4 != 1) if masked else None
        for ber_mode in ("off", "on", "some 0"):
            rate = [0.025 if ber_mode == "on" or i % 2 == 0 else 0.0
                    for i in range(b)]
            ber = torch.tensor(rate, dtype=torch.float32, device=dev)
            bits = (None if ber_mode == "off" else
                    ber_mod.write_error_bits(keys, (h, w), ber))
            plain = fused_step.fused_step_ref(*ins, ber, bits, mask=mask,
                                              **kw)
            before = [t.clone() for t in ins[:2]]
            got = fused_step.fused_step_cuda(*ins, ber, bits, mask=mask,
                                             **kw)
            tos_, sae_ = ins[0].clone(), ins[1].clone()
            got_ = fused_step.fused_step_cuda_(tos_, sae_, *ins[2:], ber,
                                               bits, mask=mask, **kw)
            sync(dev)
            if got_[0] is not tos_ or got_[1] is not sae_:
                raise AssertionError(f"K1 in place returned new tensors: "
                                     f"{what}")
            for t, t0 in zip(ins[:2], before):
                if not torch.equal(t, t0):
                    raise AssertionError(f"K1 functional changed its "
                                         f"inputs: {what}")
            for spelling, out in (("functional", got), ("in place", got_)):
                for name, p, g in zip(("tos", "sae", "keep", "scores"),
                                      plain, out):
                    if not torch.equal(p, g):
                        raise AssertionError(
                            f"K1 {spelling} {name} differs: {what}, BER "
                            f"{ber_mode}")
                    fin = torch.isfinite(p.double())
                    if fin.any():
                        err = max(err, float(
                            (p.double() - g.double())[fin].abs().max()))
                if masked:
                    off = ~mask
                    for name, g, t0 in zip(("tos", "sae"), out, before):
                        if not torch.equal(g[off], t0[off]):
                            raise AssertionError(
                                f"K1 {spelling} changed a masked lane's "
                                f"{name}: {what}, BER {ber_mode}")
                n += 1
        print(f"[K1] {what}: B={b} {h}x{w} E={e} patch {patch} stcf "
              f"{'on' if stcf else 'off'}{', masked' if masked else ''}: "
              f"in place and functional equal to plain with BER off, on, "
              f"and 0 in every other lane (kept {int(plain[2].sum())}/"
              f"{b * e})")
    print(f"[K1] {n} checks equal, max |delta| {err}")
    return err, n


def k2_phase(rng, dev, sizes=((37, 101), (180, 240), (720, 1280)),
             lanes=(1, 4), sobels=(3, 5, 7), windows=(1, 3, 5, 7)):
    """Phase 3: K2 against ``harris_ref`` at every (Sobel, window) pair,
    bit for bit (the float32 words compared as int32); Sobel 1, which has
    no odd operator, must be refused.  Returns (max |delta|, checks).
    Small sizes with the plain version standing in rehearse it on the
    CPU."""
    import torch
    from repro_torch.kernels import harris_conv
    err, n = 0.0, 0
    for h, w in sizes:
        for b in lanes:
            tos = k1_case_inputs(rng, b, h, w, 1, "spread", dev)[0]
            for ks in sobels:
                for ws in windows:
                    kw = dict(sobel_size=ks, window_size=ws)
                    plain = harris_conv.harris_ref(tos, **kw)
                    got = harris_conv.harris_cuda(tos, **kw)
                    sync(dev)
                    if not torch.equal(got.view(torch.int32),
                                       plain.view(torch.int32)):
                        d = float((got - plain).abs().max())
                        raise AssertionError(
                            f"K2 {h}x{w} B={b} sobel {ks} window {ws}: "
                            f"not bit-equal, max |delta| {d:.3g}")
                    err = max(err, float((got - plain).abs().max()))
                    n += 1
            print(f"[K2] {h}x{w} B={b}: bit-equal to plain at Sobel "
                  f"{'/'.join(map(str, sobels))} x window "
                  f"{'/'.join(map(str, windows))}")
    try:
        harris_conv.harris_cuda(tos, sobel_size=1)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 took Sobel size 1")
    print(f"[K2] {n} checks bit-equal, max |delta| {err}; Sobel 1 refused")
    return err, n


# The write-error draw's cases: (what, lanes, H, W); the serving cells'
# four HD cameras and chip_smoke's DAVIS240 x16 pool, and one HD lane.
BER_DRAW_CASES = (("HD x4", 4, 720, 1280), ("DAVIS240 x16", 16, 180, 240),
                  ("HD B=1", 1, 720, 1280))


def ber_draw_rates(b):
    """The draw's rate sets for ``b`` lanes: all at 0.6 V's BER, all at
    0.8 V's (0), and the two mixed lane by lane."""
    from repro_torch.core import hwmodel
    lo, hi = hwmodel.ber_at(0.6), hwmodel.ber_at(0.8)
    return {"0.6 V": [lo] * b, "0.8 V": [hi] * b,
            "0.6/0.8 V mixed": [(lo, hi)[i % 2] for i in range(b)]}


def ber_draw_phase(dev, cases=BER_DRAW_CASES, draws=3):
    """Phase 3d: the write-error draw kernel (``ber_draw.ber_draw_cuda``)
    against its plain chain (``ber_draw_ref``: ``prng.split`` and
    ``ber.write_error_bits``) at every rate set of ``ber_draw_rates``, over
    ``draws`` draws whose keys chain: new keys and masks equal.  Returns
    the checks.  Small cases, with ``ber_draw_cuda`` pointed at
    ``ber_draw_ref``, rehearse it on the CPU."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import ber_draw
    n = 0
    for what, b, h, w in cases:
        for name, rate in ber_draw_rates(b).items():
            ber = torch.tensor(rate, dtype=torch.float32, device=dev)
            key = want = torch.stack([prng.prng_key(1000 + i, device=dev)
                                      for i in range(b)])
            flips = 0
            for _ in range(draws):
                key, bits = ber_draw.ber_draw_cuda(key, (h, w), ber)
                want, want_bits = ber_draw.ber_draw_ref(want, (h, w), ber)
                sync(dev)
                if not torch.equal(key, want):
                    raise AssertionError(f"draw new keys differ: {what}, "
                                         f"{name}")
                if not torch.equal(bits, want_bits):
                    d = int((bits != want_bits).sum())
                    raise AssertionError(f"draw masks differ at {d} "
                                         f"pixels: {what}, {name}")
                flips += sum(int(((bits >> i) & 1).sum()) for i in range(5))
                n += 1
            print(f"[ber_draw] {what} {h}x{w}, {name}: {draws} chained "
                  f"draws, new keys and masks equal to the plain chain "
                  f"({flips} bits set)")
    print(f"[ber_draw] {n} draws equal, max |delta| 0")
    return n


def ber_draw_timing(smi, dev, cases=BER_DRAW_CASES):
    """The draw kernel's time per call at each case's shape (0.6 V's rate
    in every lane), by CUDA events over back-to-back calls and from the
    profiler, beside the plain chain's (and its launches per call) and the
    bound; one ``[time]`` line a case.  Returns ``{what: times}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks.bounds import ber_draw_bound
    from repro_torch.core import hwmodel, prng
    from repro_torch.kernels import ber_draw
    out = {}
    for what, b, h, w in cases:
        key = torch.stack([prng.prng_key(i, device=dev) for i in range(b)])
        ber = torch.full((b,), hwmodel.ber_at(0.6), dtype=torch.float32,
                         device=dev)

        def kern():
            return ber_draw.ber_draw_cuda(key, (h, w), ber)

        def plain():
            return ber_draw.ber_draw_ref(key, (h, w), ber)

        t = dict(ms=cuda_ms(kern),
                 device_ms=device_split(kern, ("ber_draw_kernel",))[1][
                     "ber_draw_kernel"],
                 plain_ms=cuda_ms(plain, iters=5, warmup=1),
                 plain_device_ms=device_ms(plain, iters=5, warmup=1))
        plain()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plain()
            torch.cuda.synchronize()
        t["plain_launches"] = sum(r.count for r in device_rows(prof))
        (t["bound_ms"], t["bound_by"], t["bound_bytes_ms"],
         t["bound_operations_ms"]) = ber_draw_bound(b, h, w)
        dev_ms = ("not measured" if t["device_ms"] is None
                  else f"{t['device_ms']:.5f} ms")
        print(f"[time] {smi}: write-error draw {what} {w}x{h}x5: kernel "
              f"{t['ms']:.5f} ms by CUDA events, {dev_ms} device "
              f"(profiler); plain chain {t['plain_ms']:.4f} ms events, "
              f"{t['plain_device_ms']:.4f} ms device, "
              f"{t['plain_launches']} launches; bound {t['bound_ms']:.5f} "
              f"ms by {t['bound_by']} (operations "
              f"{t['bound_operations_ms']:.5f} ms, bytes "
              f"{t['bound_bytes_ms']:.5f} ms)")
        out[what] = t
    return out


# The step's pick and books cases: (what, lanes, E, masked); the sat cell's
# four HD lanes at chunk 512 and the burst cell's 16 DAVIS240 lanes at its
# three buckets, about a fifth of them active.
STEP_LANES_CASES = (("HD x4", 4, 512, False),
                    ("DAVIS240 x16 E=128", 16, 128, True),
                    ("DAVIS240 x16 E=512", 16, 512, True),
                    ("DAVIS240 x16 E=2048", 16, 2048, True))


def step_lanes_inputs(rng, b, e, masked, dev, half=5000):
    """A step's pick and books inputs at ``b`` lanes of ``e`` events:
    sorted chunk times over one to three half-windows (some lanes before
    the stream's origin), valid and keep masks, estimator rows that picks
    spread over the table, the books (kept total, energy, latency);
    per-lane caps and a mask with about a fifth of the lanes active when
    ``masked``."""
    import numpy as np
    import torch
    from repro_torch.core import dvfs
    w0 = rng.integers(-2, 60, b)
    lo = w0 * half + rng.integers(0, half, b)
    hi = lo + rng.integers(0, 3 * half, b)
    ts = np.sort(lo[:, None] + (rng.random((b, e)) * (hi - lo + 1)[:, None])
                 .astype(np.int64), axis=1)
    valid = rng.random((b, e)) < 0.9
    keep = valid & (rng.random((b, e)) < 0.5)
    cnt = (2 ** rng.uniform(12, 19.5, (3, b))).astype(np.int32)
    rate = np.concatenate([w0[None] - rng.integers(0, 4, b)[None], cnt])
    books = (rng.integers(0, 2**20, b), rng.random(b) * 1e6,
             rng.random(b) * 1e7)
    mask = rng.random(b) < 0.2 if masked else None
    if mask is not None:
        mask[0] = True
    cap = rng.integers(0, 7, b) if masked else None

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return dict(
        rate=dvfs.RateState(*(t(r, torch.int32) for r in rate)),
        ts=t(ts, torch.int32), valid=t(valid, torch.bool),
        keep=t(keep, torch.bool),
        books=(t(books[0], torch.int32),
               *(t(x, torch.float32) for x in books[1:])),
        mask=None if mask is None else t(mask, torch.bool),
        cap=None if cap is None else t(cap, torch.int32))


def step_lanes_phase(dev, cases=STEP_LANES_CASES, steps=3, cuda=True):
    """Phase 3e: the pick and books kernels (``step_lanes.dvfs_pick_cuda``,
    ``step_books_cuda``) against their plain chains on ``cases``, over
    ``steps`` chained steps (each pick's estimator feeds the next, each
    books call's books the next): every output equal.  Returns the checks.
    ``cuda=False`` runs the plain chains on both sides, which rehearses the
    phase on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import dvfs
    from repro_torch.kernels import step_lanes
    cfg = dvfs.DvfsConfig()
    pick = step_lanes.dvfs_pick_cuda if cuda else step_lanes.dvfs_pick_ref
    books = step_lanes.step_books_cuda if cuda else step_lanes.step_books_ref
    rng = np.random.default_rng(35)
    n = 0
    for what, b, e, masked in cases:
        x = step_lanes_inputs(rng, b, e, masked, dev)
        rate = want_rate = x["rate"]
        bk = want_bk = x["books"]
        for step in range(steps):
            ts = x["ts"] + step * 2000
            got = pick(rate, ts, x["valid"], cfg=cfg, cap=x["cap"],
                       mask=x["mask"])
            want = step_lanes.dvfs_pick_ref(want_rate, ts, x["valid"],
                                            cfg=cfg, cap=x["cap"],
                                            mask=x["mask"])
            coefs = got[3:]
            got_b = books(x["keep"], *bk, *coefs, x["mask"])
            want_b = step_lanes.step_books_ref(x["keep"], *want_bk,
                                               *want[3:], x["mask"])
            sync(dev)
            for name, g, w in zip(
                    ("win", "cur", "prev1", "prev2", "vdd_idx", "ber",
                     "energy_coef", "latency_coef", "n_kept", "kept_total",
                     "energy_pj", "latency_ns"),
                    (*got[0], *got[1:], *got_b), (*want[0], *want[1:],
                                                  *want_b)):
                if not torch.equal(g, w):
                    d = int((g != w).sum())
                    raise AssertionError(f"step lanes {name} differs in {d} "
                                         f"lanes: {what}, step {step}")
            rate, want_rate = got[0], want[0]
            bk, want_bk = got_b[1:], want_b[1:]
            n += 1
        picks = sorted(set(got[1].tolist()))
        print(f"[step_lanes] {what} (E={e}, mask "
              f"{'partial' if masked else 'none'}): {steps} chained steps, "
              f"pick and books equal to the plain chains (points {picks})")
    print(f"[step_lanes] {n} steps equal, max |delta| 0")
    return n


def step_lanes_timing(smi, dev, cases=STEP_LANES_CASES):
    """The pick and books kernels per call at each case's shape through
    ``ops`` (the step's route): CUDA events, the profiler's device time and
    the host's time, beside the plain chains' (and their launches) and the
    bound; one ``[time]`` line a case and kernel.  Returns ``{what:
    {"pick": times, "books": times}}``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dvfs
    from repro_torch.kernels import ops, step_lanes
    cfg = dvfs.DvfsConfig()
    rng = np.random.default_rng(36)
    out = {}
    for what, b, e, masked in cases:
        x = step_lanes_inputs(rng, b, e, masked, dev)
        coefs = step_lanes.dvfs_pick_ref(x["rate"], x["ts"], x["valid"],
                                         cfg=cfg)[3:]
        fns = {
            "pick": (lambda: ops.dvfs_pick_op(
                x["rate"], x["ts"], x["valid"], cfg=cfg, cap=x["cap"],
                mask=x["mask"]), lambda: step_lanes.dvfs_pick_ref(
                x["rate"], x["ts"], x["valid"], cfg=cfg, cap=x["cap"],
                mask=x["mask"]), "dvfs_pick_kernel"),
            "books": (lambda: ops.step_books_op(
                x["keep"], *x["books"], *coefs, x["mask"]),
                lambda: step_lanes.step_books_ref(
                x["keep"], *x["books"], *coefs, x["mask"]),
                "step_books_kernel"),
        }
        out[what] = {}
        for kernel, (kern, plain, name) in fns.items():
            t = dict(ms=cuda_ms(kern, iters=200),
                     device_ms=device_split(kern, (name,))[1][name],
                     host_ms=host_ms(kern),
                     plain_ms=cuda_ms(plain, iters=100),
                     plain_device_ms=device_ms(plain),
                     plain_host_ms=host_ms(plain, n=500))
            plain()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                plain()
                torch.cuda.synchronize()
            t["plain_launches"] = sum(r.count for r in device_rows(prof))
            t["bound_ms"], t["bound_by"] = step_lanes_bound(b, e, kernel)
            dev_ms = ("not measured" if t["device_ms"] is None
                      else f"{t['device_ms'] * 1e3:.3f} us")
            print(f"[time] {smi}: step {kernel} {what} (B={b}, E={e}, mask "
                  f"{'partial' if masked else 'none'}): kernel "
                  f"{t['ms'] * 1e3:.3f} us by CUDA events, {dev_ms} device "
                  f"(profiler), {t['host_ms'] * 1e3:.2f} us host a call; "
                  f"plain chain {t['plain_ms'] * 1e3:.2f} us events, "
                  f"{t['plain_device_ms'] * 1e3:.2f} us device, "
                  f"{t['plain_host_ms'] * 1e3:.2f} us host, "
                  f"{t['plain_launches']} launches; bound "
                  f"{t['bound_ms'] * 1e6:.2f} ns by {t['bound_by']}")
            out[what][kernel] = t
    return out


def tos_backend_phase(smi, davis, hd, davis_cfgs, gpu_runs, cpu_runs,
                      hd_cfg, *, device="cuda", fold_chunks=128):
    """Phase 5b: the TOS-update backends on ``device``.  Returns the launch
    counts of these runs.  Shorter streams rehearse it on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import ops

    dev = torch.device(device)
    hd_cfg = dataclasses.replace(hd_cfg, device=device)
    pipeline.run_pipeline(hd.xy[:4096], hd.ts[:4096],      # warm-up
                          dataclasses.replace(hd_cfg, backend="nmc"))
    ops.reset_launch_counts()
    for backend in ("nmc", "batched"):
        for name, extra in davis_cfgs.items():
            cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                          patch=7, th=225, backend=backend,
                                          device=device, **extra)
            got = pipeline.run_pipeline(davis.xy, davis.ts, cfg)
            fused, want = gpu_runs[name], cpu_runs[name]
            for field in ("scores", "kept", "tos", "lut", "vdd_trace"):
                if not np.array_equal(getattr(got, field),
                                      getattr(fused, field)):
                    raise AssertionError(f"DAVIS240 {name} {backend}: "
                                         f"{field} differs from fused")
            if got.energy_pj != fused.energy_pj:
                raise AssertionError(f"DAVIS240 {name} {backend}: energy")
            for field in ("kept", "tos", "vdd_trace"):
                if not np.array_equal(getattr(got, field),
                                      getattr(want, field)):
                    raise AssertionError(f"DAVIS240 {name} {backend}: "
                                         f"{field} differs from the CPU")
            err_s = close(got.scores, want.scores)
            err_l = close(got.lut, want.lut)
            print(f"[tos] DAVIS240 {name} {backend}: equal to the card's "
                  f"fused run on scores/kept/tos/lut/vdd/energy; against "
                  f"the CPU torch run kept/tos/vdd equal, scores max|delta| "
                  f"{err_s:.3g}, lut max|delta| {err_l:.3g}")
        cfg = dataclasses.replace(hd_cfg, backend=backend)
        sync(dev)
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(hd.xy, hd.ts, cfg)
        sync(dev)
        wall = time.perf_counter() - t0
        n_chunks = -(-len(hd) // cfg.chunk)
        if not (np.isfinite(res.lut).all() and res.kept.any()):
            raise AssertionError(f"HD {backend} run malformed")
        print(f"[tos] {smi}: HD 1280x720 {backend}: {len(hd)} events in "
              f"{n_chunks} chunks of 512, {wall:.3f} s wall = "
              f"{len(hd) / wall:.0f} events/s, {wall / n_chunks * 1e3:.3f} "
              f"ms/chunk (host clock, incl. upload and one fetch)")
        if device != "cpu":
            profile_hd(smi, f"HD {backend}", hd, cfg, {
                "K4 tos_update.cu": ("nmc_tile_kernel",),
                "K5 tos_count.cu": ("tos_count_kernel",),
                "K2 harris.cu": ("harris_kernel",)})

    # The binned modes through the op a caller uses: the HD stream's first
    # chunks folded into one surface per mode.
    n = fold_chunks * 512
    xy = torch.from_numpy(hd.xy[:n].astype(np.int32)).to(dev).reshape(
        -1, 512, 2)
    valid = torch.ones(xy.shape[:2], dtype=torch.bool, device=dev)
    surfaces = {}
    for mode in ops.TOS_MODES:
        surf = torch.zeros((720, 1280), dtype=torch.uint8, device=dev)
        for c in range(xy.shape[0]):
            surf = ops.tos_update_op(surf, xy[c], valid[c], patch=7, th=225,
                                     mode=mode)
        surfaces[mode] = surf
    for mode in ("nmc_binned", "batched_binned"):
        if not torch.equal(surfaces[mode], surfaces["nmc"]):
            raise AssertionError(f"HD fold {mode} differs from nmc")
    if not torch.equal(surfaces["batched"], surfaces["nmc"]):
        raise AssertionError("HD fold batched differs from nmc")
    print(f"[tos] HD fold of {xy.shape[0]} chunks through tos_update_op: "
          f"nmc = batched = nmc_binned = batched_binned (cap E), "
          f"{int((surfaces['nmc'] > 0).sum())} live pixels")
    launches = dict(ops.LAUNCHES)
    print(f"[tos] launches on the TOS-update paths: {launches}")
    if device != "cpu" and min(
            launches[k] for k in (*ops.TOS_MODES, "harris")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def profile_hd(smi, what, hd, cfg, groups, chunks=64):
    """Profile a short steady window (``chunks`` chunks) of the HD step:
    the unprofiled wall, the device busy time and idle share, the device
    time by kernel group, and the leading device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pipeline
    groups = {**groups, "copies": ("Memcpy", "Memset")}
    other = "plain torch (threefry, DVFS, ...)"
    win = slice(0, chunks * cfg.chunk)
    pipeline.run_pipeline(hd.xy[win], hd.ts[win], cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.run_pipeline(hd.xy[win], hd.ts[win], cfg)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.run_pipeline(hd.xy[win], hd.ts[win], cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side rows only (kernels, copies): an aten op's row, or a
    # span's, repeats the device time of the kernels it launched.
    rows = [r for r in device_rows(prof) if r.self_device_time_total > 0]
    rows.sort(key=lambda r: -r.self_device_time_total)
    per = {g: 0.0 for g in (*groups, other)}
    for r in rows:
        g = next((g for g, keys in groups.items()
                  if any(k in r.key for k in keys)), other)
        per[g] += r.self_device_time_total / 1e3
    dev_ms = sum(per.values())
    print(f"[profile] {smi}: {what}, {chunks} chunks: unprofiled wall "
          f"{plain_wall_ms:.2f} ms, profiled wall {wall_ms:.2f} ms, device "
          f"busy {dev_ms:.2f} ms, idle share "
          f"{1 - dev_ms / plain_wall_ms:.3f} (of the unprofiled wall)")
    for g, ms in per.items():
        print(f"[profile]   {g}: {ms:.3f} ms "
              f"({ms / chunks * 1e3:.1f} us/chunk)")
    dtod = sum(r.count for r in rows if "DtoD" in r.key)
    print(f"[profile]   device-to-device copies: {dtod} "
          f"({dtod / chunks:.2f} per chunk)")
    ours = [k for keys in groups.values() for k in keys]
    for i, r in enumerate(rows):
        if i < 10 or any(k in r.key for k in ours):
            print(f"[profile]   {r.self_device_time_total / 1e3:9.3f} ms "
                  f"x{r.count:<5d} {r.key[:90]}")


def serve_pool(cfg, streams, seeds, *, slab, max_events=None, **pool_kw):
    """Serve each stream on its own lane of one ``DetectorPool``: feed
    every lane a slab, pump, poll, until the streams are spent, then flush.
    Returns per-lane (scores, kept), the wall seconds from the first feed
    to the last flush (which waits for the device), the events served and
    ``pool_stats()``."""
    import numpy as np
    from repro_torch.serve import DetectorPool
    pool = DetectorPool(cfg, len(streams), **pool_kw)
    lanes = [pool.connect(seed=s) for s in seeds]
    n = max_events or max(len(st) for st in streams)
    outs = {i: [] for i in range(len(lanes))}
    t0 = time.perf_counter()
    for start in range(0, n, slab):
        for i, lane in enumerate(lanes):
            stop = min(start + slab, n)
            pool.feed(lane, streams[i].xy[start:stop],
                      streams[i].ts[start:stop])
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane))
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    wall = time.perf_counter() - t0
    stats = pool.pool_stats()
    served = sum(pool.stats(lane)["n_events"] for lane in lanes)
    pool.close()
    res = {i: (np.concatenate([o[0] for o in v]),
               np.concatenate([o[1] for o in v])) for i, v in outs.items()}
    return res, wall, served, stats


def davis_pool_cfg(device):
    """The DAVIS240 pool's config: 180x240, chunk 512, online DVFS with
    BER (phases 6 and 6b)."""
    from repro_torch.core import pipeline
    return pipeline.PipelineConfig(chunk=512, lut_every_chunks=2, patch=7,
                                   th=225, dvfs=True, dvfs_online=True,
                                   inject_ber=True, device=device)


def serving_phase(smi, *, device, lanes=16, hd_lanes=4, dav_us=200_000,
                  hd_us=100_000, hold_chunks=(24, 4), profile_chunks=32,
                  reps=3):
    """Phase 6: the serving path at full width on ``device``, each timed
    run made ``reps`` times (every repeat must give the same results);
    returns the launch counts of its runs and the HD pool's kept fraction.
    Smaller arguments rehearse the phase on the CPU."""
    import numpy as np
    from repro_torch.core import pipeline
    from repro_torch.events import synthetic
    from repro_torch.kernels import ops
    from repro_torch.obs.schema import WALL_TIME_KEYS

    dav_streams = [synthetic.shapes_stream(duration_us=dav_us, seed=s)
                   for s in range(lanes)]
    dav_cfg = davis_pool_cfg(device)
    hd_streams = [synthetic.shapes_stream(
        height=720, width=1280, duration_us=hd_us, n_shapes=12,
        signal_rate_per_us=2.0, noise_rate_per_us=0.5, seed=s)
        for s in range(hd_lanes)]
    hd_pool_cfg = pipeline.PipelineConfig(height=720, width=1280, chunk=512,
                                          lut_every_chunks=2, vdd=1.2,
                                          device=device)
    pool_kw = dict(ring_rounds=8, pipeline_depth=2)
    seeds = list(range(lanes))
    # warm-up: first launches load the kernels and the pinned allocator
    serve_pool(dav_cfg, dav_streams[:2], seeds[:2], slab=2048,
               max_events=4096, readout="compact", **pool_kw)

    ops.reset_launch_counts()
    runs = {}
    for name, kw in (("async_dense", dict(drain_mode="async",
                                          readout="dense")),
                     ("async_compact", dict(drain_mode="async",
                                            readout="compact")),
                     ("sync_dense", dict(drain_mode="sync",
                                         readout="dense"))):
        runs[name] = [serve_pool(dav_cfg, dav_streams, seeds, slab=16384,
                                 **kw, **pool_kw) for _ in range(reps)]
    hd_runs = [serve_pool(hd_pool_cfg, hd_streams, seeds[:hd_lanes],
                          slab=16384, readout="compact", drain_mode="async",
                          **pool_kw) for _ in range(reps)]
    serve_launches = dict(ops.LAUNCHES)
    pushed = sum(g[3]["rounds_executed"] for got in (*runs.values(), hd_runs)
                 for g in got)
    print(f"[serve] launches on the serving path: {serve_launches}; "
          f"{pushed} pool rounds")
    if device != "cpu" and min(serve_launches[k] for k in (
            "fused_step", "harris", "compact")) <= 0:
        raise AssertionError(f"a kernel was not launched: {serve_launches}")
    if device != "cpu" and serve_launches["compact"] != pushed:
        raise AssertionError(f"{serve_launches['compact']} K3 ring pushes "
                             f"for {pushed} pool rounds")

    for name, got in {**runs, "hd_compact": hd_runs}.items():
        for r, again in enumerate(got[1:], 1):
            same_results(again[0], got[0][0], f"{name} repeat {r}")
    same_results(runs["async_compact"][0][0], runs["async_dense"][0][0],
                 "DAVIS240 pool compact vs dense")
    same_results(runs["sync_dense"][0][0], runs["async_dense"][0][0],
                 "DAVIS240 pool sync vs async")
    for i, st in enumerate(dav_streams):
        kept = runs["async_dense"][0][0][i][1]
        if len(kept) != len(st) or not kept.any():
            raise AssertionError(f"DAVIS240 pool lane {i} malformed")
    for name, got in {**runs, "hd_compact": hd_runs}.items():
        res, _, served, st = got[0]
        walls = sorted(g[1] for g in got)
        wall, rounds = walls[len(walls) // 2], st["rounds_executed"]
        fetches = max(st["host_fetches"], 1)
        print(f"[serve] {smi}: {name}: {served} events on {len(res)} "
              f"lanes, wall median of {len(walls)} runs {wall:.4f} s "
              f"(min {walls[0]:.4f}, max {walls[-1]:.4f}) = "
              f"{served / wall:.0f} events/s; {rounds} pump rounds, "
              f"{wall / rounds * 1e3:.4f} ms per round (min "
              f"{walls[0] / rounds * 1e3:.4f}, max "
              f"{walls[-1] / rounds * 1e3:.4f}); "
              f"{st['host_fetches']} fetches, "
              f"{st['d2h_bytes'] / fetches:.0f} D2H bytes per fetch "
              f"(saved {st['d2h_bytes_saved']}), overflow slots "
              f"{st['d2h_compact_overflow_slots']}, forced drains "
              f"{st['pump_forced_drains']}, stages overlapped "
              f"{st['pump_stages_overlapped']}/{st['pump_stages']}")
    for i in range(hd_lanes):
        s_, k_ = hd_runs[0][0][i]
        if len(k_) != len(hd_streams[i]) or not np.isfinite(s_).any():
            raise AssertionError(f"HD pool lane {i} malformed")

    # The same pools on the CPU (plain versions), on a prefix of the feeds.
    for name, cfg_, strs, n_ev in (
            (f"DAVIS240 x{lanes}", dav_cfg, dav_streams,
             hold_chunks[0] * 512),
            (f"HD x{hd_lanes}", hd_pool_cfg, hd_streams,
             hold_chunks[1] * 512)):
        got = serve_pool(cfg_, strs, seeds[:len(strs)], slab=2048,
                         max_events=n_ev, readout="compact",
                         drain_mode="async", **pool_kw)
        cpu_cfg = dataclasses.replace(cfg_, device="cpu")
        want = serve_pool(cpu_cfg, strs, seeds[:len(strs)], slab=2048,
                          max_events=n_ev, readout="compact",
                          drain_mode="async", **pool_kw)
        err = 0.0
        for i in want[0]:
            if not np.array_equal(got[0][i][1], want[0][i][1]):
                raise AssertionError(f"{name}: lane {i} kept differs from "
                                     f"the CPU pool")
            err = max(err, close(got[0][i][0], want[0][i][0]))
        for key in want[3]:
            if key not in WALL_TIME_KEYS | {"h2d_pinned_staging"} \
                    and got[3][key] != want[3][key]:
                raise AssertionError(f"{name}: pool_stats[{key!r}] "
                                     f"{got[3][key]} vs {want[3][key]}")
        print(f"[serve] {name}, {n_ev} events per lane: kept equal to the "
              f"CPU pool, scores max|delta| {err:.3g}, pool_stats equal")

    kept_frac = float(np.mean(np.concatenate(
        [k for _, k in hd_runs[0][0].values()])))
    if device == "cpu":
        return serve_launches, kept_frac
    # Idle share of a profiled window of each pool.
    profile_pool(smi, f"DAVIS240 x{lanes} async dense", dav_cfg, dav_streams,
                 seeds, profile_chunks * 512, readout="dense", **pool_kw)
    profile_pool(smi, f"HD x{hd_lanes} async compact", hd_pool_cfg,
                 hd_streams, seeds[:hd_lanes], profile_chunks * 512,
                 readout="compact", **pool_kw)
    return serve_launches, kept_frac


ADAPTIVE_BUCKETS = (128, 512, 2048)
# events per DVFS half-window: the first half of the lanes ramp up to
# 2048 and back down to 512, the second half down to 128 and up to 2048
ADAPTIVE_RATES = ([100] * 10 + [1500] * 20 + [400] * 10,
                  [400] * 10 + [100] * 20 + [1500] * 10)


def adaptive_streams(lanes, windows, half_us):
    """Lane ``s``'s ramp (``synthetic.ramp_stream``, seed ``s``), cut to
    its first ``windows`` half-windows."""
    from repro_torch.events import synthetic
    return [synthetic.ramp_stream(
        ADAPTIVE_RATES[s >= lanes // 2][:windows], half_us, seed=s)
        for s in range(lanes)]


def adaptive_run(cfg, streams, windows, **pool_kw):
    """Serve ``streams`` on an adaptive pool (every lane connects at 128;
    lane 1 sheds with ``lut_every`` 3, lane 2 has ``vdd_cap`` 0): feed one
    half-window per lane, pump, poll every lane, for ``windows``
    half-windows, then flush.  Returns per-lane (scores, kept), the wall
    from the first feed to the last flush, the events served,
    ``pool_stats()``, the migration logs, whether every executor ran one
    block shape, and the host seconds of the polls that staged a move and
    of the others."""
    import numpy as np
    from repro_torch.serve import DetectorPool
    half = cfg.dvfs_cfg.half_us
    pool = DetectorPool(cfg, len(streams), buckets=ADAPTIVE_BUCKETS,
                        policy="adaptive", migrate_patience=2, ring_rounds=8,
                        pipeline_depth=2, **pool_kw)
    try:
        lanes = [pool.connect(seed=s, chunk=128) for s in range(len(streams))]
        pool.set_lane_control(lanes[1], lut_every=3, shed=True)
        pool.set_lane_control(lanes[2], vdd_cap=0)
        wins = [st.ts // half for st in streams]
        outs = {i: [] for i in range(len(lanes))}
        polls = {"staged": [], "other": []}
        t0 = time.perf_counter()
        for j in range(windows):
            for i, lane in enumerate(lanes):
                m = wins[i] == j
                pool.feed(lane, streams[i].xy[m], streams[i].ts[m])
            pool.pump()
            for i, lane in enumerate(lanes):
                t1 = time.perf_counter()
                outs[i].append(pool.poll(lane))
                dt = time.perf_counter() - t1
                staged = lane in pool._rt.staged_migrations()
                polls["staged" if staged else "other"].append(dt)
        for i, lane in enumerate(lanes):
            outs[i].append(pool.flush(lane))
        wall = time.perf_counter() - t0
        lane_stats = [pool.stats(lane) for lane in lanes]
        return (
            {i: (np.concatenate([o[0] for o in v]),
                 np.concatenate([o[1] for o in v])) for i, v in outs.items()},
            wall, sum(st["n_events"] for st in lane_stats),
            pool.pool_stats(), [st["migration_log"] for st in lane_stats],
            pool.executors_compiled_once(), polls)
    finally:
        pool.close()


def rebucket_replay(cfg, xy, ts, log, start=128, seed=0):
    """A pool lane (``adaptive_run``'s lane 0 by default) as one
    ``StreamingDetector`` that starts at chunk ``start`` and
    ``rebucket()``s at each logged boundary."""
    import numpy as np
    from repro_torch.serve import StreamingDetector
    det = StreamingDetector(cfg, chunk=start, seed=seed)
    parts, cur = [], 0
    for m, _frm, to in log:
        parts.append(det.feed(xy[cur:m], ts[cur:m]))
        det.rebucket(to)
        cur = m
    parts.append(det.feed(xy[cur:], ts[cur:]))
    parts.append(det.flush())
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def adaptive_phase(smi, *, device, lanes=16, windows=40, cpu_windows=14,
                   reps=3):
    """Phase 6b: the adaptive pool (``policy="adaptive"``, live bucket
    migration and per-lane knobs) at the DAVIS240 x16 pool's width on
    ``device``, async, dense and compact readout, ``reps`` runs each
    (every repeat must give the same results); then a prefix of
    ``cpu_windows`` half-windows against the same pool on the CPU, and
    lane 0 against a ``rebucket`` replay.  Returns the launch counts of
    the timed runs.  Smaller arguments rehearse the phase on the CPU."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.obs.schema import WALL_TIME_KEYS

    t_phase = time.perf_counter()
    cfg = davis_pool_cfg(device)
    streams = adaptive_streams(lanes, windows, cfg.dvfs_cfg.half_us)
    ops.reset_launch_counts()
    runs = {ro: [adaptive_run(cfg, streams, windows, readout=ro,
                              drain_mode="async") for _ in range(reps)]
            for ro in ("dense", "compact")}
    launches = dict(ops.LAUNCHES)
    rounds = sum(g[3]["rounds_executed"] for got in runs.values()
                 for g in got)
    print(f"[adaptive] launches: {launches}; {rounds} pool rounds")
    if device != "cpu" and min(launches[k] for k in (
            "fused_step", "harris", "compact")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if device != "cpu" and launches["compact"] != rounds:
        raise AssertionError(f"{launches['compact']} K3 ring pushes for "
                             f"{rounds} pool rounds")
    for ro, got in runs.items():
        for r, again in enumerate(got[1:], 1):
            same_results(again[0], got[0][0], f"adaptive {ro} repeat {r}")
            if again[4] != got[0][4]:
                raise AssertionError(f"adaptive {ro} repeat {r}: migration "
                                     f"logs differ")
        if not all(g[5] for g in got):
            raise AssertionError(f"adaptive {ro}: an executor ran more "
                                 f"than one block shape")
    same_results(runs["compact"][0][0], runs["dense"][0][0],
                 "adaptive compact vs dense")
    res, _, served, st, logs, _, _ = runs["dense"][0]
    for i in range(lanes // 2):
        if len(logs[i]) < 2:
            raise AssertionError(f"adaptive lane {i} migrated "
                                 f"{len(logs[i])} times: {logs[i]}")
    for i, s_ in enumerate(streams):
        if i != 1 and len(res[i][1]) != len(s_):
            raise AssertionError(f"adaptive lane {i} malformed")
    if st["shed_events_total"] <= 0 or \
            len(res[1][1]) + st["shed_events_total"] != len(streams[1]):
        raise AssertionError(f"lane 1 shed {st['shed_events_total']} "
                             f"events and served {len(res[1][1])}")
    for ro, got in runs.items():
        walls = sorted(g[1] for g in got)
        wall, n_rounds = walls[len(walls) // 2], got[0][3]["rounds_executed"]
        staged = sorted(t for g in got for t in g[6]["staged"])
        other = sorted(t for g in got for t in g[6]["other"])
        ps = got[0][3]
        print(f"[adaptive] {smi}: async {ro}: {served} events on {lanes} "
              f"lanes in {windows} half-windows, wall median of "
              f"{len(walls)} runs {wall:.4f} s (min {walls[0]:.4f}, max "
              f"{walls[-1]:.4f}) = {served / wall:.0f} events/s; {n_rounds} "
              f"pump rounds, {wall / n_rounds * 1e3:.4f} ms per round (min "
              f"{walls[0] / n_rounds * 1e3:.4f}, max "
              f"{walls[-1] / n_rounds * 1e3:.4f}); {ps['host_fetches']} "
              f"fetches, {ps['d2h_bytes'] / max(ps['host_fetches'], 1):.0f} "
              f"D2H bytes per fetch, overflow slots "
              f"{ps['d2h_compact_overflow_slots']}; migrations_total "
              f"{ps['migrations_total']}, shed_events_total "
              f"{ps['shed_events_total']}; poll that staged a move "
              f"median {staged[len(staged) // 2] * 1e3:.4f} ms "
              f"({len(staged)} polls), other polls median "
              f"{other[len(other) // 2] * 1e3:.4f} ms ({len(other)})")
    print(f"[adaptive] migration logs (events_folded, from, to): lane 0 "
          f"{logs[0]}, lane {lanes - 1} {logs[-1]}")

    # The same pool on the CPU (plain versions) on a prefix of the feeds.
    cpu_cfg = dataclasses.replace(cfg, device="cpu")
    pre = adaptive_streams(lanes, cpu_windows, cfg.dvfs_cfg.half_us)
    got = adaptive_run(cfg, pre, cpu_windows, readout="compact",
                       drain_mode="async")
    want = adaptive_run(cpu_cfg, pre, cpu_windows, readout="compact",
                        drain_mode="async")
    if got[4] != want[4]:
        raise AssertionError("adaptive prefix: migration logs differ from "
                             "the CPU pool's")
    err = 0.0
    for i in want[0]:
        if not np.array_equal(got[0][i][1], want[0][i][1]):
            raise AssertionError(f"adaptive prefix: lane {i} kept differs "
                                 f"from the CPU pool")
        err = max(err, close(got[0][i][0], want[0][i][0]))
    for key in want[3]:
        if key not in WALL_TIME_KEYS | {"h2d_pinned_staging"} \
                and got[3][key] != want[3][key]:
            raise AssertionError(f"adaptive prefix: pool_stats[{key!r}] "
                                 f"{got[3][key]} vs {want[3][key]}")
    print(f"[adaptive] {cpu_windows} half-windows: kept, migration logs "
          f"({got[3]['migrations_total']} moves) and pool_stats equal to "
          f"the CPU pool, scores max|delta| {err:.3g}")

    s_, k_ = rebucket_replay(cfg, streams[0].xy, streams[0].ts, logs[0])
    if not (np.array_equal(s_, res[0][0]) and np.array_equal(k_, res[0][1])):
        raise AssertionError("adaptive lane 0 differs from its rebucket "
                             "replay")
    print(f"[adaptive] lane 0 equals a StreamingDetector rebucketed at "
          f"{[m for m, _, _ in logs[0]]} on {device}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches

# Phase 6c: the ladder and pack pools.  Of every 16 lanes, 6 connect at
# chunk 128, 6 at 512 and 4 (premium under the ladder) at 2048.
LADDER_BUDGET = 16           # rounds per pump during the ladder run


def ladder_placement(lanes):
    """``(chunk, qos)`` of each lane: the first 3/8 at 128, the next 3/8 at
    512, the last quarter at 2048 and premium."""
    a, b = 6 * lanes // 16, 12 * lanes // 16
    return [(128 if i < a else 512 if i < b else 2048,
             "standard" if i < b else "premium") for i in range(lanes)]


def ladder_streams(kind, lanes, windows, half_us):
    """Lane ``s``'s feed (seed ``s``): under ``"ladder"`` 1,000 events per
    half-window with a 3x burst over half-windows 10-25
    (``synthetic.burst_stream``), under ``"pack"`` a flat 150
    (``synthetic.ramp_stream``)."""
    from repro_torch.events import synthetic
    if kind == "ladder":
        return [synthetic.burst_stream(1_000, windows, half_us,
                                       burst_factor=3.0, burst_start=10,
                                       burst_len=16, seed=s)
                for s in range(lanes)]
    return [synthetic.ramp_stream([150] * windows, half_us, seed=s)
            for s in range(lanes)]


def ladder_run(cfg, streams, windows, *, policy, k2_lanes, recover=False,
               **pool_kw):
    """Serve ``streams`` on a pool of ``policy`` (``"ladder"``, ``"pack"``
    or, as the never-packed yardstick, ``"static"``) with
    ``ladder_placement``: each step feeds one half-window per lane and
    pumps, ``pump_rounds(LADDER_BUDGET)`` under the ladder (no polls),
    else ``pump()`` then a poll of every lane; ``recover`` then runs the
    reference's recovery recipe (up to 20 times ``pump()`` and a
    non-blocking poll of every lane, until the level is 0, then one more
    ``pump()``; under async drain the polls wait for the reader, whose lag
    is part of the pressure); every lane is flushed last.  Each pump is
    followed by a synchronise, so a pass's wall and launches are
    attributed to the level its rounds ran at.  ``k2_lanes`` is a one-item
    list counting the lanes K2 refreshed."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import DetectorPool
    half = cfg.dvfs_cfg.half_us
    pool = DetectorPool(cfg, len(streams), buckets=ADAPTIVE_BUCKETS,
                        policy=policy, migrate_patience=2, ring_rounds=8,
                        pipeline_depth=2, **pool_kw)
    try:
        place = ladder_placement(len(streams))
        lanes = [pool.connect(seed=s, chunk=c, qos=q)
                 for s, (c, q) in enumerate(place)]
        rt = pool._rt
        premium = [lane for lane, (_, q) in zip(lanes, place)
                   if q == "premium"]
        neutral = (cfg.lut_every_chunks, rt.vdd_top, False)
        wins = [st.ts // half for st in streams]
        outs = {i: [] for i in range(len(lanes))}
        levels, per_level, pads = [], {}, []

        def step(pump):
            before, k2 = dict(ops.LAUNCHES), k2_lanes[0]
            t1 = time.perf_counter()
            n = pump()
            sync(cfg.device)
            dt = time.perf_counter() - t1
            lvl = getattr(pool.scheduler, "level", 0)
            acc = per_level.setdefault(
                lvl, {"passes": 0, "rounds": 0, "s": 0.0, "k2_lanes": 0,
                      **{k: 0 for k in ops.LAUNCHES}})
            acc["passes"] += 1
            acc["rounds"] += n
            acc["s"] += dt
            acc["k2_lanes"] += k2_lanes[0] - k2
            for k in ops.LAUNCHES:
                acc[k] += ops.LAUNCHES[k] - before[k]
            levels.append(lvl)
            c = rt._states.ctrl
            for lane in premium:
                if rt._lanes[lane].tier != 0 or (
                        int(c.lut_every[lane]), int(c.vdd_cap[lane]),
                        bool(c.shed[lane])) != neutral:
                    raise AssertionError(f"premium lane {lane} degraded")
            ps = pool.pool_stats()
            away = sum(rt._lanes[lane].bucket != c
                       for lane, (c, _) in zip(lanes, place))
            pads.append((ps["rounds_executed"], ps["h2d_padding_bytes"],
                         away))

        t0 = time.perf_counter()
        for j in range(windows):
            for i, lane in enumerate(lanes):
                m = wins[i] == j
                pool.feed(lane, streams[i].xy[m], streams[i].ts[m])
            if policy == "ladder":
                step(lambda: pool.pump_rounds(LADDER_BUDGET))
            else:
                step(pool.pump)
                for i, lane in enumerate(lanes):
                    outs[i].append(pool.poll(lane))
        if recover:
            for _ in range(20):
                step(pool.pump)
                for i, lane in enumerate(lanes):
                    outs[i].append(pool.poll(
                        lane, wait=pool.drain_mode == "async"))
                if pool.scheduler.level == 0:
                    break
            step(pool.pump)
        for i, lane in enumerate(lanes):
            outs[i].append(pool.flush(lane))
        wall = time.perf_counter() - t0
        lane_stats = [pool.stats(lane) for lane in lanes]
        res = {i: (np.concatenate([o[0] for o in v]),
                   np.concatenate([o[1] for o in v]))
               for i, v in outs.items()}
        return dict(
            res=res, wall=wall, levels=levels, per_level=per_level,
            pads=pads, stats=lane_stats, pool=pool.pool_stats(),
            logs=[st["migration_log"] for st in lane_stats],
            home=[st["bucket"] for st in lane_stats] == [c for c, _ in place],
            once=pool.executors_compiled_once(),
            scored=sum(len(r[1]) for r in res.values()))
    finally:
        pool.close()


def _compare_ladder_runs(got, want, what, *, pool_stats):
    """Two runs of one pool: results, levels and migration logs equal, and
    with ``pool_stats`` the per-lane tiers and knobs and ``pool_stats()``
    apart from wall-clock keys (scores within the bound when the two ran
    on different devices).  Returns the scores' max |delta|."""
    import numpy as np
    from repro_torch.obs.schema import WALL_TIME_KEYS
    if got["levels"] != want["levels"] or got["logs"] != want["logs"]:
        raise AssertionError(f"{what}: level trajectory or migration logs "
                             f"differ")
    err = 0.0
    for i in want["res"]:
        if not np.array_equal(got["res"][i][1], want["res"][i][1]):
            raise AssertionError(f"{what}: lane {i} kept differs")
        err = max(err, close(got["res"][i][0], want["res"][i][0]))
    if pool_stats:
        for g, w in zip(got["stats"], want["stats"]):
            for key in ("ladder_tier", "ctrl_lut_every", "ctrl_vdd_cap",
                        "ctrl_shed", "shed_events", "bucket"):
                if g[key] != w[key]:
                    raise AssertionError(f"{what}: lane {g['lane']} {key} "
                                         f"{g[key]} vs {w[key]}")
        for key in want["pool"]:
            if key not in WALL_TIME_KEYS | {"h2d_pinned_staging"} \
                    and got["pool"][key] != want["pool"][key]:
                raise AssertionError(f"{what}: pool_stats[{key!r}] "
                                     f"{got['pool'][key]} vs "
                                     f"{want['pool'][key]}")
    return err


def padding_by_placement(pads):
    """H2D padding bytes per round over the passes that ran with every lane
    in its home bucket, and over those with the most lanes packed away
    (``pads``: cumulative ``(rounds, padding bytes, lanes away)`` after each
    pass; a pass's rounds run with the moves applied at its start)."""
    most = max(p[2] for p in pads)
    sums = {0: [0, 0], most: [0, 0]}
    prev = (0, 0)
    for r, b, away in pads:
        if away in sums:
            sums[away][0] += r - prev[0]
            sums[away][1] += b - prev[1]
        prev = (r, b)
    return most, tuple(b / r if r else float("nan")
                       for r, b in (sums[0], sums[most]))


def _runs(levels):
    """A level trajectory as (level, passes) runs."""
    out = []
    for lvl in levels:
        if out and out[-1][0] == lvl:
            out[-1][1] += 1
        else:
            out.append([lvl, 1])
    return " ".join(f"{lvl}x{n}" for lvl, n in out)


def ladder_phase(smi, *, device, lanes=16, windows=40, cpu_windows=8,
                 reps=3):
    """Phase 6c: the rest of the control plane at the DAVIS240 x16 pool's
    width on ``device``: the ladder pool (``policy="ladder"``, default
    ``LadderConfig``: QoS-ordered tiers, shedding, packing at the top
    level) through a 3x burst on a round budget and its recovery, sync
    drain, dense and compact readout, ``reps`` runs each (all equal), one
    async run checked for invariants, and a prefix of ``cpu_windows``
    half-windows against the same pool on the CPU; then the pack pool
    (``policy="pack"``) on sparse feeds, against the CPU pool, with a
    packed lane against a ``rebucket`` replay.  Returns the launch counts
    of the runs.  Smaller arguments rehearse the phase on the CPU."""
    import numpy as np
    from repro_torch.kernels import harris_conv, ops

    t_phase = time.perf_counter()
    cfg = davis_pool_cfg(device)
    half = cfg.dvfs_cfg.half_us
    cpu_cfg = dataclasses.replace(cfg, device="cpu")
    burst = ladder_streams("ladder", lanes, windows, half)
    sparse = ladder_streams("pack", lanes, windows, half)
    top = 3                            # the default LadderConfig's
    k2_lanes = [0]
    harris_cuda = harris_conv.harris_cuda

    def counted(tos, **kw):
        k2_lanes[0] += tos.shape[0]
        return harris_cuda(tos, **kw)

    harris_conv.harris_cuda = counted
    try:
        ops.reset_launch_counts()
        runs = {ro: [ladder_run(cfg, burst, windows, policy="ladder",
                                k2_lanes=k2_lanes, recover=True,
                                readout=ro, drain_mode="sync")
                     for _ in range(reps)]
                for ro in ("dense", "compact")}
        runs["async"] = [ladder_run(cfg, burst, windows, policy="ladder",
                                    k2_lanes=k2_lanes, recover=True,
                                    readout="dense", drain_mode="async")]
        runs["pack"] = [ladder_run(cfg, sparse, windows, policy="pack",
                                   k2_lanes=k2_lanes, readout="dense",
                                   drain_mode="sync")]
        runs["static"] = [ladder_run(cfg, sparse, windows, policy="static",
                                     k2_lanes=k2_lanes, readout="dense",
                                     drain_mode="sync")]
        launches = dict(ops.LAUNCHES)
    finally:
        harris_conv.harris_cuda = harris_cuda
    rounds = sum(g["pool"]["rounds_executed"] for got in runs.values()
                 for g in got)
    print(f"[ladder] launches: {launches}; {rounds} pool rounds")
    if device != "cpu" and min(launches[k] for k in (
            "fused_step", "harris", "compact")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if device != "cpu" and launches["compact"] != rounds:
        raise AssertionError(f"{launches['compact']} K3 ring pushes for "
                             f"{rounds} pool rounds")

    for name in ("dense", "compact", "async"):
        for r, g in enumerate(runs[name]):
            ps = g["pool"]
            if max(g["levels"]) != top or g["levels"][-1] != 0:
                raise AssertionError(f"ladder {name} run {r}: levels "
                                     f"{_runs(g['levels'])}")
            if not (ps["pack_moves"] > 0 and g["home"] and g["once"]):
                raise AssertionError(
                    f"ladder {name} run {r}: pack_moves "
                    f"{ps['pack_moves']}, lanes home {g['home']}, "
                    f"one block shape per executor {g['once']}")
    for name in ("dense", "compact"):
        for r, again in enumerate(runs[name][1:], 1):
            _compare_ladder_runs(again, runs[name][0],
                                 f"ladder {name} repeat {r}",
                                 pool_stats=False)
    _compare_ladder_runs(runs["compact"][0], runs["dense"][0],
                         "ladder compact vs dense", pool_stats=False)
    fed = {"pack": sum(len(st) for st in sparse),
           "static": sum(len(st) for st in sparse)}
    for name, got in runs.items():
        walls = sorted(g["wall"] for g in got)
        g = got[0]
        ps, n_rounds = g["pool"], g["pool"]["rounds_executed"]
        wall = walls[len(walls) // 2]
        most, (pad_home, pad_packed) = padding_by_placement(g["pads"])
        print(f"[ladder] {smi}: {name} ({ps['drain_mode']} "
              f"{ps['readout']}): {g['scored']} events scored of "
              f"{fed.get(name, sum(len(st) for st in burst))} fed on "
              f"{lanes} lanes in {windows} half-windows, wall median of "
              f"{len(walls)} runs {wall:.4f} s (min {walls[0]:.4f}, max "
              f"{walls[-1]:.4f}) = {g['scored'] / wall:.0f} events/s; "
              f"{n_rounds} rounds, {wall / n_rounds * 1e3:.4f} ms per round "
              f"(min {walls[0] / n_rounds * 1e3:.4f}, max "
              f"{walls[-1] / n_rounds * 1e3:.4f}); transitions "
              f"{ps.get('ladder_transitions')}, shed events "
              f"{ps['shed_events_total']}, pack moves {ps.get('pack_moves')} "
              f"(saved slots {ps.get('pack_saved_slots')}), migrations "
              f"{ps['migrations_total']}")
        if name not in ("pack", "static"):
            print(f"[ladder] {name}: levels by pass {_runs(g['levels'])}; "
                  f"H2D padding bytes per round {pad_home:.0f} with every "
                  f"lane home, {pad_packed:.0f} with {most} lanes packed")
        for lvl in sorted(g["per_level"]):
            a = g["per_level"][lvl]
            r_ = max(a["rounds"], 1)
            print(f"[ladder] {name} level {lvl}: {a['passes']} passes, "
                  f"{a['rounds']} rounds, {a['s'] / r_ * 1e3:.4f} ms per "
                  f"round (pump and synchronise), per round K1 "
                  f"{a['fused_step'] / r_:.3f}, K2 {a['harris'] / r_:.3f} "
                  f"launches over {a['k2_lanes'] / r_:.3f} lanes, K3 "
                  f"{a['compact'] / r_:.3f}")

    # The pack run against the same feeds never packed (the static pool),
    # then a packed lane against a rebucket replay.
    g, base = runs["pack"][0], runs["static"][0]
    ps, ps0 = g["pool"], base["pool"]
    pad = {k: (p["h2d_padding_bytes"], p["rounds_executed"])
           for k, p in (("pack", ps), ("static", ps0))}
    if not (ps["pack_moves"] > 0 and ps["pack_saved_slots"] > 0
            and g["once"] and pad["pack"][0] < pad["static"][0]
            and pad["pack"][0] / pad["pack"][1]
            < pad["static"][0] / pad["static"][1]):
        raise AssertionError(
            f"pack run: pack_moves {ps['pack_moves']}, saved "
            f"{ps['pack_saved_slots']}, H2D padding bytes and rounds {pad}")
    print(f"[ladder] pack: H2D padding {pad['pack'][0]} bytes in "
          f"{pad['pack'][1]} rounds = {pad['pack'][0] / pad['pack'][1]:.0f} "
          f"per round, against {pad['static'][0]} in {pad['static'][1]} = "
          f"{pad['static'][0] / pad['static'][1]:.0f} per round never "
          f"packed (static, same feeds): {1 - pad['pack'][0] / pad['static'][0]:.3f}"
          f" saved")
    lane = max(i for i, lg in enumerate(g["logs"]) if lg)
    start = ladder_placement(lanes)[lane][0]
    s_, k_ = rebucket_replay(cfg, sparse[lane].xy, sparse[lane].ts,
                             g["logs"][lane], start=start, seed=lane)
    if not (np.array_equal(s_, g["res"][lane][0])
            and np.array_equal(k_, g["res"][lane][1])):
        raise AssertionError(f"pack lane {lane} differs from its rebucket "
                             f"replay")
    print(f"[ladder] pack: lane {lane} equals a StreamingDetector from "
          f"{start} rebucketed at {[m for m, _, _ in g['logs'][lane]]}")

    # The same pools on the CPU (plain versions).
    want = ladder_run(cpu_cfg, sparse, windows, policy="pack",
                      k2_lanes=[0], readout="dense", drain_mode="sync")
    err = _compare_ladder_runs(g, want, "pack vs CPU", pool_stats=True)
    print(f"[ladder] pack: kept, levels, migration logs, tiers, knobs and "
          f"pool_stats equal to the CPU pool, scores max|delta| {err:.3g}")
    got = ladder_run(cfg, burst, cpu_windows, policy="ladder",
                     k2_lanes=[0], readout="compact", drain_mode="sync")
    want = ladder_run(cpu_cfg, burst, cpu_windows, policy="ladder",
                      k2_lanes=[0], readout="compact", drain_mode="sync")
    err = _compare_ladder_runs(got, want, "ladder prefix vs CPU",
                               pool_stats=True)
    print(f"[ladder] {cpu_windows} half-windows: levels "
          f"{_runs(got['levels'])}, {got['pool']['pack_moves']} pack moves, "
          f"kept, migration logs, tiers, knobs and pool_stats equal to the "
          f"CPU pool, scores max|delta| {err:.3g}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def profile_pool(smi, what, cfg, streams, seeds, n_events, reps=3,
                 **pool_kw):
    """Serve ``n_events`` per lane ``reps`` times unprofiled, then once
    under the profiler.  The idle share is 1 - the profiled device busy
    time over the median unprofiled wall (the profiler slows the host, not
    the kernels).  Also prints the launches per round and the leading
    device rows."""
    from torch.profiler import ProfilerActivity, profile
    kw = dict(slab=n_events, max_events=n_events, drain_mode="async",
              **pool_kw)
    walls = sorted(serve_pool(cfg, streams, seeds, **kw)[1] * 1e3
                   for _ in range(reps))
    wall = walls[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_wall, _, st = serve_pool(cfg, streams, seeds, **kw)
    dev_rows = device_rows(prof)
    busy = sum(r.self_device_time_total for r in dev_rows) / 1e3
    n_launch = sum(r.count for r in dev_rows)
    rounds = st["rounds_executed"]
    print(f"[serve] {smi}: {what} window, {rounds} rounds: unprofiled wall "
          f"median of {reps} {wall:.2f} ms (min {walls[0]:.2f}, max "
          f"{walls[-1]:.2f}) = {wall / rounds:.3f} ms per round; profiled "
          f"wall {prof_wall * 1e3:.2f} ms; device busy {busy:.2f} ms = "
          f"{busy / rounds:.3f} ms per round; idle share "
          f"{1 - busy / wall:.3f} (min {1 - busy / walls[0]:.3f}, max "
          f"{1 - busy / walls[-1]:.3f}); {n_launch} kernels and copies, "
          f"{n_launch / rounds:.0f} per round")
    ours = (*K1_KERNELS, "harris_kernel", "compact_kernel",
            "ring_push_kernel")
    for i, r in enumerate(sorted(
            (r for r in dev_rows if r.self_device_time_total > 0),
            key=lambda r: -r.self_device_time_total)):
        if i < 8 or any(k in r.key for k in ours):
            print(f"[serve]   {r.self_device_time_total / 1e3:9.3f} ms "
                  f"x{r.count:<5d} ({r.self_device_time_total / r.count:.1f}"
                  f" us each) {r.key[:80]}")


def same_results(a, b, what):
    """Two pools on one device: every output equal."""
    import numpy as np
    for i in a:
        for k in (0, 1):
            if not np.array_equal(a[i][k], b[i][k]):
                raise AssertionError(f"{what}: lane {i} differs")


def close(got, want):
    """Max |delta| over finite entries; raises unless -inf positions match
    and |delta| <= REL * max|want|."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), fin) or not np.array_equal(
            got[~fin], want[~fin]):
        raise AssertionError("non-finite positions differ")
    if not fin.any():
        return 0.0
    err = float(np.abs(got[fin] - want[fin]).max())
    bound = REL * float(np.abs(want[fin]).max())
    if err > bound:
        raise AssertionError(f"max |delta| {err:.3g} > bound {bound:.3g}")
    return err


# --- 6m: the lane mesh (M11c-1b) -------------------------------------------

LANE_SKIP = {"sharded", "devices"}
# The tallies a padding lane widens (every upload and ring slot is
# ``phys`` lanes wide).
LANE_PADDING = {"h2d_event_slots", "h2d_padding_bytes", "d2h_bytes",
                "d2h_bytes_saved"}


def _same_pool_stats(got, want, skip, what):
    """``pool_stats()`` equal apart from wall clocks and ``skip`` (also
    inside each bucket)."""
    from repro_torch.obs.schema import WALL_TIME_KEYS
    drop = WALL_TIME_KEYS | set(skip)

    def norm(d):
        return {k: (norm(v) if isinstance(v, dict) else v)
                for k, v in d.items() if k not in drop}
    g, w = norm(got), norm(want)
    if g != w:
        diff = sorted(k for k in w if g.get(k) != w[k])
        raise AssertionError(f"{what}: pool_stats differ in {diff}")


def lanes_phase(smi, *, device="cuda", lanes=16, dav_us=100_000, reps=2):
    """Phase 6m, lines ``[lanes]``: the DAVIS240 x``lanes`` pool (async
    compact, timed in turns ``reps`` times; sync dense once) with
    ``shard=False``, with ``shard=True`` (a 1-wide lane mesh on one card)
    and on a mesh that repeats the first device twice (the split, the
    per-shard launches and the gather, on one card), every layout's kept,
    scores and ``pool_stats()`` equal to the unsharded pool's apart from
    ``sharded`` / ``devices``; launches and host ms per pump round of each;
    ``shard="auto"`` over every card where there is more than one.
    Returns the launches of its runs.  ``device="cpu"`` with small sizes
    rehearses it (a mesh of the CPU twice, no launch counts)."""
    from unittest import mock
    import torch
    from repro_torch.events import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding

    t_phase = time.perf_counter()
    streams = [synthetic.shapes_stream(duration_us=dav_us, seed=s)
               for s in range(lanes)]
    cfg = davis_pool_cfg(device)
    seeds = list(range(lanes))
    dev0 = torch.device(device, 0) if device != "cpu" else torch.device(
        "cpu")
    layouts = {"unsharded": (dict(shard=False), None),
               "1-wide": (dict(shard=True), sharding.LaneMesh((dev0,))),
               "2 shards on one card": (dict(shard=True), sharding.LaneMesh(
                   (dev0, dev0)))}
    pool_kw = dict(ring_rounds=8, pipeline_depth=2)
    total = {k: 0 for k in ops.LAUNCHES}

    def run(name, slab=16384, **kw):
        extra, mesh = layouts[name]
        patch = (mock.patch.object(sharding, "local_lane_mesh",
                                   lambda *a, **k: mesh)
                 if mesh is not None else contextlib.nullcontext())
        ops.reset_launch_counts()
        with patch:
            got = serve_pool(cfg, streams, seeds, slab=slab, **extra, **kw,
                             **pool_kw)
        counts = dict(ops.LAUNCHES)
        for k in total:
            total[k] += counts[k]
        return got, counts

    # warm-up: the 2-shard layout's first launches
    run("2 shards on one card", slab=2048, max_events=4096,
        drain_mode="async", readout="compact")
    timed = {name: [] for name in layouts}
    for _ in range(reps):
        for name in layouts:
            timed[name].append(run(name, drain_mode="async",
                                   readout="compact"))
    want = timed["unsharded"][0][0]
    for name, runs in timed.items():
        for r, ((res, wall, served, st), counts) in enumerate(runs):
            same_results(res, want[0], f"[lanes] {name} run {r}")
            _same_pool_stats(st, want[3], LANE_SKIP, f"[lanes] {name}")
        st, counts = runs[0][0][3], runs[0][1]
        n_shards = 1 if layouts[name][1] is None else len(
            layouts[name][1].devices)
        if (st["sharded"], st["devices"]) != (name != "unsharded",
                                              n_shards):
            raise AssertionError(f"[lanes] {name}: sharded "
                                 f"{st['sharded']} devices {st['devices']}")
        rounds = st["rounds_executed"]
        if device != "cpu":
            if min(counts[k] for k in ("fused_step", "harris",
                                       "compact")) <= 0:
                raise AssertionError(f"[lanes] {name}: a kernel was not "
                                     f"launched: {counts}")
            if counts["compact"] != n_shards * rounds:
                raise AssertionError(
                    f"[lanes] {name}: {counts['compact']} K3 pushes for "
                    f"{rounds} rounds on {n_shards} shard(s)")
        walls = sorted(g[0][1] for g in runs)
        per = ", ".join(f"{k} {counts[k] / rounds:.3f}"
                        for k in ("fused_step", "harris", "compact"))
        print(f"[lanes] {smi}: DAVIS240 x{lanes} async compact, {name}: "
              f"{runs[0][0][2]} events, {rounds} pump rounds; launches per "
              f"round {per}; host ms per round "
              f"{', '.join(f'{w / rounds * 1e3:.4f}' for w in walls)} over "
              f"{len(walls)} runs in turns; kept, scores and pool_stats "
              f"equal to the unsharded pool's")
    sync = {name: run(name, drain_mode="sync", readout="dense")[0]
            for name in layouts}
    for name, got in sync.items():
        same_results(got[0], want[0], f"[lanes] sync dense {name}")
        _same_pool_stats(got[3], sync["unsharded"][3], LANE_SKIP,
                         f"[lanes] sync dense {name}")
    print(f"[lanes] sync dense: {', '.join(sync)} equal to the async "
          f"compact runs and to each other")
    n_dev = torch.cuda.device_count() if device != "cpu" else 1
    if n_dev > 1:
        ops.reset_launch_counts()
        got = serve_pool(cfg, streams, seeds, slab=16384, shard="auto",
                         drain_mode="async", readout="compact", **pool_kw)
        for k in total:
            total[k] += ops.LAUNCHES[k]
        same_results(got[0], want[0], f"[lanes] auto over {n_dev} cards")
        _same_pool_stats(got[3], want[3], LANE_SKIP | LANE_PADDING,
                         f"[lanes] auto over {n_dev} cards")
        print(f"[lanes] shard='auto' over {got[3]['devices']} cards: kept "
              f"and scores equal to the unsharded pool's")
    else:
        print(f"[lanes] {n_dev} card: shard='auto' over several cards is "
              f"left unchecked")
    print(f"[lanes] phase took {time.perf_counter() - t_phase:.1f} s")
    return total


# --- 6d-6f: the user-facing entry points (the serving CLI, the fleet
# scenarios, the serving bench), each as a user calls it.

# Phase 6d's CLI runs, each beside the flags they share.  The ladder's slab
# is 1,024 events: at the CLI's default 400 a lane never holds more than two
# ready rounds when a pass starts, which is not above the ladder's
# ``hi_rounds`` of 2.0, so the ladder would never climb.
CLI_RUNS = (
    ("static async dense", ["--policy", "static"]),
    ("static async compact", ["--policy", "static", "--readout", "compact"]),
    ("adaptive", ["--policy", "adaptive", "--buckets", "64,256,1024",
                  "--connect-chunk", "64"]),
    ("ladder", ["--policy", "ladder", "--burst-factor", "2",
                "--qos", "standard,premium", "--slab", "1024"]),
    ("pack", ["--policy", "pack", "--buckets", "64,256,1024"]),
    ("nmc", ["--policy", "static", "--backend", "nmc"]),
    ("batched", ["--policy", "static", "--backend", "batched"]),
)
# The runs that take the backend's own sessions instead of the full count.
CLI_BACKEND_RUNS = ("nmc", "batched")
CLI_LANE = r"^  lane (\d+): bucket (\d+), qos (\S+) \(tier (\d+)\), " \
    r"rate est .*?, (\d+) migration\(s\) (.*)$"
CLI_EVENT = r"^  \[(backpressure|migration|ladder)\] "
SERVED = r"^served \d+ sessions / (\d+) events in "
# A structural bench row: a count or a ratio of counts, fixed by the sizes
# and the seed (the rest are wall time).
STRUCTURAL = (r"(_fetches_per_round|_rounds_per_fetch|_d2h_bytes_\w+"
              r"|_migration_(count|padding_saved_ratio|padding_saved_mb"
              r"|rounds_per_fetch)|_pump_stage_overlap_ratio|_pack_\w+"
              r"|_overload_ladder_transitions)$")


def run_cli(argv, path):
    """``serve_events.main(argv)`` with its JSONL trail at ``path`` and its
    report captured; returns what phase 6d reads from one run."""
    import contextlib
    import io
    import re
    from repro_torch.launch import serve_events
    from repro_torch.obs import read_jsonl
    path.unlink(missing_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dt, lat = serve_events.main([*argv, "--metrics-out", str(path)])
    lines = buf.getvalue().splitlines()
    records = read_jsonl(path)
    served = [int(m.group(1)) for m in map(re.compile(SERVED).match, lines)
              if m]
    lanes = [m.groups() for m in map(re.compile(CLI_LANE).match, lines) if m]
    if len(served) != 1 or not records or not lanes:
        raise AssertionError(f"malformed CLI report for {argv}")
    return dict(dt=dt, lat=lat, events=served[0], records=records,
                lanes=lanes,
                log=[ln for ln in lines if re.match(CLI_EVENT, ln)],
                compiled=[ln for ln in lines
                          if ln.startswith("compiled executors")])


def same_cli_runs(got, want, what):
    """Two CLI runs: equal records apart from wall clocks, equal log lines,
    lane reports and executors."""
    from repro_torch.obs.schema import steady_record
    for key in ("log", "lanes", "compiled"):
        if got[key] != want[key]:
            raise AssertionError(f"{what}: {key} differ: {got[key]} vs "
                                 f"{want[key]}")
    if [steady_record(r) for r in got["records"]] != \
            [steady_record(r) for r in want["records"]]:
        raise AssertionError(f"{what}: metrics records differ")


def cli_phase(smi, *, device, sessions=16, duration_us=200_000,
              backend_sessions=4, hold_sessions=4, hold_us=20_000):
    """Phase 6d: ``serve_events.main`` on ``device`` at the DAVIS240
    sensor, ``--dvfs``: every run of ``CLI_RUNS`` at ``sessions`` sessions
    (the backend runs at ``backend_sessions``) over ``duration_us``, then
    each again at ``hold_sessions`` x ``hold_us`` on ``device`` and on the
    CPU, held equal.  Returns the launch counts of the full runs.  Smaller
    arguments rehearse it on the CPU."""
    import numpy as np
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "metrics.jsonl"
    common = ["--dvfs", "--device", device]
    # warm-up: first launches load the kernels and the pinned allocator
    run_cli([*common, "--sessions", "2", "--duration-us", "6000"], path)
    totals = {k: 0 for k in ops.LAUNCHES}
    for name, flags in CLI_RUNS:
        n = backend_sessions if name in CLI_BACKEND_RUNS else sessions
        ops.reset_launch_counts()
        r = run_cli([*common, *flags, "--sessions", str(n), "--duration-us",
                     str(duration_us)], path)
        launches = dict(ops.LAUNCHES)
        for k in totals:
            totals[k] += launches[k]
        rec = r["records"][-1]
        met, sched = rec["metrics"], rec.get("scheduler", {})
        rounds, fetches = met["rounds_executed"], met["host_fetches"]
        backend = flags[flags.index("--backend") + 1] \
            if "--backend" in flags else "fused"
        if device != "cpu":
            step = {"fused": "fused_step", "nmc": "nmc",
                    "batched": "batched"}[backend]
            if min(launches[step], launches["harris"]) <= 0:
                raise AssertionError(f"[cli] {name}: a kernel was not "
                                     f"launched: {launches}")
            if launches["compact"] != rounds:
                raise AssertionError(
                    f"[cli] {name}: {launches['compact']} K3 pushes for "
                    f"{rounds} rounds")
        lat = r["lat"]
        print(f"[cli] {smi}: {name} ({backend}) x{n} sessions, "
              f"{duration_us} us: {r['events']} events in {r['dt']:.3f} s = "
              f"{r['events'] / r['dt'] / 1e3:.1f} kev/s; serving round p50 "
              f"{np.percentile(lat, 50):.3f} p99 {np.percentile(lat, 99):.3f}"
              f" ms over {len(lat)}; {rounds} pool rounds (wall "
              f"{r['dt'] / rounds * 1e3:.3f} ms per pool round) / {fetches} "
              f"fetches = {rounds / max(fetches, 1):.2f} rounds per fetch; D2H "
              f"{met['d2h_bytes'] / 1e6:.3f} MB; migrations "
              f"{met['migrations_total']}, ladder transitions "
              f"{sched.get('ladder_transitions', 0)} (level "
              f"{sched.get('ladder_level', 0)}/"
              f"{sched.get('ladder_max_level', 0)} at exit), pack moves "
              f"{sched.get('pack_moves', 0)}; launches K1 "
              f"{launches['fused_step']} K2 {launches['harris']} K3 "
              f"{launches['compact']} K4 {launches['nmc']} K5 "
              f"{launches['batched']}; {len(r['log'])} log lines")
        for line in r["log"][:6]:
            print(f"[cli]   {line.strip()}")
    for name, flags in CLI_RUNS:
        argv = [*flags, "--dvfs", "--sessions", str(hold_sessions),
                "--duration-us", str(hold_us)]
        got = run_cli([*argv, "--device", device], path)
        want = run_cli([*argv, "--device", "cpu"], path)
        same_cli_runs(got, want, f"[cli] {name}")
        print(f"[cli] {name} x{hold_sessions} sessions, {hold_us} us: "
              f"{device} = CPU (records apart from wall clocks, "
              f"{len(got['log'])} log lines, lanes {got['lanes']}, "
              f"executors)")
    print(f"[cli] launches on the CLI paths: {totals}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def quickstart_phase(smi, *, device):
    """The quickstart on ``device`` against the same run on the CPU: every
    printed line equal but PR-AUC's, PR-AUC within 1e-3.  Returns the
    launch counts of the ``device`` run."""
    import contextlib
    import io
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    out = {}
    for dev in (device, "cpu"):
        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = quickstart.main(dev)
        out[dev] = (res, buf.getvalue().splitlines(),
                    time.perf_counter() - t0, dict(ops.LAUNCHES))
    (got, lines, wall, launches), (want, want_lines, _, _) = \
        out[device], out["cpu"]
    if [ln for ln in lines if not ln.startswith("PR-AUC")] != \
            [ln for ln in want_lines if not ln.startswith("PR-AUC")] or \
            abs(got["pr_auc"] - want["pr_auc"]) > 1e-3:
        raise AssertionError(f"[quickstart] {device} differs from the CPU: "
                             f"{lines} vs {want_lines}")
    print(f"[quickstart] {smi}: {device} run {wall:.3f} s, lines equal to "
          f"the CPU run, PR-AUC {got['pr_auc']:.6f} (CPU "
          f"{want['pr_auc']:.6f}); launches {launches}")
    if device != "cpu" and min(launches["fused_step"],
                               launches["harris"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def _baseline_rows(module, name="BENCH_smoke_baseline.json"):
    """The reference's rows of ``module`` in ``benchmarks/<name>``."""
    rows = json.loads((ROOT / "benchmarks" / name).read_text())["rows"]
    return {k: v for k, v in rows.items() if v["module"] == module}


def _compare_full(tag, rows, module, structural):
    """Hold the full-size rows that ``structural`` picks equal to the
    reference's full-size run (``benchmarks/BENCH_serving.json``)."""
    base = _baseline_rows(module, "BENCH_serving.json")
    picked = {n: v for n, _, v in rows if structural(n) and n in base}
    differ = {n: (v, base[n]["derived"]) for n, v in picked.items()
              if v != base[n]["derived"]}
    if differ or not picked:
        raise AssertionError(f"{tag} full-size rows differ from "
                             f"benchmarks/BENCH_serving.json (port, "
                             f"reference): {differ}")
    print(f"{tag} full size: {len(picked)} structural rows equal to "
          f"benchmarks/BENCH_serving.json (the reference's full-size run)")


def scenarios_phase(smi, *, device, full=True):
    """Phase 6e: the fleet scenarios on ``device``: ``rows(smoke=True)``
    equal to the smoke baseline in every row but the ``p99`` ones, then
    each scenario at full size, timed.  Returns the launch counts."""
    from repro_torch.benchmarks import scenarios
    from repro_torch.kernels import ops
    base = _baseline_rows("scenarios(slo)")
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    rows = scenarios.rows(smoke=True, device=device)
    if {n for n, _, _ in rows} != set(base):
        raise AssertionError("[scenarios] row names differ from the "
                             "baseline's")
    for name, _, value in rows:
        if "_p99_" not in name and value != base[name]["derived"]:
            raise AssertionError(f"[scenarios] {name}: {value} vs the "
                                 f"baseline's {base[name]['derived']}")
    print(f"[scenarios] smoke on {device}: {len(rows)} rows, every non-p99 "
          f"row equal to benchmarks/BENCH_smoke_baseline.json")
    if full:
        full_rows = []
        for name in scenarios.SCENARIOS:
            t0 = time.perf_counter()
            got = scenarios.rows(device=device, only=[name])
            wall = time.perf_counter() - t0
            full_rows += got
            print(f"[scenarios] {smi}: {name} full size {wall:.3f} s: " +
                  ", ".join(f"{n.split('_slo_')[1]} {v:.10g}"
                            for n, _, v in got))
        _compare_full("[scenarios]", full_rows, "scenarios(slo)",
                      lambda n: "_p99_" not in n)
    launches = dict(ops.LAUNCHES)
    print(f"[scenarios] launches: {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    if device != "cpu" and min(launches[k] for k in (
            "fused_step", "harris", "compact")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def bench_streaming_phase(smi, *, device, full=True):
    """Phase 6f: the serving bench on ``device``: ``rows(smoke=True)`` with
    the baseline's row names (the fused-stream rows measured instead of
    ``_skipped`` on the card) and every structural row equal to the
    baseline's, then the full-size rows.  Returns the launch counts."""
    import re
    from repro_torch.benchmarks import bench_streaming
    from repro_torch.kernels import ops
    structural = re.compile(STRUCTURAL).search
    base = _baseline_rows("streaming(serving)")
    on_card = device != "cpu"
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = bench_streaming.rows(smoke=True, device=device)
    wall = time.perf_counter() - t0
    names = {n if not (on_card and n.startswith("stream_fused_")) else
             n + "_skipped" for n, _, _ in rows}
    if names != set(base):
        raise AssertionError(f"[bench_streaming] row names differ from the "
                             f"baseline's: {sorted(names ^ set(base))}")
    n_struct = 0
    for name, _, value in rows:
        if structural(name):
            n_struct += 1
            if value != base[name]["derived"]:
                raise AssertionError(
                    f"[bench_streaming] {name}: {value} vs the baseline's "
                    f"{base[name]['derived']}")
    print(f"[bench_streaming] smoke on {device} ({wall:.1f} s): {len(rows)}"
          f" rows, {n_struct} structural rows equal to "
          f"benchmarks/BENCH_smoke_baseline.json")
    if full:
        t0 = time.perf_counter()
        full_rows = bench_streaming.rows(device=device)
        print(f"[bench_streaming] {smi}: full size on {device} in "
              f"{time.perf_counter() - t0:.1f} s (name,us_per_call,derived):")
        for name, us, value in full_rows:
            print(f"[bench_streaming]   {name},{us:.3f},{value:.10g}")
        _compare_full("[bench_streaming]", full_rows, "streaming(serving)",
                      structural)
    launches = dict(ops.LAUNCHES)
    print(f"[bench_streaming] launches: {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    if on_card and min(launches[k] for k in (
            "fused_step", "harris", "compact")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


# --- 6g-6i: the loader path, the end-to-end example and the paper benches.

def _far_stream(n_ok, n_far, chunk):
    """A stream whose last ``n_far`` events sit past int32 microseconds:
    ``n_ok // chunk`` chunks load, then the overflow guard raises."""
    import numpy as np

    class Far:
        xy = np.zeros((n_ok + n_far, 2), np.int32)
        ts = np.concatenate([np.arange(n_ok, dtype=np.int64),
                             np.full((n_far,), 2**32, np.int64)])

        def __len__(self):
            return n_ok + n_far
    return Far()


def loader_phase(smi, *, device, duration_us=80_000):
    """Phase 6g: ``PrefetchingLoader`` on ``device``: its chunks equal
    ``chunk_iterator``'s after the rebase; a worker error, raised after
    chunks were uploaded, reaches the consumer; ``close()`` on a
    half-consumed loader returns within 5 s with the worker dead; the
    overflow guard; then the device-slab feed of the shapes stream through
    ``StreamingDetector.feed_device_chunk`` against the host ``feed`` path
    (chunk-sized slabs), both equal to the batch scan: events/s of each,
    recorded, no claim.  Returns the launch counts of the two feeds."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.events import stream as stream_mod
    from repro_torch.events import synthetic
    from repro_torch.kernels import ops
    from repro_torch.serve import StreamingDetector, session_base_us
    t_phase = time.perf_counter()
    st = synthetic.shapes_stream(duration_us=duration_us, seed=0)
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2, dvfs=True,
                                  dvfs_online=True, device=device)
    # The chunk check runs on the stream moved past int32 microseconds.
    late = dataclasses.replace(st, ts=st.ts + 2**31 + 12_345)
    base = session_base_us(int(late.ts[0]), cfg)
    want = [(x, (t - base).astype(np.int32), v)
            for x, t, v in stream_mod.chunk_iterator(late, cfg.chunk)]
    with stream_mod.PrefetchingLoader(late, cfg.chunk, rebase_us=base,
                                      device=device) as loader:
        got = list(loader)
    if len(got) != len(want):
        raise AssertionError("[loader] chunk count differs")
    for (gx, gt, gv), (wx, wt, wv) in zip(got, want):
        if {t.device.type for t in (gx, gt, gv)} != {torch.device(
                device).type} or (gx.dtype, gt.dtype, gv.dtype) != (
                torch.int32, torch.int32, torch.bool):
            raise AssertionError("[loader] a chunk is on the wrong device "
                                 "or of the wrong dtype")
        for g, w in ((gx, wx), (gt, wt), (gv, wv)):
            if not np.array_equal(g.cpu().numpy(), w):
                raise AssertionError("[loader] a chunk differs from "
                                     "chunk_iterator's")
    print(f"[loader] {len(got)} chunks of {cfg.chunk} on {device} equal to "
          f"chunk_iterator's after the rebase by {base}")

    far = _far_stream(8, 4, 4)
    with stream_mod.PrefetchingLoader(far, 4, device=device) as loader:
        n_ok = 0
        try:
            for _ in loader:
                n_ok += 1
        except OverflowError as e:
            if "int32 after rebase" not in str(e) or n_ok != 2:
                raise AssertionError(f"[loader] overflow after {n_ok} "
                                     f"chunks: {e}") from e
        else:
            raise AssertionError("[loader] the overflow guard did not "
                                 "raise")
    with stream_mod.PrefetchingLoader(_far_stream(0, 4, 4), 4,
                                      rebase_us=2**32, device=device) as ld:
        if [t.tolist() for _, t, _ in ld] != [[0] * 4]:
            raise AssertionError("[loader] the rebased chunk differs")

    class Exploding:
        xy = np.zeros((10, 2), np.int32)
        ts = np.zeros((10,), np.int64)

        def __len__(self):
            raise RuntimeError("boom in worker")
    try:
        list(stream_mod.PrefetchingLoader(Exploding(), 4, device=device))
    except RuntimeError as e:
        if "boom in worker" not in str(e):
            raise
    else:
        raise AssertionError("[loader] a worker error was swallowed")

    half = stream_mod.PrefetchingLoader(st, 64, depth=1, device=device)
    next(half)
    next(half)
    t0 = time.perf_counter()
    half.close()
    t_close = time.perf_counter() - t0
    if t_close > 5.0 or half._thread.is_alive():
        raise AssertionError(f"[loader] close() took {t_close:.3f} s, "
                             f"worker alive: {half._thread.is_alive()}")
    print(f"[loader] a worker error after 2 uploaded chunks (overflow "
          f"guard) and one before (RuntimeError) re-raised on the consumer; "
          f"close() of a half-consumed loader {t_close * 1e3:.1f} ms, "
          f"worker dead")

    batch = pipeline.run_pipeline(st.xy, st.ts, cfg)
    base = session_base_us(int(st.ts[0]), cfg)

    def device_feed():
        det = StreamingDetector(cfg, base_ts=base)
        with stream_mod.PrefetchingLoader(st, cfg.chunk, device_slabs=True,
                                          rebase_us=base,
                                          device=device) as loader:
            parts = [det.feed_device_chunk(*c)[0] for c in loader]
        return np.concatenate(parts)

    def host_feed():
        det = StreamingDetector(cfg)
        parts = [det.feed(st.xy[i:i + cfg.chunk], st.ts[i:i + cfg.chunk])[0]
                 for i in range(0, len(st), cfg.chunk)]
        return np.concatenate(parts + [det.flush()[0]])

    device_feed(), host_feed()             # warm
    ops.reset_launch_counts()
    rates = {}
    for name, fn in (("device-slab", device_feed), ("host", host_feed),
                     ("device-slab", device_feed), ("host", host_feed)):
        t0 = time.perf_counter()
        scores = fn()
        dt = time.perf_counter() - t0
        if not np.array_equal(scores, batch.scores):
            raise AssertionError(f"[loader] the {name} feed differs from "
                                 f"the batch scan")
        rates.setdefault(name, []).append(len(st) / dt)
    launches = dict(ops.LAUNCHES)
    print(f"[loader] {smi}: {len(st)} events, chunk {cfg.chunk}, online "
          f"DVFS: device-slab feed (PrefetchingLoader + feed_device_chunk) "
          + ", ".join(f"{r:.0f}" for r in rates["device-slab"])
          + " events/s; host feed (chunk-sized slabs) "
          + ", ".join(f"{r:.0f}" for r in rates["host"])
          + " events/s (two runs each, in turns); both equal to the batch "
          f"scan; launches {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    if device != "cpu" and min(launches["fused_step"],
                               launches["harris"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def e2e_phase(smi, *, device, duration_us=80_000):
    """Phase 6h: the port's ``examples/corner_detection_e2e.main`` on
    ``device`` at the reference's size: its lines, and every flag (the
    scan against the oracle on ``nmc`` and the six serving flags of both
    datasets) ``True``; then the oracle once under ``batched`` against the
    scan, every output equal.  Returns the launch counts and the example's
    values."""
    import contextlib
    import io
    import numpy as np
    from repro_torch.core import pipeline
    from repro_torch.events import synthetic
    from repro_torch.examples import corner_detection_e2e as e2e
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = e2e.main(device, duration_us)
    for line in buf.getvalue().splitlines():
        print(f"[e2e] {line}")
    bad = [(name, flag) for name, r in res.items()
           for flag, ok in (("scan_vs_reference",
                             r["scan_vs_reference"]["bit_exact"]),
                            *r["flags"].items()) if ok is not True]
    if bad:
        raise AssertionError(f"[e2e] flags not True: {bad}")
    for name, r in res.items():
        print(f"[e2e] {smi}: {name} {r['n_events']} events: PR-AUC "
              f"error-free {r['auc_errorfree']:.6f}, 0.6 V with BER "
              f"{r['auc_low']:.6f} (dAUC {r['dauc']:+.6f}), energy "
              f"x{r['energy_ratio']:.3f} less; scan "
              f"{r['scan_vs_reference']['us_per_event_scan']:.3f} us/event "
              f"on {r['scan_vs_reference']['backend_scan']}, oracle "
              f"{r['scan_vs_reference']['us_per_event_reference']:.3f} on "
              f"{r['scan_vs_reference']['backend_reference']}; every flag "
              f"True")

    st = synthetic.shapes_stream(duration_us=duration_us, seed=0)
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                  device=device)
    scan = pipeline.run_pipeline(st.xy, st.ts, cfg)
    t0 = time.perf_counter()
    oracle = pipeline.run_pipeline_reference(
        st.xy, st.ts, dataclasses.replace(cfg, backend="batched"))
    t_oracle = time.perf_counter() - t0
    for f in ("scores", "kept", "tos", "lut", "vdd_trace"):
        if not np.array_equal(getattr(scan, f), getattr(oracle, f)):
            raise AssertionError(f"[e2e] the oracle on batched: {f} "
                                 f"differs from the scan")
    if (scan.energy_pj, scan.latency_ns_per_event) != (
            oracle.energy_pj, oracle.latency_ns_per_event):
        raise AssertionError("[e2e] the oracle's books differ")
    launches = dict(ops.LAUNCHES)
    print(f"[e2e] oracle on batched: {oracle.host_syncs} host syncs in "
          f"{t_oracle:.3f} s, every output equal to the scan on fused; "
          f"launches {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    if device != "cpu" and min(launches[k] for k in (
            "fused_step", "harris", "compact", "nmc", "batched")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches, res


FIG11_REFERENCE = ROOT / "tests" / "data" / "fig11_reference.json"


def paper_phase(smi, *, device):
    """Phase 6i: the paper benches at full size on ``device``, held to the
    reference's full-size rows (``benchmarks/BENCH_serving.json``): the
    hwmodel, dvfs and ``fig1b_*`` rows within 1e-12 relative, the
    pipeline rows' host syncs 94 / 1, the Fig. 11 rows within 1e-3 (AUC)
    and 2e-3 (delta) of the reference's under the installed jax
    (``tests/data/fig11_reference.json``; the committed baselines' BER rows
    were drawn with the older, non-partitionable threefry) and the
    error-free ones of ``BENCH_serving.json`` too; the one-hot TOS update
    bit-equal to ``tos_update_batched`` on ``device`` at
    ``bench_throughput``'s inputs.  Wall-time rows are printed.  Returns
    the launch counts."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import (bench_auc, bench_dvfs, bench_hwmodel,
                                        bench_throughput)
    from repro_torch.core import tos
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    fig11 = json.loads(FIG11_REFERENCE.read_text())["full"]
    for label, mod in (("hwmodel(fig9,fig10)", bench_hwmodel),
                       ("throughput(fig1b,fig10d)", bench_throughput),
                       ("dvfs(tableI,fig8)", bench_dvfs),
                       ("auc(fig11)", bench_auc)):
        base = {k: v["derived"] for k, v in
                _baseline_rows(label, "BENCH_serving.json").items()}
        t0 = time.perf_counter()
        rows = mod.rows(device=device)
        wall = time.perf_counter() - t0
        if {n for n, _, _ in rows} != set(base):
            raise AssertionError(f"[paper] {label}: row names differ")
        held = set()
        for name, us, value in rows:
            want = base[name]
            held.add(name)
            if label.startswith(("hwmodel", "dvfs")) or \
                    name.startswith("fig1b_"):
                ok = abs(value - want) <= 1e-12 * max(abs(want), 1e-300)
            elif name.endswith("_host_syncs"):
                ok = value == want == {"pipeline_ref_host_syncs": 94.0,
                                       "pipeline_scan_host_syncs": 1.0}[name]
            elif name.startswith("fig11_"):
                tol = 2e-3 if "_delta_" in name else 1e-3
                ok = abs(value - fig11[name]) <= tol and (
                    "errorfree" not in name or abs(value - want) <= tol)
            else:
                held.discard(name)
                ok = np.isfinite(value) and value > 0   # wall time
            if not ok:
                raise AssertionError(f"[paper] {name}: {value!r} (reference "
                                     f"{want!r}, fig11 file "
                                     f"{fig11.get(name)!r})")
        print(f"[paper] {smi}: {label} full size on {device} in {wall:.1f} s "
              f"(name,us_per_call,derived; reference in brackets):")
        for name, us, value in rows:
            ref = (f" [{fig11.get(name, base[name]):.10g}]" if name in held
                   else "")
            print(f"[paper]   {name},{us:.3f},{value:.10g}{ref}")

    rng = np.random.default_rng(0)
    h, w, e = 180, 240, 1024
    xy = torch.as_tensor(
        np.stack([rng.integers(0, w, e), rng.integers(0, h, e)], 1),
        dtype=torch.int32, device=device)
    valid = torch.ones((e,), dtype=torch.bool, device=device)
    busy = torch.as_tensor(np.where(rng.random((h, w)) < 0.5,
                                    rng.integers(200, 256, (h, w)), 0),
                           dtype=torch.uint8, device=device)
    for name, surf in (("blank", tos.tos_new(h, w, device=device)),
                       ("busy", busy)):
        one = tos.tos_update_batched_onehot(surf, xy, valid)
        if not torch.equal(one, tos.tos_update_batched(surf, xy, valid)):
            raise AssertionError(f"[paper] the one-hot update differs on "
                                 f"the {name} surface")
    launches = dict(ops.LAUNCHES)
    print(f"[paper] one-hot TOS update bit-equal to tos_update_batched on "
          f"{device} at 180x240, E=1024 (blank and busy surfaces; "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}); launches "
          f"{launches}; phase took {time.perf_counter() - t_phase:.1f} s")
    if device != "cpu" and min(launches[k] for k in (
            "fused_step", "harris", "nmc")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


# --- 6j-6l: the TOS-kernel cost model, the regression gate, M10.

def tos_kernels_phase(smi, *, device):
    """Phase 6j: the TOS-kernel cost model (``repro_torch.benchmarks.
    bench_tos_kernels``) at full size on ``device``: its rows with the
    reference's names, the bin rows, unfused bytes and round-trip rows
    equal to the reference's full-size run
    (``benchmarks/BENCH_serving.json``), and on the card the measured
    device time of K4, K6, K5 and K1 beside each kernel's bound; K1 one op
    call per chunk of the fold (the gated row), and, from the profiler, two
    kernel launches per chunk.  Returns the launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks import bench_tos_kernels as btk
    from repro_torch.core import pipeline
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    details = {}
    rows = btk.rows(device=device, details=details)
    launches = dict(ops.LAUNCHES)
    base = _baseline_rows("tos_kernels(perf)", "BENCH_serving.json")
    names = [n for n, _, _ in rows]
    if len(names) != len(base) or set(names) != set(base):
        raise AssertionError("[tos_kernels] row names differ from the "
                             "reference's")
    held = 0
    for name, us, value in rows:
        if name.endswith(("_bin_mean_frac", "_bin_max_frac",
                          "_unfused_hbm_bytes_per_chunk",
                          "_roundtrips_per_chunk")):
            held += 1
            if value != base[name]["derived"]:
                raise AssertionError(f"[tos_kernels] {name}: {value} vs the "
                                     f"reference's {base[name]['derived']}")
    print(f"[tos_kernels] {smi}: {len(rows)} rows on {device} "
          f"(name,us_per_call,derived), {held} bin / unfused-byte / "
          f"round-trip rows equal to the reference's:")
    for name, us, value in rows:
        print(f"[tos_kernels]   {name},{us:.3f},{value:.10g}")
    on_card = device != "cpu"
    for (h, w, e), d in details.items():
        if d["k1_calls_per_chunk"] != 1.0:
            raise AssertionError(f"[tos_kernels] {h}x{w}: "
                                 f"{d['k1_calls_per_chunk']} K1 calls per "
                                 f"chunk")
        kernels = "not measured"
        if on_card:
            cfg = pipeline.PipelineConfig(height=h, width=w, chunk=e,
                                          device=device)
            st = btk._stream(h, w)
            pipeline.run_pipeline(st.xy, st.ts, cfg)          # warm
            n = d["n_chunks"]
            seen = []
            # The profiler now and then drops a kernel record at a window's
            # edges, so empty kernels stand there; a window that holds each
            # K1 kernel once per chunk settles the count.
            for _ in range(5):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda._sleep(0)
                    torch.cuda.synchronize()
                    pipeline.run_pipeline(st.xy, st.ts, cfg)
                    torch.cuda._sleep(0)
                    torch.cuda.synchronize()
                counts = {k: sum(r.count for r in prof.key_averages()
                                 if k in r.key) for k in K1_KERNELS}
                seen.append(counts)
                if max(counts.values()) > n:
                    raise AssertionError(f"[tos_kernels] K1 kernels: "
                                         f"{counts} over {n} chunks")
                if set(counts.values()) == {n}:
                    break
            if not all(any(c[k] for c in seen) for k in K1_KERNELS):
                raise AssertionError(f"[tos_kernels] a K1 kernel never "
                                     f"ran: {seen}")
            per = sum(seen[-1].values()) / n
            kernels = (f"{per:g} ({seen[-1]})" if per == 2.0 else
                       f"not measured (the profiler dropped records in "
                       f"every window: {seen})")
        print(f"[tos_kernels] {h}x{w} E={e}: K1 op calls per chunk "
              f"{d['k1_calls_per_chunk']:g} over {d['n_chunks']} chunks "
              f"(fused_roundtrips_per_chunk); K1 kernel launches per chunk "
              f"{kernels}; launch floor {d['t_launch_s'] * 1e6:.3f} us")
        for name, m in (d["measured"] or {}).items():
            print(f"[tos_kernels] {smi}: {h}x{w} E={e} {name} "
                  f"{m['ms'] * 1e3:.3f} us device per call; bound "
                  f"{m['bound'][0] * 1e3:.4f} us by {m['bound'][1]}")
    print(f"[tos_kernels] launches: {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    if on_card and min(launches["fused_step"], launches["harris"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


GATE_BASELINE = "benchmarks/BENCH_smoke_baseline.json"


def gate_phase(smi, *, device):
    """Phase 6k: the port runner's regression gate, as the reference's CI
    runs it: ``python -m repro_torch.benchmarks.run --smoke
    --check-regression benchmarks/BENCH_smoke_baseline.json`` in its own
    process, on ``device``; it must exit 0, with every gated baseline row
    checked (none missing or skipped) and no regression."""
    import os
    from repro_torch.benchmarks import run
    t_phase = time.perf_counter()
    rows = json.loads((ROOT / GATE_BASELINE).read_text())["rows"]
    gated = sorted(n for n, r in rows.items() if not r.get("skipped")
                   and r["derived"] > 0 and any(
                       n.endswith(s) for s, _ in run._GATE_STRUCTURAL
                       + run._GATE_TIME))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--smoke",
         "--device", device, "--check-regression", GATE_BASELINE],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    got = dict(line.split(",")[::2] for line in out.stdout.splitlines()[1:]
               if line.count(",") == 2)
    for line in out.stderr.splitlines():
        if line.startswith(("# gate", "# REGRESSION")) or "done in" in line:
            print(f"[gate] {line}")
    summary = f"# gate: {len(gated)} row(s) checked against " \
              f"{GATE_BASELINE}, 0 regression(s)"
    if out.returncode != 0 or summary not in out.stderr:
        print(out.stderr[-4000:])
        raise AssertionError(f"[gate] the runner exited {out.returncode}; "
                             f"wanted '{summary}'")
    print(f"[gate] {smi}: {len(gated)} gated rows (" + ", ".join(
        f"{n} {got.get(n, 'missing')} [{rows[n]['derived']:.6g}]"
        for n in gated if "p99" in n or "roundtrips" in n)
        + f"); exit 0; phase took {time.perf_counter() - t_phase:.1f} s")


def baseline_scores(st, fn, device, chunk=512):
    """Scores of every event of ``st`` by a baseline detector ``fn``: per
    chunk, the SAE holds the newest timestamp of every event up to the
    chunk's end, and the chunk's events are scored against it."""
    import numpy as np
    import torch
    from repro_torch.core.stcf import NEVER
    h, w = st.height, st.width
    sae = torch.full((h * w,), NEVER, dtype=torch.int32, device=device)
    out = []
    for i in range(0, len(st), chunk):
        xy = torch.as_tensor(st.xy[i:i + chunk].astype(np.int32),
                             device=device)
        ts = torch.as_tensor(st.ts[i:i + chunk].astype(np.int32),
                             device=device)
        flat = xy[:, 1].long() * w + xy[:, 0].long()
        sae = sae.scatter_reduce(0, flat, ts, reduce="amax")
        valid = torch.ones((len(ts),), dtype=torch.bool, device=device)
        out.append(fn(sae.view(h, w), xy, ts, valid))
    return torch.cat(out).cpu().numpy()


def m10_phase(smi, *, device, nmc_auc=None, duration_us=80_000):
    """Phase 6l: the rest of the core on ``device`` against the CPU: evFAST
    and evARC equal, eHarris within ``REL * max|score|`` over the 80 ms
    shapes_dof stream (``baseline_scores``), with each one's PR-AUC and
    us/event beside NMC-TOS's (``[e2e]``); ``TosStream.update`` through
    ``ops.tos_update_op`` in every mode (K4-K7) equal to the plain closed
    form over the stream; ``stcf_sequential`` equal to ``stcf_chunked``
    and to the CPU; BER draws (``corrupt_surface`` at 0.6-0.62 V,
    ``inject_write_errors``) and ``corner_lut`` as on the CPU.  Returns
    the launch counts."""
    import functools
    import numpy as np
    import torch
    from repro_torch.core import baselines, ber, harris, pr_eval, prng
    from repro_torch.core import stcf, tos
    from repro_torch.events import aer, synthetic
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    st = synthetic.shapes_stream(duration_us=duration_us, seed=0)
    parts = []
    for name in ("fast_scores", "arc_scores", "eharris_scores"):
        fn = getattr(baselines, name)
        baseline_scores(st, fn, device)                       # warm
        sync(device)
        t0 = time.perf_counter()
        got = baseline_scores(st, fn, device)
        dt = time.perf_counter() - t0
        want = baseline_scores(st, fn, "cpu")
        if name == "eharris_scores":
            err = close(got, want)
        elif not np.array_equal(got, want):
            raise AssertionError(f"[m10] {name} on {device} differs from "
                                 f"the CPU")
        else:
            err = 0.0
        auc = pr_eval.pr_auc(got, st.is_corner)
        parts.append(f"{name.split('_')[0]} PR-AUC {auc:.6f} at "
                     f"{dt / len(st) * 1e6:.3f} us/event (max|delta| "
                     f"{err:.3g} to the CPU)")
    nmc = "" if nmc_auc is None else f"; NMC-TOS [e2e] {nmc_auc:.6f}"
    print(f"[m10] {smi}: shapes_dof {duration_us // 1000} ms, "
          f"{len(st)} events, chunk 512: " + "; ".join(parts) + nmc)

    ops.reset_launch_counts()
    chunks = [(torch.as_tensor(st.xy[i:i + 512].astype(np.int32),
                               device=device),
               torch.ones((len(st.xy[i:i + 512]),), dtype=torch.bool,
                          device=device)) for i in range(0, len(st), 512)]
    plain = tos.TosStream.init(st.height, st.width, device=device)
    for xy, valid in chunks:
        plain = plain.update(xy, valid)
    for mode in ops.TOS_MODES:
        s = tos.TosStream.init(st.height, st.width, device=device)
        fn = functools.partial(ops.tos_update_op, mode=mode)
        for xy, valid in chunks:
            s = s.update(xy, valid, update_fn=fn)
        if not torch.equal(s.surface, plain.surface):
            raise AssertionError(f"[m10] TosStream through {mode} differs")
    if not bool(tos.tos_invariant_ok(plain.surface)):
        raise AssertionError("[m10] the folded surface breaks the invariant")
    launches = dict(ops.LAUNCHES)

    rng = np.random.default_rng(10)
    sae0 = np.full((st.height, st.width), stcf.NEVER, np.int32)
    np.maximum.at(sae0, (st.xy[:4000, 1], st.xy[:4000, 0]),
                  st.ts[:4000].astype(np.int32))
    ev = [st.xy[4000:4512].astype(np.int32), st.ts[4000:4512].astype(
        np.int32), rng.random(512) < 0.9]
    res = {}
    for d in (device, "cpu"):
        args = [torch.as_tensor(a, device=d) for a in (sae0, *ev)]
        res[d] = (stcf.stcf_sequential(*args), stcf.stcf_chunked(*args))
    for (s1, k1), (s2, k2) in (res[device], (res[device][0], res["cpu"][0])):
        if not (torch.equal(s1.cpu(), s2.cpu()) and
                torch.equal(k1.cpu(), k2.cpu())):
            raise AssertionError("[m10] stcf_sequential differs")

    surf = np.where(rng.random((st.height, st.width)) < 0.5,
                    rng.integers(225, 256, (st.height, st.width)),
                    0).astype(np.uint8)
    n_ber = 0
    for vdd in (0.6, 0.605, 0.61, 0.62):
        outs = [ber.corrupt_surface(prng.prng_key(7, device=d),
                                    torch.as_tensor(surf, device=d),
                                    vdd).cpu() for d in (device, "cpu")]
        n_ber += int((outs[0].numpy() != surf).sum())
        if not torch.equal(*outs):
            raise AssertionError(f"[m10] BER draws at {vdd} V differ")
    outs = [ber.inject_write_errors(prng.prng_key(8, device=d),
                                    torch.as_tensor(surf, device=d),
                                    0.025).cpu() for d in (device, "cpu")]
    if not torch.equal(*outs):
        raise AssertionError("[m10] inject_write_errors draws differ")
    lut_err = close(harris.corner_lut(torch.as_tensor(surf, device=device))
                    .cpu().numpy(),
                    harris.corner_lut(torch.as_tensor(surf)).numpy())
    words = aer.pack(st.xy, np.where(st.is_corner, 1, -1))
    if not np.array_equal(aer.unpack(words)[0], st.xy):
        raise AssertionError("[m10] the AER round trip differs")
    print(f"[m10] TosStream through K4-K7 (tos_update_op modes "
          f"{list(ops.TOS_MODES)}) equal to the plain closed form over "
          f"{len(chunks)} chunks; stcf_sequential equal to stcf_chunked and "
          f"to the CPU; BER draws at 0.6-0.62 V ({n_ber} corrupted pixels) "
          f"and at 0.025 equal to the CPU; corner_lut max|delta| "
          f"{lut_err:.3g} to the CPU; AER round trip; launches {launches}; "
          f"phase took {time.perf_counter() - t_phase:.1f} s")
    if device != "cpu" and min(launches[m] for m in ops.TOS_MODES) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


# --- 1b: the LM scaffold's serving path (M11a) -------------------------
# No kernel of the port lies on this path: it is torch's own matmuls and
# elementwise ops, held card against host.

# Depth cuts of phase 1b's per-family check at full width ("enc": the
# encoder's).  Zamba2 keeps 6 layers so that one shared-attention site
# (every 6th layer) is on the path.
LM_DEPTH = {"qwen2_5_3b": {"n_layers": 2}, "granite_20b": {"n_layers": 2},
            "stablelm_3b": {"n_layers": 2}, "olmoe_1b_7b": {"n_layers": 2},
            "phi_3_vision_4_2b": {"n_layers": 2},
            "whisper_tiny": {"n_layers": 2, "n_enc_layers": 2},
            "mamba2_370m": {"n_layers": 2}, "zamba2_1_2b": {"n_layers": 6}}
LM_F32 = 1e-4      # float32, card vs host: max|delta| <= LM_F32*max(1, max|cpu|)
LM_BF16 = 5e-2     # bf16, card vs host: max|delta| <= LM_BF16 * max|cpu|


def _lm_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _lm_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _lm_leaves(v)]
    return [tree]


def _lm_err(got, want, bound, scale_floor, what):
    """max |got - want| over two trees; raises above ``bound`` times
    ``max(scale_floor, max|want|)``."""
    err = scale = 0.0
    for g, w in zip(_lm_leaves(got), _lm_leaves(want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        g, w = g.detach().float().cpu(), w.detach().float()
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: non-finite values on the card")
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    if err > bound * max(scale_floor, scale):
        raise AssertionError(f"{what}: max |delta| {err:.3g} > {bound} * "
                             f"{max(scale_floor, scale):.3g}")
    return err, scale


def _lm_model(cfg, dev, seed=0):
    """Random weights on ``dev`` and their copy on the host."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    return params, tree_map(lambda a: a.cpu(), params)


def _lm_decode(cfg, params, dev, b, length, steps, toks, forced=None):
    """``steps`` decode steps from ``zeros_cache``; the next tokens are the
    argmax of each step, or ``forced``'s.  Returns logits per step, the
    last cache and the tokens fed."""
    import torch
    from repro_torch.models import transformer as T
    cache = T.zeros_cache(cfg, b, length, dev)
    t = toks.to(dev)
    logits, fed = [], [t.cpu()]
    for pos in range(steps):
        lg, cache = T.forward_decode(params, t, cache, pos, cfg)
        logits.append(lg)
        t = (lg[:, -1].float().argmax(-1)[:, None].to(torch.int32)
             if forced is None else forced[pos + 1].to(dev))
        fed.append(t.cpu())
    return logits, cache, fed


def _lm_prefill_decode(cfg, params, dev, batch, steps, forced=None):
    """``forward_prefill_cache`` on ``batch`` handed to ``steps`` decode
    steps; each next token is the argmax of the last logits, or
    ``forced``'s.  Returns the logits of each call and the tokens fed."""
    import torch
    from repro_torch.models import transformer as T
    lg, cache, pos = T.forward_prefill_cache(
        params, {k: v.to(dev) for k, v in batch.items()}, cfg,
        batch["tokens"].shape[1] + steps)
    logits, fed = [lg.cpu()], []
    for i in range(steps):
        toks = (lg[:, -1].float().argmax(-1)[:, None].to(torch.int32)
                if forced is None else forced[i].to(dev))
        fed.append(toks.cpu())
        lg, cache = T.forward_decode(params, toks, cache, pos + i, cfg)
        logits.append(lg.cpu())
    return logits, fed


def lm_phase(smi, *, device="cuda", full=True):
    """Phase 1b ``[lm]``: the LM scaffold's serving path on ``device``
    against the host.  ``full=False`` runs the smoke configs (a rehearsal
    on the CPU)."""
    import contextlib
    import dataclasses
    import io
    import re
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.train.train_step import make_serve_step

    dev = torch.device(device)
    t_phase = time.perf_counter()
    get = configs.get if full else configs.get_smoke
    switches = {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "matmul.allow_fp16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
        "float32_matmul_precision": torch.get_float32_matmul_precision()}
    print(f"[lm] {smi}: precision switches {switches}")
    if switches["matmul.allow_tf32"] or \
            switches["float32_matmul_precision"] != "highest":
        raise AssertionError("TF32 must stay off for the float32 checks")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- 1. the serve CLI at qwen2-0.5b, as a user runs it -------------
    arch = "qwen2-0.5b"
    cfg = get(arch)
    base = ["--arch", arch, "--device", str(dev.type)] + \
        ([] if full else ["--smoke"])
    runs = {"greedy": [], "kv-quant": ["--kv-quant"],
            "temperature 0.8": ["--temperature", "0.8"]}
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(base + ["--steps", "2"])                   # warm-up
    out = {}
    for name, flags in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            seqs = serve.main(base + flags)
        first = buf.getvalue().splitlines()[0]
        m = re.match(r"decoded (\d+) steps x batch (\d+) in ([\d.]+)s "
                     r"\(([\d.]+) tok/s\)", first)
        if m is None or seqs.shape != (4, 33) or seqs.min() < 0 or \
                seqs.max() >= cfg.vocab:
            raise AssertionError(f"[lm] CLI {name}: {first!r}, seqs "
                                 f"{seqs.shape}")
        out[name] = seqs
        print(f"[lm] {smi}: serve CLI {arch}{'' if full else ' (smoke)'} "
              f"{name}: {first}; {float(m.group(3)) / 32 * 1e3:.3f} ms per "
              f"step (host clock, 32 steps x batch 4, cache 128)")
    with contextlib.redirect_stdout(io.StringIO()):
        again = serve.main(base)
    if not np.array_equal(again, out["greedy"]):
        raise AssertionError("[lm] two greedy CLI runs on the card differ")

    # launches per decode step: the profiler's device records
    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    for kv_quant in (False, True):
        c = dataclasses.replace(cfg, kv_quant=kv_quant)
        step = make_serve_step(c)
        cache = T.zeros_cache(c, 4, 128, dev)
        toks = torch.ones((4, 1), dtype=torch.int32, device=dev)
        key = prng.prng_key(1, device=dev)
        for pos in range(3):
            toks, _, cache = step(params, toks, cache, pos, key)
        sync()
        n = 8
        if dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for pos in range(3, 3 + n):
                    toks, _, cache = step(params, toks, cache, pos, key)
                sync()
            rows = device_rows(prof)
            launches = sum(r.count for r in rows) / n
            dev_ms = sum(r.self_device_time_total for r in rows) / 1e3 / n
        else:
            launches = dev_ms = float("nan")
        t0 = time.perf_counter()
        for pos in range(3 + n, 3 + 2 * n):
            toks, _, cache = step(params, toks, cache, pos, key)
        sync()
        wall = (time.perf_counter() - t0) / n * 1e3
        print(f"[lm] {smi}: {arch} greedy decode step, batch 4, cache 128"
              f"{', int8 KV' if kv_quant else ''}: {launches:.1f} kernel "
              f"and copy launches per step, device busy {dev_ms:.3f} ms, "
              f"wall {wall:.3f} ms per step (idle share "
              f"{1 - dev_ms / wall:.3f})")
    del params, cache

    # --- 2. prefill + decode at full width, card against host -----------
    # bf16 on both sides, and float32 on the same (upcast) weights: the
    # card's bf16 run may sit no farther from the host's float32 run than
    # the host's bf16 run does, plus LM_BF16 of the largest logit; the
    # card's float32 run within LM_F32 of the host's.
    f32 = dict(param_dtype=torch.float32, act_dtype=torch.float32)
    cfg32 = dataclasses.replace(cfg, **f32)
    params, host = _lm_model(cfg, dev)
    b, prompt, steps = 2, 64, 8
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, prompt)).astype(np.int32))}
    got = [_lm_prefill_decode(cfg, params, dev, batch, steps)
           for _ in range(2)]
    if not all(torch.equal(x, y) for x, y in zip(got[0][0], got[1][0])):
        raise AssertionError("[lm] two prefill+decode runs on the card differ")
    fed = got[0][1]              # the host is fed the card's greedy tokens
    host_bf = _lm_prefill_decode(cfg, host, "cpu", batch, steps, fed)[0]
    host = tree_map(lambda a: a.float(), host)
    truth = _lm_prefill_decode(cfg32, host, "cpu", batch, steps, fed)[0]
    params = tree_map(lambda a: a.float(), params)
    card32 = _lm_prefill_decode(cfg32, params, dev, batch, steps, fed)[0]
    err32, scale = _lm_err(card32, truth, LM_F32, 1.0, f"[lm] {arch} float32")
    e_card = _lm_err(got[0][0], truth, float("inf"), 0.0, "")[0]
    e_host = _lm_err(host_bf, truth, float("inf"), 0.0, "")[0]
    if e_card > e_host + LM_BF16 * scale:
        raise AssertionError(f"[lm] {arch} bf16: card {e_card:.4g} from "
                             f"float32, host {e_host:.4g}, max|logit| "
                             f"{scale:.4g}")
    e_pair = _lm_err(got[0][0], host_bf, float("inf"), 0.0, "")[0]
    same = sum(int(torch.equal(g[:, -1].float().argmax(-1),
                               w[:, -1].float().argmax(-1)))
               for g, w in zip(got[0][0], host_bf))
    print(f"[lm] {smi}: {arch} prefill of {prompt} tokens x batch {b} "
          f"handed to {steps} greedy decode steps (the host fed the card's "
          f"tokens): bf16 max |delta| from the host's float32 run card "
          f"{e_card:.4g}, host {e_host:.4g} (bound host + {LM_BF16} * "
          f"{scale:.4g}), card vs host bf16 {e_pair:.4g}, greedy picks "
          f"equal in {same} of {steps + 1}; float32 card vs host "
          f"{err32:.3g} (bound {LM_F32} * max(1, max|logit|)); two card "
          f"bf16 runs bit-equal")
    del params, host

    # --- 3. every other family at full width, cut depth, float32 --------
    cuts = []
    for name in configs.ARCHS:
        if name == "qwen2_0_5b":
            continue
        smoke_only = name == "deepseek_v3_671b" or not full
        c = configs.get_smoke(name) if smoke_only else dataclasses.replace(
            configs.get(name), **LM_DEPTH[name])
        c = dataclasses.replace(c, **f32)
        t0 = time.perf_counter()
        p_dev, p_host = _lm_model(c, dev)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            1, c.vocab, (2, 1)).astype(np.int32))
        lg_d, cache_d, fed = _lm_decode(c, p_dev, dev, 2, 16, 4, toks)
        lg_h, cache_h, _ = _lm_decode(c, p_host, "cpu", 2, 16, 4, toks,
                                      forced=fed)
        err, scale = _lm_err(lg_d, lg_h, LM_F32, 1.0, f"[lm] {name}")
        cerr, _ = _lm_err(cache_d, cache_h, LM_F32, 1.0, f"[lm] {name} cache")
        depth = "smoke config" if smoke_only else ", ".join(
            f"{k} {v} of {getattr(configs.get(name), k)}"
            for k, v in LM_DEPTH[name].items())
        cuts.append(f"{name}: {depth}")
        if name == "deepseek_v3_671b" and full:
            depth += ("; at full width one layer of its experts is ~22 GB "
                      "of bf16, more than the host side of the check holds")
        print(f"[lm] {smi}: {name} float32 ({depth}"
              f"): 4 decode steps x batch 2, card vs host logits max |delta| "
              f"{err:.3g} (max|logit| {scale:.3g}), caches {cerr:.3g}, "
              f"bound {LM_F32} * max(1, max|cpu|); "
              f"{time.perf_counter() - t0:.1f} s")
        del p_dev, p_host, cache_d, cache_h

    # --- 4. the blockwise attention path at qwen2-0.5b width ------------
    seq = attn.BLOCKWISE_MIN_SEQ     # 2,048: the reference's switch
    c = dataclasses.replace(get(arch), n_layers=2, **f32)
    p_dev, p_host = _lm_model(c, dev)
    calls = []
    blockwise = attn._attend_blockwise_causal

    def counted(*a, **k):
        calls.append(a[0].device.type)
        return blockwise(*a, **k)

    attn._attend_blockwise_causal = counted
    try:
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            1, c.vocab, (1, seq)).astype(np.int32))
        got = T.forward_prefill(p_dev, {"tokens": tokens.to(dev)}, c)
        on_dev = list(calls)
        want = T.forward_prefill(p_host, {"tokens": tokens}, c)
    finally:
        attn._attend_blockwise_causal = blockwise
    if on_dev != [dev.type] * c.n_layers:
        raise AssertionError(f"[lm] blockwise attention ran {on_dev}")
    err, scale = _lm_err(got, want, LM_F32, 1.0, "[lm] blockwise")
    print(f"[lm] {smi}: {arch} width, {c.n_layers} layers of "
          f"{get(arch).n_layers}, float32, "
          f"forward_prefill of {seq} tokens through the blockwise attention "
          f"({c.n_layers} calls on the card, chunk "
          f"{attn.DEFAULT_ATTN_CHUNK}): card vs host max |delta| {err:.3g} "
          f"(max|logit| {scale:.3g}, bound {LM_F32} * max(1, max|cpu|))")
    del p_dev, p_host
    if dev.type == "cuda":
        torch.cuda.empty_cache()    # hand the weights' memory back
    print(f"[lm] {smi}: cut depths: qwen2_0_5b full depth ({cfg.n_layers} "
          f"layers); " + "; ".join(cuts)
          + f"; phase {time.perf_counter() - t_phase:.1f} s")


# --- 1c: the LM scaffold's training path (M11b) ------------------------
# No kernel of the port lies on this path either: autograd through the
# forward, per-leaf AdamW and the checkpoint writer, held card against
# host.  Bounds: those of the CPU tests (tests/_torch_lm_harness.py).
TRAIN_GRAD_LEAF = 1e-3     # per leaf: max|dg| <= 1e-3 * max|g_host(leaf)|
TRAIN_GRAD_TREE = 1e-6     #   + 1e-6 * max|g_host(tree)|
TRAIN_REL = 1e-4           # the loss, relative
TRAIN_GNORM = 1e-3         # grad_norm, relative (the per-leaf bound's scale)
TRAIN_CLOSE = 1e-5         # all but TRAIN_SHARE of the parameter elements
TRAIN_SHARE = 1e-3         # within TRAIN_CLOSE; every one within 2*lr+1e-6


def _train_grads_close(got, want, what):
    """The per-leaf gradient bound over two trees; returns the worst
    leaf's share of its bound."""
    got, want = _lm_leaves(got), _lm_leaves(want)
    top = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        g = g.detach().float().cpu()
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: non-finite gradients")
        bound = TRAIN_GRAD_LEAF * float(w.abs().max()) + TRAIN_GRAD_TREE * top
        err = float((g - w.float()).abs().max())
        if err > bound:
            raise AssertionError(f"{what}: max |dg| {err:.3g} > {bound:.3g}")
        worst = max(worst, err / bound)
    return worst


def train_phase(smi, *, device="cuda", full=True):
    """Phase 1c ``[train]``: the LM scaffold's training path on ``device``:
    the train CLI at qwen2-0.5b's width (batch 8, seq 256, 30 steps,
    checkpoints every 15, then a resumed call that takes no step), the
    microbatched and compressed CLI, the three remat settings, a profiled
    step, and one float32 step at full width, 2 layers, card against host.
    ``full=False`` runs the smoke config (a rehearsal on the CPU)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_grad_fn, make_train_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    arch = "qwen2-0.5b"
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    batch, seq, steps = 8, 256, 30

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak_reset():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else float("nan")

    # --- 1. the train CLI at full width, as a user runs it --------------
    record = {"dt": [], "loss": [], "snapshot": [], "write": []}

    class Recording(train_cli.TrainSupervisor):
        def run(self, *a, on_metrics, **k):
            def both(step, m):
                record["dt"].append(m["dt"])
                record["loss"].append(m["loss"])
                on_metrics(step, m)
            return super().run(*a, on_metrics=both, **k)

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                record[name].append(time.perf_counter() - t0)
        return wrapper

    saved = (train_cli.TrainSupervisor, ckpt.save_async, ckpt._write)
    train_cli.TrainSupervisor = Recording
    ckpt.save_async = timed("snapshot", ckpt.save_async)
    ckpt._write = timed("write", ckpt._write)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        base = ["--arch", arch, "--device", dev.type,
                "--batch", str(batch), "--seq", str(seq)] + \
            ([] if full else ["--smoke"])
        argv = base + ["--steps", str(steps), "--ckpt-every", "15",
                       "--ckpt-dir", f"{root}/cli"]
        sync()
        peak_reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            first = train_cli.main(argv)
        sync()
        wall = time.perf_counter() - t0
        mem = peak()
        dt, losses = record["dt"], record["loss"]
        if len(dt) != steps or not all(np.isfinite(losses)):
            raise AssertionError(f"[train] CLI: {len(dt)} steps, losses "
                                 f"{losses}")
        # the random-walk stream is a bigram task over 151,936 tokens: 30
        # steps leave the loss at ln(vocab) (PERF.md); the fall is held on
        # one fixed batch below
        head, tail = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        ms = float(np.median(dt[3:])) * 1e3
        # three writes: the async saves at 15 and 30, the final save at 30
        snap, writes = record["snapshot"], record["write"]
        if len(snap) != 2 or len(writes) != 3:
            raise AssertionError(f"[train] saves: {snap}, {writes}")
        size = sum(f.stat().st_size for f in
                   Path(root, "cli", f"step_{steps:09d}").iterdir())
        print(f"[train] {smi}: train CLI {arch}{'' if full else ' (smoke)'} "
              f"({cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab},"
              f" {str(cfg.param_dtype).split('.')[-1]}, remat {cfg.remat}),"
              f" batch {batch} x seq {seq}, {steps} steps: {ms:.2f} ms per "
              f"step (median of steps 4-{steps}, host clock; min "
              f"{min(dt[3:]) * 1e3:.2f}, max {max(dt[3:]) * 1e3:.2f}; first "
              f"step {dt[0] * 1e3:.1f}), {batch * seq / ms * 1e3:.0f} "
              f"tokens/s; peak memory {mem / 2**30:.3f} GiB "
              f"(max_memory_allocated); loss first-3 mean {head:.4f} -> "
              f"last-3 mean {tail:.4f}; whole call {wall:.1f} s")
        print(f"[train] {smi}: checkpoints of {size / 2**30:.3f} GiB: async "
              f"save host snapshot {snap[0]:.3f} / {snap[1]:.3f} s, its "
              f"write on the thread {writes[0]:.3f} / {writes[1]:.3f} s; "
              f"final save {writes[2]:.3f} s")
        for line in buf.getvalue().splitlines():
            print(f"[train]   | {line}")

        # resumed: the same directory, no step, the same parameters
        record["dt"].clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            again = train_cli.main(argv)
        if record["dt"] or out.getvalue():
            raise AssertionError(f"[train] the resumed call took "
                                 f"{len(record['dt'])} steps")
        diff = [i for i, (a, b) in enumerate(zip(_lm_leaves(again),
                                                 _lm_leaves(first)))
                if a.dtype != b.dtype or a.device != b.device
                or not torch.equal(a, b)]
        if diff:
            raise AssertionError(f"[train] resumed leaves {diff} differ")
        print(f"[train] {smi}: a second call on the same directory took "
              f"no step and returned parameters bit-equal to the first's "
              f"({time.perf_counter() - t0:.1f} s, restore and final save)")
        del first, again
        shutil.rmtree(f"{root}/cli")

        # --- 2. microbatches and compression ---------------------------
        record["dt"].clear()
        record["loss"].clear()
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(base + ["--steps", "4", "--microbatches", "2",
                                   "--compress-grads", "--ckpt-dir",
                                   f"{root}/mb"])
        if len(record["loss"]) != 4 or not all(np.isfinite(record["loss"])):
            raise AssertionError(f"[train] --microbatches 2 "
                                 f"--compress-grads: {record['loss']}")
        print(f"[train] {smi}: --microbatches 2 --compress-grads, 4 steps: "
              f"losses {[round(x, 4) for x in record['loss']]}, "
              f"{float(np.median(record['dt'][1:])) * 1e3:.2f} ms per step")
        shutil.rmtree(f"{root}/mb")
    finally:
        train_cli.TrainSupervisor, ckpt.save_async, ckpt._write = saved
        shutil.rmtree(root, ignore_errors=True)

    # --- 3. remat none / dots / full, one step each ---------------------
    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt = AdamWConfig(lr=3e-4, warmup_steps=min(20, steps // 10 + 1),
                      total_steps=steps)          # the CLI's schedule
    opt_state = adamw_init(params, opt)
    data = train_cli.synthetic_batch_fn(cfg, batch, seq, device=dev)(0)
    grads, stats = {}, {}
    settings = ("none", "dots", "full")
    for remat in settings:
        step = make_train_step(dataclasses.replace(cfg, remat=remat), opt)
        sync()
        peak_reset()
        t0 = time.perf_counter()
        out = step(params, opt_state, data)
        sync()
        stats[remat] = ((time.perf_counter() - t0) * 1e3, peak(),
                        float(out[2]["loss"]))
        del out, step
    for remat in settings:
        c = dataclasses.replace(cfg, remat=remat)
        grads[remat] = make_grad_fn(c)(params, data)[1]
    leaves = {r: _lm_leaves(g) for r, g in grads.items()}
    names = [k for k, _ in _lm_paths(grads["none"])]
    unequal = {r: [n for n, a, b in zip(names, leaves[r], leaves["none"])
                   if not torch.equal(a, b)] for r in ("dots", "full")}
    for r, bad in unequal.items():
        if bad:      # name the leaves, and hold them to the host bound
            err = _train_grads_close(leaves[r], [x.float().cpu() for x in
                                                 leaves["none"]],
                                     f"[train] remat {r}")
            print(f"[train] {smi}: remat {r} gradients not bit-equal to "
                  f"none's in {bad} (worst leaf at {err:.3f} of its bound)")
    if cuda and not stats["full"][1] < stats["none"][1]:
        raise AssertionError(f"[train] remat full's peak memory is not "
                             f"below none's: {stats}")
    print(f"[train] {smi}: remat, one step each at batch {batch} x seq "
          f"{seq}: " + "; ".join(
              f"{r} {ms:.2f} ms, peak {mem / 2**30:.3f} GiB, loss {loss:.4f}"
              for r, (ms, mem, loss) in stats.items())
          + "; gradients of dots and full "
          + ("bit-equal to none's" if not any(unequal.values())
             else "within the host bound of none's"))
    del grads, leaves

    # --- 4. 30 steps on one fixed batch: a profiled step, and the fall ---
    step = make_train_step(cfg, opt)
    state = [params, opt_state]
    fixed = []

    def run(k):
        for _ in range(k):
            state[0], state[1], m = step(state[0], state[1], data)
            fixed.append(m["loss"])

    run(2)
    sync()
    n = 2
    if cuda:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(n)
            sync()
        rows = device_rows(prof)
        launches = sum(r.count for r in rows) / n
        dev_ms = sum(r.self_device_time_total for r in rows) / 1e3 / n
        top = sorted(rows, key=lambda r: -r.self_device_time_total)[:5]
    else:
        launches = dev_ms = float("nan")
        top = []
    t0 = time.perf_counter()
    run(3)
    sync()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    run(steps - len(fixed))
    fixed = [float(x) for x in fixed]
    f_head, f_tail = np.mean(fixed[:3]), np.mean(fixed[-3:])
    if not f_tail < f_head:
        raise AssertionError(f"[train] the loss did not fall on one fixed "
                             f"batch: {fixed}")
    print(f"[train] {smi}: {arch} train step, batch {batch} x seq {seq}, "
          f"remat {cfg.remat}: {launches:.1f} kernel and copy launches per "
          f"step, device busy {dev_ms:.3f} ms, unprofiled wall {wall:.3f} "
          f"ms per step (idle share {1 - dev_ms / wall:.3f}); busiest: "
          + ", ".join(f"{r.key[:40]} {r.self_device_time_total / 1e3 / n:.2f}"
                      f" ms" for r in top))
    print(f"[train] {smi}: {steps} steps on one fixed batch (the CLI's "
          f"schedule): loss first-3 mean {f_head:.4f} -> last-3 mean "
          f"{f_tail:.4f}; the CLI's stream: {head:.4f} -> {tail:.4f}")
    del state, params, opt_state, data
    if cuda:
        torch.cuda.empty_cache()

    # --- 5. one float32 step at full width, 2 layers, card against host -
    c = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.float32,
                            act_dtype=torch.float32)
    params, host = _lm_model(c, dev)
    runs = {}
    for where, p in (("card", params), ("host", host)):
        d = p["embed"].device
        data = train_cli.synthetic_batch_fn(c, 2, 64, device=d)(0)
        (_, _), g = make_grad_fn(c)(p, data)
        p2, s2, m = make_train_step(c, opt)(p, adamw_init(p, opt), data)
        runs[where] = (g, p2, {k: float(v) for k, v in m.items()})
    (g_d, p_d, m_d), (g_h, p_h, m_h) = runs["card"], runs["host"]
    for k, rel in (("loss", TRAIN_REL), ("grad_norm", TRAIN_GNORM)):
        if abs(m_d[k] - m_h[k]) > rel * abs(m_h[k]):
            raise AssertionError(f"[train] card vs host {k}: {m_d[k]} vs "
                                 f"{m_h[k]}")
    worst = _train_grads_close(g_d, g_h, "[train] card vs host gradients")
    far = total = 0
    err = 0.0
    for a, b in zip(_lm_leaves(p_d), _lm_leaves(p_h)):
        dlt = (a.cpu() - b).abs()
        err = max(err, float(dlt.max()))
        far += int((dlt > TRAIN_CLOSE).sum())
        total += dlt.numel()
    if err > 2 * opt.lr + 1e-6 or far > TRAIN_SHARE * total:
        raise AssertionError(f"[train] card vs host params: max {err}, "
                             f"{far} of {total} beyond {TRAIN_CLOSE}")
    print(f"[train] {smi}: {arch} width, {c.n_layers} layers of "
          f"{cfg.n_layers}, float32, batch 2 x seq 64, one step card vs "
          f"host: loss {m_d['loss']:.6f} / {m_h['loss']:.6f}, grad_norm "
          f"{m_d['grad_norm']:.6f} / {m_h['grad_norm']:.6f} (bounds "
          f"{TRAIN_REL} and {TRAIN_GNORM} relative), gradients at worst {worst:.3f} of the "
          f"per-leaf bound ({TRAIN_GRAD_LEAF} * max|g(leaf)| + "
          f"{TRAIN_GRAD_TREE} * max|g|), params max |delta| {err:.3g}, "
          f"{far} of {total} beyond {TRAIN_CLOSE}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    del params, host, runs, g_d, p_d
    if cuda:
        torch.cuda.empty_cache()


def lm_examples_phase(smi, *, device="cuda", serve_steps=24,
                      train_steps=300, train_cfg=None):
    """Phase 1d ``[lm_examples]``: the LM examples as a user runs them on
    ``device``: ``serve_lm`` at its defaults (mamba2-370m smoke, batch 4,
    cache 64) and with ``--arch zamba2-1.2b``, each replayed on the CLI's
    tokens and held to ``[lm]``'s bf16 bound (the card's logits no farther
    from the host's float32 run than the host's bf16 run, plus ``LM_BF16``
    of the largest logit);
    then ``train_lm`` in full (the reference's flags: 300 steps, batch 4,
    seq 128, lr 1e-3, a checkpoint every 100).  ``serve_steps``,
    ``train_steps`` and ``train_cfg`` (a stand-in for ``lm-100m``) cut it
    for a rehearsal on the CPU."""
    import contextlib
    import dataclasses
    import io
    import re
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.train import checkpoint as ckpt

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    host = torch.device("cpu")

    # --- 1. serve_lm, card against the host -------------------------------
    # The CLI's picks are replayed (the same weights, the card's tokens fed)
    # in bf16 on the card and on the host and in float32 on the host: as in
    # [lm], the card's bf16 logits may sit no farther from the float32 run
    # than the host's bf16 logits do, plus LM_BF16 of the largest logit.
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        drawn = {}
        init = T.init_params

        def recording(cfg, gen):
            out = init(cfg, gen)
            drawn["params"] = out[0]
            return out

        argv = ["--device", dev.type] + (
            [] if arch == "mamba2-370m" else ["--arch", arch])
        T.init_params = recording
        bufs = [io.StringIO(), io.StringIO()]
        try:
            for buf, steps in zip(bufs, (2, serve_steps)):    # warm-up, run
                with contextlib.redirect_stdout(buf):
                    seqs = serve_lm.main(argv + ["--steps", str(steps)])
        finally:
            T.init_params = init
        cold, first = (buf.getvalue().splitlines()[0] for buf in bufs)
        m = re.match(r"decoded (\d+) steps x batch (\d+) in ([\d.]+)s "
                     r"\(([\d.]+) tok/s\)", first)
        cfg = configs.get_smoke(arch)
        if m is None or seqs.shape != (4, serve_steps + 1) or \
                seqs.min() < 0 or seqs.max() >= cfg.vocab:
            raise AssertionError(f"[lm_examples] serve_lm {arch}: "
                                 f"{first!r}, seqs {seqs.shape}")
        fed = torch.from_numpy(seqs).to(torch.int32)
        forced = [fed[:, i:i + 1] for i in range(serve_steps + 1)]
        card = drawn["params"]
        bf_host = tree_map(lambda a: a.detach().to(host), card)
        f32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  act_dtype=torch.float32)
        replay = {}
        for name, c, p, where in (
                ("card", cfg, card, dev), ("host", cfg, bf_host, host),
                ("f32", f32, tree_map(lambda a: a.float(), bf_host), host)):
            replay[name] = [lg[:, -1].float().cpu() for lg in _lm_decode(
                c, p, where, 4, 64, serve_steps, forced[0],
                forced=forced)[0]]
        truth = replay["f32"]
        e_card, scale = _lm_err(replay["card"], truth, float("inf"), 0.0, "")
        e_host = _lm_err(replay["host"], truth, float("inf"), 0.0, "")[0]
        if e_card > e_host + LM_BF16 * scale:
            raise AssertionError(f"[lm_examples] serve_lm {arch} bf16: card "
                                 f"{e_card:.4g} from float32, host "
                                 f"{e_host:.4g}, max|logit| {scale:.4g}")
        picks = fed[:, 1:].T.long()
        same_card = sum(int(torch.equal(lg.argmax(-1), pk))
                        for lg, pk in zip(replay["card"], picks))
        flips = int(sum(int((lg.argmax(-1) != pk).sum())
                        for lg, pk in zip(truth, picks)))
        secs = float(m.group(3))
        print(f"[lm_examples] {smi}: serve_lm --arch {arch} (smoke, "
              f"{str(cfg.param_dtype).split('.')[-1]}, batch 4, cache 64, "
              f"{serve_steps} steps, after a 2-step warm-up call: {cold}): "
              f"{first}; {secs / serve_steps * 1e3:.3f} ms per step (host "
              f"clock); replayed on the CLI's tokens: bf16 max |delta| from "
              f"the host's float32 run card {e_card:.4g}, host {e_host:.4g} "
              f"(bound host + {LM_BF16} * {scale:.4g}); the card replay's "
              f"argmax is the CLI's pick at {same_card} of {serve_steps} "
              f"steps; {flips} of {4 * serve_steps} picks differ from the "
              f"float32 argmax")
        del drawn, card, bf_host, replay

    # --- 2. train_lm in full ----------------------------------------------
    record = {"dt": [], "loss": [], "write": []}

    class Recording(train_cli.TrainSupervisor):
        def run(self, *a, on_metrics, **k):
            def both(step, m):
                record["dt"].append(m["dt"])
                record["loss"].append(m["loss"])
                on_metrics(step, m)
            return super().run(*a, on_metrics=both, **k)

    def timed_write(*a, **k):
        t0 = time.perf_counter()
        try:
            return write(*a, **k)
        finally:
            record["write"].append(time.perf_counter() - t0)

    saved = (train_cli.TrainSupervisor, ckpt._write, train_lm.CONFIG)
    write = ckpt._write
    train_cli.TrainSupervisor, ckpt._write = Recording, timed_write
    if train_cfg is not None:
        train_lm.CONFIG = train_cfg
    cfg = train_lm.CONFIG
    root = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    try:
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            params = train_lm.main(["--device", dev.type, "--steps",
                                    str(train_steps), "--ckpt-dir",
                                    f"{root}/ck"])
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated(dev) if cuda else float("nan")
        lines = buf.getvalue().splitlines()
        dt, losses = record["dt"], record["loss"]
        kept = sorted(p.name for p in Path(root, "ck").iterdir()
                      if p.name.startswith("step_"))
        # the async saves every 100 steps, the final save at the last step
        want = [f"step_{s:09d}" for s in
                sorted({*range(100, train_steps + 1, 100), train_steps})]
        summary = [ln for ln in lines if ln.startswith("first-")]
        if len(dt) != train_steps or not np.isfinite(losses).all() \
                or kept != want or len(summary) != 1 or not all(
                    bool(a.isfinite().all()) for a in _lm_leaves(params)):
            raise AssertionError(f"[lm_examples] train_lm: {len(dt)} steps,"
                                 f" checkpoints {kept}, lines {lines[-2:]}")
        ms = float(np.median(dt[3:])) * 1e3
        tokens = 4 * 128
        print(f"[lm_examples] {smi}: train_lm ({lines[0]}; {cfg.n_layers} "
              f"layers, d {cfg.d_model}, vocab {cfg.vocab}, "
              f"{str(cfg.param_dtype).split('.')[-1]}, remat {cfg.remat}), "
              f"batch 4 x seq 128, lr 1e-3, {train_steps} steps: {ms:.2f} ms "
              f"per step (median of steps 4-{train_steps}, host clock; min "
              f"{min(dt[3:]) * 1e3:.2f}, max {max(dt[3:]) * 1e3:.2f}; first "
              f"step {dt[0] * 1e3:.1f}), {tokens / ms * 1e3:.0f} tokens/s; "
              f"peak memory {mem / 2**30:.3f} GiB (max_memory_allocated); "
              f"{summary[0]} (ln {cfg.vocab} = {np.log(cfg.vocab):.2f}); "
              f"checkpoints {kept}, writes "
              f"{', '.join(f'{w:.2f}' for w in record['write'])} s; whole "
              f"call {wall:.1f} s")
        for line in lines:
            if line.startswith("step "):
                print(f"[lm_examples]   | {line}")
    finally:
        train_cli.TrainSupervisor, ckpt._write, train_lm.CONFIG = saved
        shutil.rmtree(root, ignore_errors=True)
    del params
    if cuda:
        torch.cuda.empty_cache()
    print(f"[lm_examples] {smi}: phase {time.perf_counter() - t_phase:.1f} s")


def mesh_phase(smi, *, device="cuda", full=True):
    """Phase 1e ``[mesh]``: the serve and train CLIs under their local
    mesh (1x1, NCCL on the card) against the same CLIs with the mesh left
    inactive (seqs, every loss and the final parameters bit-equal), and
    olmoe-1b-7b at full width, its depth cut (``LM_DEPTH``), float32, with
    ``moe_a2a=True`` on the mesh against ``moe_a2a=False`` without it:
    logits, aux and a train step's gradients equal (0, or within
    ``LM_F32`` / ``[train]``'s bound).  ``full=False`` runs smoke configs
    (a rehearsal on the CPU, gloo)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import compat, configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.meshctx import use_mesh_rules
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_grad_fn

    dev = torch.device(device)
    t_phase = time.perf_counter()
    get = configs.get if full else configs.get_smoke
    smoke = [] if full else ["--smoke"]

    def no_mesh(mesh, rules):
        return contextlib.nullcontext()

    # --- 1. the CLIs with their mesh active and inactive ------------------
    arch = "qwen2-0.5b"
    argv = ["--arch", arch, "--device", dev.type, "--steps", "8", *smoke]
    runs = {}
    for name, ctx in (("mesh", serve_cli.use_mesh_rules), ("none", no_mesh)):
        saved = serve_cli.use_mesh_rules
        serve_cli.use_mesh_rules = ctx
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                runs[name] = serve_cli.main(argv)
        finally:
            serve_cli.use_mesh_rules = saved
    mesh = make_local_mesh(device=dev)
    backend = dist.get_backend()
    if not np.array_equal(runs["mesh"], runs["none"]):
        raise AssertionError("[mesh] serve CLI: seqs differ under the mesh")
    print(f"[mesh] {smi}: the CLIs' local mesh: {mesh} over a {backend} "
          f"world of {dist.get_world_size()}; serve CLI {arch}"
          f"{'' if full else ' (smoke)'} 8 steps x batch 4: seqs equal "
          f"with the mesh active and inactive")

    losses = {}
    finals = {}

    class Recording(train_cli.TrainSupervisor):
        def run(self, *a, on_metrics, **k):
            def both(step, m):
                losses[name].append(m["loss"])
                on_metrics(step, m)
            return super().run(*a, on_metrics=both, **k)

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    saved = (train_cli.TrainSupervisor, train_cli.use_mesh_rules)
    try:
        for name, ctx in (("mesh", saved[1]), ("none", no_mesh)):
            losses[name] = []
            train_cli.TrainSupervisor, train_cli.use_mesh_rules = \
                Recording, ctx
            with contextlib.redirect_stdout(io.StringIO()):
                finals[name] = train_cli.main([
                    "--arch", arch, "--device", dev.type, "--steps", "3",
                    "--batch", "2", "--seq", "128", "--ckpt-every", "1000",
                    "--ckpt-dir", f"{root}/{name}", *smoke])
    finally:
        train_cli.TrainSupervisor, train_cli.use_mesh_rules = saved
        shutil.rmtree(root, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(_lm_leaves(finals["mesh"]),
                                                 _lm_leaves(finals["none"])))
    if losses["mesh"] != losses["none"] or len(losses["mesh"]) != 3 \
            or not same:
        raise AssertionError(f"[mesh] train CLI: losses {losses}, final "
                             f"parameters equal: {same}")
    print(f"[mesh] {smi}: train CLI {arch}{'' if full else ' (smoke)'} "
          f"3 steps x batch 2 x seq 128: losses {losses['mesh']} and the "
          f"final parameters bit-equal with the mesh active and inactive")
    del finals

    # --- 2. the all-to-all MoE on the mesh ---------------------------------
    cfg = dataclasses.replace(get("olmoe-1b-7b"), param_dtype=torch.float32,
                              act_dtype=torch.float32)
    if full:
        cfg = dataclasses.replace(cfg, **LM_DEPTH["olmoe_1b_7b"])
    a2a = dataclasses.replace(cfg, moe_a2a=True)
    params, _ = _lm_model(cfg, dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128))).to(
        device=dev, dtype=torch.int32) for k in ("tokens", "labels")}
    batch["mask"] = torch.ones((2, 128), device=dev)
    rules = sh.make_rules(a2a, mesh, global_batch=2)
    exchanges = [0]
    exchange = compat.all_to_all_single

    def counted(*a, **k):
        exchanges[0] += 1
        return exchange(*a, **k)

    out = {}
    for name, c, ctx in (("moe_apply", cfg, contextlib.nullcontext()),
                         ("a2a", a2a, use_mesh_rules(mesh, rules))):
        compat.all_to_all_single = counted
        exchanges[0] = 0
        try:
            with ctx:
                logits = T.forward_prefill(params, batch, c)
                (loss, metrics), grads = make_grad_fn(c)(params, batch)
        finally:
            compat.all_to_all_single = exchange
        out[name] = (logits, metrics["aux"], grads, exchanges[0])
    (l0, x0, g0, n0), (l1, x1, g1, n1) = out["moe_apply"], out["a2a"]
    if n0 != 0 or n1 < 4 * cfg.n_layers:
        raise AssertionError(f"[mesh] all-to-alls: {n0} without the mesh, "
                             f"{n1} with it")
    err, scale = _lm_err(l1, l0.cpu(), LM_F32, 1.0, "[mesh] a2a logits")
    aux_err = abs(float(x1) - float(x0))
    if aux_err > 1e-6:
        raise AssertionError(f"[mesh] a2a aux {float(x1)} vs {float(x0)}")
    worst = _train_grads_close(g1, [g.cpu() for g in _lm_leaves(g0)],
                               "[mesh] a2a gradients")
    gerr = max(float((a - b).abs().max()) for a, b in
               zip(_lm_leaves(g1), _lm_leaves(g0)))
    print(f"[mesh] {smi}: olmoe-1b-7b width{'' if full else ' (smoke)'}, "
          f"{cfg.n_layers} layers, float32, batch 2 x seq 128, moe_a2a on "
          f"the mesh ({n1} all-to-alls over {backend} in a prefill and a "
          f"train step) against moe_apply without it: logits max|delta| "
          f"{err:.3g} (bound {LM_F32} * {max(1.0, scale):.3g}), aux "
          f"{float(x1):.9g} / {float(x0):.9g}, gradients max|delta| "
          f"{gerr:.3g} ({worst:.3f} of [train]'s per-leaf bound); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    del params, out, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()


DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("olmoe-1b-7b", "decode_32k"))
# a CPU rehearsal runs the cells' smoke configs at these sizes
DRYRUN_SMOKE_SHAPES = {"train_4k": ("train", 64, 8),
                       "decode_32k": ("decode", 64, 8)}


def _dryrun_cmd(arch, shape, out, device, full):
    """The dry-run CLI as a user runs it (``full``), or its rehearsal on the
    cell's smoke config at ``DRYRUN_SMOKE_SHAPES``."""
    argv = ["--arch", arch, "--shape", shape, "--mesh", "single", "--out",
            out, "--device", device]
    if full:
        return [sys.executable, "-m", "repro_torch.launch.dryrun", *argv]
    boot = ("import sys; from repro_torch import configs; "
            "configs.get = configs.get_smoke; "
            f"configs.SHAPES.update({DRYRUN_SMOKE_SHAPES!r}); "
            "from repro_torch.launch import dryrun; "
            "sys.exit(dryrun.main(sys.argv[1:]))")
    return [sys.executable, "-c", boot, *argv]


def dryrun_phase(smi, *, device="cuda", full=True):
    """Phase 1f ``[dryrun]``: the dry-run and roofline tools (M11c-2).
    (a) ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELLS`` at full
    size on the single-pod mesh (16x16, a fake world of 256 in each
    subprocess, the two run side by side): every record ok, its terms
    printed.  (b) The counter over one real train step of qwen2-0.5b
    (batch 8 x seq 256, remat ``dots``, the 1x1 mesh) on the card and over
    the same step on fake tensors: dot FLOPs, HBM bytes, collective bytes
    and collectives equal; the terms beside the profiled device busy time,
    and the counted argument plus peak temporary bytes beside
    ``max_memory_allocated``.  (c) The runner's ``roofline(dryrun)`` rows
    over (a)'s records: ``dryrun_cells_ok`` equals the ok records.
    ``full=False`` rehearses it on the CPU at the smoke configs."""
    import os
    import shutil
    import subprocess
    import tempfile
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.benchmarks import roofline_table
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import HW, make_local_mesh
    from repro_torch.meshctx import use_mesh_rules
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils.hlo_analysis import analyze

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()

    # --- (a) two full-size cells, each in a process of its own ----------
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            _dryrun_cmd(a, s, out, dev.type, full), cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for a, s in DRYRUN_CELLS]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        wall = time.perf_counter() - t0
        recs = roofline_table.load(out)
        for (a, s), p, log in zip(DRYRUN_CELLS, procs, logs):
            for line in log.splitlines()[-4:]:
                print(f"[dryrun]   | {line}")
            rec = next((r for r in recs if r["arch"] == a
                        and r["shape"] == s), None)
            if p.returncode != 0 or rec is None or not rec["ok"]:
                raise AssertionError(
                    f"[dryrun] {a} {s}: exit {p.returncode}, "
                    f"{(rec or {}).get('error')}\n{log[-3000:]}")
            rf, ma = rec["roofline"], rec["memory_analysis"]
            print(f"[dryrun] {smi}: {a} {s}{'' if full else ' (smoke)'} on "
                  f"the {rec['chips']}-card single-pod mesh: ok, lower_s "
                  f"{rec['lower_s']:.2f}, compile_s {rec['compile_s']:.2f} "
                  f"(host); per card: compute {rf['compute_s']:.6g} s, "
                  f"memory {rf['memory_s']:.6g} s, collective "
                  f"{rf['collective_s']:.6g} s, dominant {rf['dominant']}, "
                  f"useful_ratio {rf['useful_ratio']:.4f}; dot FLOPs "
                  f"{rec['hlo']['dot_flops']:.6g}, HBM bytes "
                  f"{rec['hlo']['hbm_bytes']:.6g}, collectives "
                  f"{rec['hlo']['n_collectives']} "
                  f"{ {k: f'{v:.4g}' for k, v in rf['collective_breakdown'].items()} }"
                  f"; argument / output / temp bytes "
                  f"{ma['argument_size_in_bytes']} / "
                  f"{ma['output_size_in_bytes']} / "
                  f"{ma['temp_size_in_bytes']}; model_flops "
                  f"{rf['model_flops']:.6g}")
        print(f"[dryrun] {smi}: the two dry-run processes side by side "
              f"took {wall:.1f} s")

        # --- (c) the runner's roofline(dryrun) rows over (a)'s records --
        rows = roofline_table.rows(out)
        n_ok = sum(1 for r in recs if r.get("ok"))
        if rows[-1] != ("dryrun_cells_ok", 0.0, float(n_ok)) or n_ok != len(
                DRYRUN_CELLS):
            raise AssertionError(f"[dryrun] rows {rows}, {n_ok} ok records")
        print(f"[dryrun] {smi}: roofline(dryrun) rows over them: "
              + ", ".join(f"{n} {v:.4g}" for n, _, v in rows))
    finally:
        shutil.rmtree(out, ignore_errors=True)

    # --- (b) the counter over a real step and over the same step fake ---
    arch = "qwen2-0.5b"
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    batch, seq = (8, 256) if full else (2, 64)
    mesh = make_local_mesh(device=dev)
    rules = sh.make_rules(cfg, mesh, global_batch=batch)
    opt = AdamWConfig(lr=3e-4, warmup_steps=4, total_steps=30)
    step = make_train_step(cfg, opt)
    params, _ = T.init_params(cfg, torch.Generator(dev).manual_seed(0))
    state = adamw_init(params, opt)
    data = train_cli.synthetic_batch_fn(cfg, batch, seq, device=dev)(0)

    def run(*args):
        with use_mesh_rules(mesh, rules):
            return analyze(step, *args)

    step(params, state, data)            # warm up (cuBLAS handles, caches)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    real = run(params, state, data)[1]
    if cuda:
        torch.cuda.synchronize(dev)
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else float("nan")
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake_args = [tree_map(mode.from_tensor, x)
                 for x in (params, state, data)]
    t0 = time.perf_counter()
    fake = run(*fake_args)[1]
    fake_s = time.perf_counter() - t0
    keys = ("dot_flops", "hbm_bytes", "collective_bytes", "n_collectives")
    diff = [k for k in keys if getattr(real, k) != getattr(fake, k)]
    if diff:
        raise AssertionError(f"[dryrun] the fake step's counts differ from "
                             f"the real step's in {diff}: real {real}, "
                             f"fake {fake}")
    if cuda:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(params, state, data)
            torch.cuda.synchronize(dev)
        busy = sum(r.self_device_time_total
                   for r in device_rows(prof)) / 1e3
    else:
        busy = float("nan")
    print(f"[dryrun] {smi}: {arch}{'' if full else ' (smoke)'} train step, "
          f"batch {batch} x seq {seq}, remat {cfg.remat}, 1x1 mesh: the "
          f"real step on {dev} and the same step on fake tensors count "
          f"equal dot FLOPs {real.dot_flops:.6g}, HBM bytes "
          f"{real.hbm_bytes:.6g}, collective bytes {real.collective_bytes}, "
          f"{real.n_collectives} collectives (counted run {real_s:.2f} s "
          f"real, {fake_s:.2f} s fake); at the H100's rates compute "
          f"{real.dot_flops / HW.PEAK_BF16_FLOPS * 1e3:.3f} ms, memory "
          f"{real.hbm_bytes / HW.HBM_BW * 1e3:.3f} ms, beside {busy:.3f} ms "
          f"of profiled device busy time per step; counted arguments + "
          f"peak temporaries {(real.argument_bytes + real.temp_bytes) / 2**30:.3f}"
          f" GiB (fake: {(fake.argument_bytes + fake.temp_bytes) / 2**30:.3f}"
          f" GiB) beside max_memory_allocated {peak / 2**30:.3f} GiB "
          f"(allocated before the step {base / 2**30 if cuda else float('nan'):.3f}"
          f" GiB); phase {time.perf_counter() - t_phase:.1f} s")
    del params, state, data, fake_args
    if cuda:
        torch.cuda.empty_cache()


def _lm_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _lm_paths(tree[k],
                                                           (*path, k))]
    return [("/".join(path), tree)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import ber as ber_mod
    from repro_torch.core import pipeline, pr_eval, prng
    from repro_torch.events import synthetic
    from repro_torch.kernels import _build, compact, fused_step, harris_conv
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    t_call = time.perf_counter()
    smi = nvidia_smi()
    print(f"[env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[env] nvcc build of {sorted(logs)} took "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] ptxas {name}: {line.strip()}")

    # --- 1b. the LM scaffold's serving path (no kernel of the port) -----
    lm_phase(smi)

    # --- 1c. the LM scaffold's training path (no kernel of the port) ----
    train_phase(smi)

    # --- 1d-1e. the LM examples; the CLIs and the all-to-all MoE on the
    # local mesh (no kernel of the port) ---------------------------------
    lm_examples_phase(smi)
    mesh_phase(smi)

    # --- 1f. the dry-run and roofline tools (fake worlds; no kernel) ----
    dryrun_phase(smi)

    # --- 2. K1 against its plain version -------------------------------
    rng = np.random.default_rng(0)
    k1_err, _ = k1_phase(rng, dev)

    # --- 3. K2 against its plain version -------------------------------
    k2_err, _ = k2_phase(rng, dev)

    # --- 3b. K3 against its plain version -------------------------------
    k3_err, n_cases = 0.0, 0
    for rows in (1, 16, 128):
        for e in (128, 512, 4096):
            for cap in (1, e // 8, e):
                for density in (0.0, 0.05, 1.0):
                    scores = torch.randn(rows, e, device=dev)
                    keep = torch.rand(rows, e, device=dev) < density
                    plain = compact.compact_ref(scores, keep, cap=cap)
                    got = compact.compact_cuda(scores, keep, cap=cap)
                    for name, p, g in zip(("idx", "val", "count"), plain,
                                          got):
                        if not torch.equal(p, g):
                            raise AssertionError(
                                f"K3 {name} differs at rows={rows} E={e} "
                                f"cap={cap} density={density}")
                    fin = torch.isfinite(plain[1])
                    if fin.any():
                        k3_err = max(k3_err, float(
                            (plain[1] - got[1])[fin].abs().max()))
                    n_cases += 1
    print(f"[K3] {n_cases} cases (rows 1/16/128 x E 128/512/4096 x cap "
          f"1/E/8/E x density 0/0.05/1): idx, val, count equal")
    push_err, _ = push_phase(np.random.default_rng(15), dev)

    # --- 3c. K4-K7 against their plain versions -------------------------
    k47_err = tos_kernel_phase(np.random.default_rng(13), dev)
    k57_err, k46_err, _ = tos_edge_phase(np.random.default_rng(14), dev)

    # --- 3d. the write-error draw against its plain chain ---------------
    ber_draw_phase(dev)

    # --- 3e. the step's pick and books kernels against their chains -----
    step_lanes_phase(dev)

    # --- 4/5. the main path: run_pipeline on the card ------------------
    davis = synthetic.shapes_stream(duration_us=200_000, seed=0)
    hd = synthetic.shapes_stream(height=720, width=1280,
                                 duration_us=100_000, n_shapes=12,
                                 signal_rate_per_us=2.0,
                                 noise_rate_per_us=0.5, seed=0)
    davis_cfgs = {
        "ber_0.6V": dict(inject_ber=True, vdd=0.6),
        "dvfs_online": dict(dvfs=True, dvfs_online=True),
    }
    hd_cfg = pipeline.PipelineConfig(height=720, width=1280, chunk=512,
                                     lut_every_chunks=2, dvfs=True,
                                     dvfs_online=True, inject_ber=True)
    pipeline.run_pipeline(hd.xy[:4096], hd.ts[:4096], hd_cfg)   # warm-up

    ops.reset_launch_counts()
    gpu_runs, gpu_s = {}, {}
    for name, extra in davis_cfgs.items():
        cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                      patch=7, th=225, **extra)
        t0 = time.perf_counter()
        gpu_runs[name] = pipeline.run_pipeline(davis.xy, davis.ts, cfg)
        gpu_s[name] = time.perf_counter() - t0
    lanes = 4
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2, patch=7,
                                  th=225, **davis_cfgs["ber_0.6V"])
    t0 = time.perf_counter()
    batch = pipeline.run_pipeline_batched(
        np.stack([davis.xy] * lanes), np.stack([davis.ts] * lanes), cfg,
        seeds=list(range(lanes)))
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd_res = pipeline.run_pipeline(hd.xy, hd.ts, hd_cfg)
    torch.cuda.synchronize()
    hd_s = time.perf_counter() - t0
    batch_launches = dict(ops.LAUNCHES)
    print(f"[main] launches on the batch path: {batch_launches}")
    if min(batch_launches["fused_step"], batch_launches["harris"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {batch_launches}")

    cpu_runs = {}
    for name, extra in davis_cfgs.items():
        cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                      patch=7, th=225, backend="torch",
                                      device="cpu", **extra)
        want = cpu_runs[name] = pipeline.run_pipeline(davis.xy, davis.ts,
                                                      cfg)
        got = gpu_runs[name]
        for field in ("kept", "tos", "vdd_trace"):
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"DAVIS240 {name}: {field} differs")
        if (got.energy_pj, got.host_syncs) != (want.energy_pj, 1):
            raise AssertionError(f"DAVIS240 {name}: energy books differ")
        err_s = close(got.scores, want.scores)
        err_l = close(got.lut, want.lut)
        ok = np.isfinite(want.scores)
        auc_g = pr_eval.pr_auc(got.scores[ok], davis.is_corner[ok])
        auc_c = pr_eval.pr_auc(want.scores[ok], davis.is_corner[ok])
        if abs(auc_g - auc_c) > 1e-3:
            raise AssertionError(f"DAVIS240 {name}: PR-AUC {auc_g} vs "
                                 f"{auc_c}")
        print(f"[davis240] {name}: {len(davis)} events, kept/tos/vdd/energy "
              f"equal to CPU, scores max|delta| {err_s:.3g}, lut max|delta| "
              f"{err_l:.3g}, PR-AUC cuda {auc_g:.6f} cpu {auc_c:.6f}, "
              f"host_syncs {got.host_syncs}")

    one = gpu_runs["ber_0.6V"]
    for field in ("scores", "kept", "tos", "lut"):
        if not np.array_equal(getattr(batch[0], field), getattr(one, field)):
            raise AssertionError(f"batched lane 0 {field} differs from the "
                                 f"single-stream run")
    if np.array_equal(batch[1].tos, one.tos):
        raise AssertionError("lanes with other seeds drew the same bits")
    print(f"[davis240] {smi}: ber_0.6V single stream {gpu_s['ber_0.6V']:.3f}"
          f" s = {len(davis) / gpu_s['ber_0.6V']:.0f} events/s; "
          f"run_pipeline_batched x{lanes} lanes {batch_s:.3f} s = "
          f"{lanes * len(davis) / batch_s:.0f} events/s, lane 0 equal to "
          f"the single run, other seeds differ")

    n_chunks = -(-len(hd) // hd_cfg.chunk)
    if not (np.isfinite(hd_res.lut).all() and hd_res.tos.shape == (720, 1280)
            and hd_res.kept.any()):
        raise AssertionError("HD run produced a malformed result")
    print(f"[hd] 1280x720: {len(hd)} events in {n_chunks} chunks of 512, "
          f"{hd_s:.3f} s wall = {len(hd) / hd_s:.0f} events/s, "
          f"{hd_s / n_chunks * 1e3:.3f} ms/chunk (host clock, incl. "
          f"upload and one fetch), kept {hd_res.kept.mean():.3f}, "
          f"vdd picks {sorted(set(hd_res.vdd_trace.tolist()))}")

    # --- 5b. the TOS-update backends (K4, K5) and modes (K6, K7) -------
    tos_launches = tos_backend_phase(smi, davis, hd, davis_cfgs, gpu_runs,
                                     cpu_runs, hd_cfg)

    # --- 6. the serving path: DetectorPool on the card -----------------
    serve_launches, kept_frac = serving_phase(smi, device="cuda")

    # --- 6b. the adaptive pool: live migration and per-lane knobs ------
    adaptive_launches = adaptive_phase(smi, device="cuda")

    # --- 6c. the ladder and pack pools: the per-pump control loop -------
    ladder_launches = ladder_phase(smi, device="cuda")

    # --- 6d-6f. the entry points: CLI, fleet scenarios, serving bench ---
    cli_launches = cli_phase(smi, device="cuda")
    quick_launches = quickstart_phase(smi, device="cuda")
    scenario_launches = scenarios_phase(smi, device="cuda")
    bench_launches = bench_streaming_phase(smi, device="cuda")

    # --- 6g-6i. the loader path, the end-to-end example, the paper benches
    loader_launches = loader_phase(smi, device="cuda")
    e2e_launches, e2e_res = e2e_phase(smi, device="cuda")
    paper_launches = paper_phase(smi, device="cuda")

    # --- 6j-6l. the TOS-kernel cost model, the regression gate, M10 -----
    cost_launches = tos_kernels_phase(smi, device="cuda")
    gate_phase(smi, device="cuda")
    m10_launches = m10_phase(
        smi, device="cuda",
        nmc_auc=e2e_res["shapes_dof"]["auc_errorfree"])

    # --- 6m. the lane mesh: shard=True on the card ----------------------
    lanes_launches = lanes_phase(smi)

    # --- 7. times at the main path's shapes ----------------------------
    # K1 as the main path calls it: in place on a state it owns, each call
    # on a fresh copy of the same state (made before the timed window), HD
    # B=1 E=512 with and without BER, and the DAVIS240 x16 pool's shape
    # with BER; per pass from the profiler.  K2 at HD B=1 and DAVIS240 x16.
    kw = dict(patch=7, th=225, support=2, tw=5000, stcf_enabled=True)
    b, h, w, e = 1, 720, 1280, 512
    ins, ber, bits = k1_inputs(rng, b, h, w, e, dev, inject=True)
    keep = fused_step.fused_step_cuda(*ins, ber, bits, **kw)[2]

    def k1_call(t_ins, *extra, calls=123):
        # Enough fresh states for a warm-up, three profiler windows and a
        # CUDA-event fallback (``device_split``).
        states = iter([(t_ins[0].clone(), t_ins[1].clone())
                       for _ in range(calls)])
        return lambda: fused_step.fused_step_cuda_(*next(states),
                                                   *t_ins[2:], *extra, **kw)

    k1_ms = cuda_ms(k1_call(ins, ber, bits))
    k1_plain = cuda_ms(lambda: fused_step.fused_step_ref(*ins, ber, bits,
                                                         **kw), iters=5)
    k1_bms, k1_by, k1_oop = k1_bound(
        b, h, w, e, 7, ins[3].cpu().numpy(), ins[5].cpu().numpy(),
        keep.cpu().numpy(), True)
    k1_nb_bms, k1_nb_by, _ = k1_bound(
        b, h, w, e, 7, ins[3].cpu().numpy(), ins[5].cpu().numpy(),
        keep.cpu().numpy(), False)
    tos = ins[0]
    k2_ms = cuda_ms(lambda: harris_conv.harris_cuda(tos))
    k2_plain = cuda_ms(lambda: harris_conv.harris_ref(tos), iters=10)
    k2_bms, k2_by, k2_bytes_ms, k2_ops_ms = k2_bound(b, h, w)
    key = prng.prng_key(0, device=dev)[None]
    prng_ms = cuda_ms(lambda: ber_mod.write_error_bits(key, (h, w), ber),
                      iters=10)
    draw_t = ber_draw_timing(smi, dev)
    lanes_t = step_lanes_timing(smi, dev)
    d1 = draw_t["HD B=1"]
    d1_dev = ("not measured" if d1["device_ms"] is None
              else f"{d1['device_ms']:.5f} ms")
    print(f"[time] {smi}: K1 in place {k1_ms:.4f} ms by CUDA events "
          f"(plain {k1_plain:.4f} ms, bound {k1_bms:.5f} ms by {k1_by} in "
          f"place, {k1_oop:.5f} ms by bytes out of place); K2 "
          f"{k2_ms:.4f} ms (plain {k2_plain:.4f} ms); threefry BER draw "
          f"(plain torch, 1280x720x5) {prng_ms:.4f} ms; the draw kernel "
          f"with its key split {d1['ms']:.5f} ms by CUDA events, {d1_dev} "
          f"device (profiler), bound {d1['bound_ms']:.5f} ms by "
          f"{d1['bound_by']}")

    k1_full = device_split(k1_call(ins, ber, bits), K1_KERNELS)
    k1_nb_full = device_split(k1_call(ins), K1_KERNELS)
    k1_plain_dev = device_ms(lambda: fused_step.fused_step_ref(
        *ins, ber, bits, **kw), iters=5)
    k2_dev = device_ms(lambda: harris_conv.harris_cuda(tos))
    k2_plain_dev = device_ms(lambda: harris_conv.harris_ref(tos), iters=10)
    dav16, dav_ber, dav_bits = k1_inputs(rng, 16, 180, 240, e, dev,
                                         inject=True)
    k1_dav_full = device_split(k1_call(dav16, dav_ber, dav_bits),
                              K1_KERNELS)
    # K1's time is the sum of its two kernels' (the whole call's when the
    # profiler recorded nothing).
    (k1_dev, k1_split), (k1_nb_dev, k1_nb_split), (k1_dav_dev,
                                                   k1_dav_split) = (
        (sum(per.values()) if None not in per.values() else total, per)
        for total, per in (k1_full, k1_nb_full, k1_dav_full))
    k2_dav_dev = device_ms(lambda: harris_conv.harris_cuda(dav16[0]))
    k2_dav_bms, k2_dav_by, k2_dav_bytes, k2_dav_ops = k2_bound(16, 180, 240)

    def split(d):
        return ", ".join(f"{k} not measured" if v is None else
                         f"{k} {v * 1e3:.2f} us" for k, v in d.items())

    print(f"[time] {smi}: device time per call (profiler): K1 in place HD "
          f"B=1 E=512 with BER {k1_dev * 1e3:.2f} us ({split(k1_split)}; "
          f"was 61.6 us), without BER {k1_nb_dev * 1e3:.2f} us "
          f"({split(k1_nb_split)}; bound {k1_nb_bms * 1e3:.3f} us by "
          f"{k1_nb_by}), plain {k1_plain_dev:.4f} ms; DAVIS240 x16 E=512 "
          f"with BER {k1_dav_dev * 1e3:.2f} us ({split(k1_dav_split)})")
    print(f"[time] {smi}: K2 device time per call HD B=1 "
          f"{k2_dev * 1e3:.2f} us (was 32.0 us; bounds: bytes "
          f"{k2_bytes_ms * 1e3:.3f} us, float32 operations at the exact "
          f"rounding contract {k2_ops_ms * 1e3:.3f} us), plain "
          f"{k2_plain_dev:.4f} ms; DAVIS240 x16 {k2_dav_dev * 1e3:.2f} us "
          f"(bytes {k2_dav_bytes * 1e3:.3f} us, operations "
          f"{k2_dav_ops * 1e3:.3f} us)")
    k3 = {}
    for rows, cap in ((4, 64), (16, 64)):
        sc = torch.randn(rows, 512, device=dev)
        kp = torch.rand(rows, 512, device=dev) < kept_frac
        k3[rows] = dict(
            ms=cuda_ms(lambda: compact.compact_cuda(sc, kp, cap=cap)),
            plain_ms=cuda_ms(lambda: compact.compact_ref(sc, kp, cap=cap),
                             iters=10),
            device_ms=device_ms(lambda: compact.compact_cuda(sc, kp,
                                                             cap=cap)),
            plain_device_ms=device_ms(
                lambda: compact.compact_ref(sc, kp, cap=cap), iters=10))
        k3[rows]["bound_ms"], k3[rows]["bound_by"] = k3_bound(kp, cap)
        t = k3[rows]
        print(f"[time] {smi}: K3 L={rows} E=512 cap={cap} (keep density "
              f"{kept_frac:.3f}, the HD pool's; {int(kp.sum())} kept): "
              f"{t['ms']:.4f} ms per call by CUDA events over back-to-back "
              f"calls (host-bound), {t['device_ms']:.4f} ms on the device "
              f"per launch; plain {t['plain_ms']:.4f} ms events, "
              f"{t['plain_device_ms']:.4f} ms device; bound "
              f"{t['bound_ms']:.7f} ms by {t['bound_by']}")
    push_t = push_timing(smi, dev, kept_frac)

    # K4-K7 at the main path's shapes: HD, B=1, E=512, K1's kept events;
    # also at DAVIS240 B=1, where the 64x64 tiles are few and dense, and
    # K4/K6 at the DAVIS240 x16 pool's shape.
    from repro_torch.kernels import tos_update
    tkw = dict(patch=7, th=225)
    dav = k1_inputs(rng, 1, 180, 240, e, dev, inject=True)
    dav_keep = fused_step.fused_step_cuda(*dav[0], dav[1], dav[2], **kw)[2]
    dav16_keep = fused_step.fused_step_cuda(*dav16, dav_ber, dav_bits,
                                            **kw)[2]
    # us, device, HD: the per-pixel replay that the tile pass replaced
    was = {"nmc": 9.5, "nmc_binned": 9.0}
    tos_t = {}
    for shape, lanes_, (th_, tw_), t_ins, t_keep in (
            ("hd", 1, (h, w), ins, keep),
            ("davis240", 1, (180, 240), dav[0], dav_keep),
            ("davis240_x16", 16, (180, 240), dav16, dav16_keep)):
        tos_in, xy_in = t_ins[0], t_ins[3]
        centre = ops.centre_surface((th_, tw_), xy_in, t_keep, **tkw)
        if lanes_ == 1:
            row_band, col_band = one_hot_bands(xy_in, t_keep, th_, tw_, 7,
                                               torch.half)
            k_total = torch.bmm(row_band, col_band)
            bg = tos_update.batched_fused_cuda(
                tos_in, xy_in, t_keep, torch.full_like(centre, -1), **tkw)
            want_bg = tos_in.int() - k_total.int()
            if not torch.equal(bg.int(), torch.where(want_bg >= 225,
                                                     want_bg, 0)):
                raise AssertionError("the bmm yardstick's counts differ "
                                     "from K5's")
            bmm_ms = cuda_ms(lambda: torch.bmm(row_band, col_band))
            bmm_dev = device_ms(lambda: torch.bmm(row_band, col_band))
        for mode, name in ops.TOS_MODES.items():
            extra = (centre,) if mode.startswith("batched") else ()
            if extra and lanes_ > 1:
                continue
            kern = getattr(tos_update, f"{name}_cuda")
            plain = getattr(tos_update, f"{name}_ref")
            t = dict(
                ms=cuda_ms(lambda: kern(tos_in, xy_in, t_keep, *extra,
                                        **tkw)),
                device_ms=device_ms(lambda: kern(tos_in, xy_in, t_keep,
                                                 *extra, **tkw)),
                library_ms=bmm_ms if extra else None,
                library_device_ms=bmm_dev if extra else None)
            t["bound_ms"], t["bound_by"] = tos_bound(
                lanes_, th_, tw_, e, 7, t_keep, centre=bool(extra))
            lib = (f"; library torch.bmm of the fp16 one-hot bands (counts "
                   f"only) {bmm_ms:.4f} ms events, {bmm_dev:.4f} ms device, "
                   f"kernel/bmm device {t['device_ms'] / bmm_dev:.2f}"
                   if extra else "")
            if shape == "hd":
                t["plain_ms"] = cuda_ms(lambda: plain(
                    tos_in, xy_in, t_keep, *extra, **tkw), iters=3, warmup=1)
                t["plain_device_ms"] = device_ms(lambda: plain(
                    tos_in, xy_in, t_keep, *extra, **tkw), iters=3,
                    warmup=1)
                tos_t[mode] = t
                lib = (f"; plain {t['plain_ms']:.4f} ms events, "
                       f"{t['plain_device_ms']:.4f} ms device{lib}")
                if mode in was:
                    lib += f"; was {was[mode]} us device"
            else:
                tos_t[mode][shape] = t
            print(f"[time] {smi}: {name} {tw_}x{th_} B={lanes_} E={e} "
                  f"({int(t_keep.sum())} kept): {t['ms']:.4f} ms events, "
                  f"{t['device_ms']:.4f} ms device; bound "
                  f"{t['bound_ms']:.6f} ms by {t['bound_by']}{lib}")

    # Profile of a short steady window of the HD step.
    profile_hd(smi, "HD", hd, hd_cfg, {
        "K1 fused_step.cu": K1_KERNELS, "K2 harris.cu": ("harris_kernel",)})

    entry_points = (cli_launches, quick_launches, scenario_launches,
                    bench_launches, loader_launches, e2e_launches,
                    paper_launches, cost_launches, m10_launches,
                    lanes_launches)
    launches = {k: batch_launches[k] + serve_launches[k]
                + adaptive_launches[k] + ladder_launches[k]
                + sum(d[k] for d in entry_points)
                for k in serve_launches}
    kernels = [
        {"name": "fused_step", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_step.cu",
         "replaces": "src/repro/kernels/fused_step.py:154",
         "launches": launches["fused_step"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bms,
         "bound_by": k1_by, "library_ms": None, "device_ms": k1_dev,
         "plain_device_ms": k1_plain_dev, "device_ms_by_pass": k1_split,
         "no_ber": {"device_ms": k1_nb_dev, "bound_ms": k1_nb_bms,
                    "bound_by": k1_nb_by, "device_ms_by_pass": k1_nb_split},
         "davis240_x16": {"device_ms": k1_dav_dev,
                          "device_ms_by_pass": k1_dav_split}},
        {"name": "harris", "route": "cuda",
         "source": "src/repro_torch/csrc/harris.cu",
         "replaces": "src/repro/kernels/harris_conv.py:101",
         "launches": launches["harris"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bms,
         "bound_by": k2_by, "library_ms": None, "device_ms": k2_dev,
         "plain_device_ms": k2_plain_dev, "bound_bytes_ms": k2_bytes_ms,
         "bound_operations_ms": k2_ops_ms,
         "davis240_x16": {"device_ms": k2_dav_dev, "bound_ms": k2_dav_bms,
                          "bound_by": k2_dav_by}},
        {"name": "compact", "route": "cuda",
         "source": "src/repro_torch/csrc/compact.cu",
         "replaces": "src/repro/kernels/compact.py:65",
         "launches": launches["compact"],
         "max_abs_err": max(k3_err, push_err), "library_ms": None,
         **k3[4], "ring_push": push_t},
    ]
    replaces = {"nmc": 82, "batched": 328, "nmc_binned": 182,
                "batched_binned": 292}
    for mode, name in ops.TOS_MODES.items():
        src = "tos_count" if mode.startswith("batched") else "tos_update"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/tos_update.py:{replaces[mode]}",
            "launches": tos_launches[mode]
            + sum(d[mode] for d in entry_points),
            "max_abs_err": max(
                k47_err, k57_err if src == "tos_count" else k46_err),
            **tos_t[mode]})
    kernels.append({
        "name": "ber_draw", "route": "cuda",
        "source": "src/repro_torch/csrc/ber_draw.cu", "replaces": None,
        "launches": launches["ber_draw"], "max_abs_err": 0,
        "library_ms": None, **draw_t["HD B=1"],
        "hd_x4": draw_t["HD x4"], "davis240_x16": draw_t["DAVIS240 x16"]})
    for kernel, name in (("pick", "dvfs_pick"), ("books", "step_books")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/step_lanes.cu", "replaces": None,
            "launches": launches[name], "max_abs_err": 0,
            "library_ms": None, **lanes_t["HD x4"][kernel],
            **{what: t[kernel] for what, t in lanes_t.items()
               if what != "HD x4"}})
    print(f"[env] whole call {time.perf_counter() - t_call:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
