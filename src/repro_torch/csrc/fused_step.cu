// K1: one chunk of the detector step for B lanes at once — STCF keep and
// LUT score, SAE scatter-max, TOS patch update, BER write errors — updating
// the TOS and the SAE in place.
//
// Replaces the TPU kernel `fused_chunk_step_call` (`_fused_kernel`) in
// src/repro/kernels/fused_step.py.  That kernel replays every event serially
// in each 128x128 tile with the whole SAE resident in VMEM; at 1280x720 the
// SAE alone is 3.7 MB, far beyond one SM's 227 KB of shared memory, so this
// port splits the chunk into two launches on the caller's stream, each
// integer-exact against the reference's closed forms:
//
//   (a) stcf_score_kernel: one warp per event, 8 per block, so the blocks
//       of one lane spread over the SMs.  Reads that do not wait for the
//       scan go first: lane 4 the event's LUT value, lanes 0..8 but 4 one
//       3x3 neighbour each of the SAE as it was before the chunk.  The
//       block stages the earlier events its warps need in shared memory
//       (1,024 per round, all loads in flight at once); the warp's lanes
//       stride over them (E/32 steps, not E) and __reduce_or_sync merges
//       the neighbour bits: an earlier valid event within tw at a 3x3
//       offset.  A ballot counts the recent neighbours.  Lane 4 writes
//       keep, the score and the event's packed 8-byte record for (b)
//       (x | y << 16 | keep << 31, and valid ? t : NEVER).  Nothing is
//       written to the surfaces, so the pass reads the pre-chunk SAE
//       whatever order blocks run in.
//   (b) fused_tile_kernel: one block per 64x64 tile of one lane.  It reads
//       the lane's records once, in stream order, 512 per pass (one
//       16-byte load per thread, the next pass's in flight), and with warp
//       ballots and a scan of the warp totals appends the kept events whose
//       patch touches the tile to a list in shared memory (one barrier per
//       pass), as csrc/tos_count.cu stages its events.  Valid events
//       centred in the tile are scattered into the SAE with atomicMax
//       here, after (a) has read it.  Then every listed event at once:
//       shared-memory atomicMax of the list index (stream order) of the
//       last event centred on each tile pixel, then atomicAdd of the covers
//       after it.  Each thread owns 16 pixels of one row and applies
//       `tos_update_batched`'s closed form to them (from 255 if centred,
//       else the old value, k covers give that - k if >= th, else 0):
//       exact in any atomic order, with no writer test and no walk back.
//       When the lane injects (bits given and ber > 0), the 5-bit encode /
//       xor / decode of `ber.apply_write_errors` follows on the same
//       registers, and the tile is written back in place.  Without BER, a
//       tile that no kept event touches returns before it reads a pixel.
//
// An optional (B,) lane mask leaves inactive lanes untouched: their blocks
// of (b) return at once (no patch, no SAE scatter, no BER), while (a) still
// writes their keep and scores, which the caller selects as it likes.
//
// Bound on the H100: bytes.  With BER the whole TOS is read and written
// and the int32 bits read once (5.5 MB at 1280x720, 1.66 us at 3.35 TB/s);
// without it only the kept patches' pixels move.  The design keeps the
// surfaces out of shared memory, reads each pixel once with 16-byte loads
// issued before the event staging (when injecting), and has no serial
// chain longer than E/32 steps (a) or E/512 passes (b); the covers are
// counted in parallel.  8,192 events in one tile stay exact (the list
// and the two 64x64 int32 tables take up to 64 KB of shared memory).
//
// Timestamp differences wrap modulo 2^32 exactly as the reference's int32
// arithmetic does, computed in unsigned arithmetic so no signed overflow
// (undefined in C++) can occur.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEVER = -(1 << 30);
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EVENTS = 8192;
constexpr int STAGE = 1024;              // (a): events staged per round
constexpr int TILE = 64;                 // (b): output tile edge
constexpr int PIX = TILE * TILE / THREADS;   // 16 pixels of one row each
constexpr int EPT = 2;                   // (b): events per thread per pass
constexpr int PASS = THREADS * EPT;
constexpr int SURF_BYTES = 2 * TILE * TILE * 4;   // (b): centre index, counts
constexpr int OUTSIDE = 0x7fffffff;   // a record's (x, y) off every tile

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// (a) Keep and score of 8 events per block, one per warp.
__global__ void __launch_bounds__(THREADS)
stcf_score_kernel(const int2* __restrict__ xy, const int* __restrict__ ts,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ sae, const float* __restrict__ lut,
                  uint8_t* __restrict__ keep_out, float* __restrict__ scores,
                  int2* __restrict__ rec, int H, int W, int E, int E2,
                  int support, int tw, int stcf_enabled) {
  __shared__ int sx[STAGE], sy[STAGE], st[STAGE];
  __shared__ uint8_t sv[STAGE];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = i < E;   // uniform across the warp
  const int b = blockIdx.y;
  const int2* lxy = xy + (size_t)b * E;
  const int* lts = ts + (size_t)b * E;
  const uint8_t* lval = valid + (size_t)b * E;
  const size_t plane = (size_t)H * W;
  int x = 0, y = 0, t = 0;
  bool v = false;
  if (live) {
    const int2 p = lxy[i];
    x = p.x;
    y = p.y;
    t = lts[i];
    v = lval[i] != 0;
  }
  const bool inb = x >= 0 && x < W && y >= 0 && y < H;
  // Reads that do not wait for the scan are issued first: lane 4 the
  // event's LUT value, lanes 0..8 but 4 one neighbour each of the SAE as it
  // was before the chunk.
  float score = -__int_as_float(0x7f800000);
  if (lane == 4 && live && inb) score = lut[b * plane + (size_t)y * W + x];

  bool keep = v;
  if (stcf_enabled) {
    const int qy = y + lane / 3 - 1, qx = x + lane % 3 - 1;
    const int s = (live && lane < 9 && lane != 4 && qy >= 0 && qy < H &&
                   qx >= 0 && qx < W)
                      ? sae[b * plane + (size_t)qy * W + qx] : NEVER;
    // Earlier valid in-chunk events within tw, one bit per 3x3 offset: the
    // block stages the events its warps need, STAGE at a time, and each
    // warp's lanes stride over them.
    unsigned bits = 0;
    const int need = min(E, (int)(blockIdx.x + 1) * WARPS) - 1;
    for (int base = 0; base < need; base += STAGE) {
      const int n = min(STAGE, need - base);
      for (int k = threadIdx.x; k < n; k += THREADS) {
        const int2 p = lxy[base + k];
        sx[k] = p.x;
        sy[k] = p.y;
        st[k] = lts[base + k];
        sv[k] = lval[base + k];
      }
      __syncthreads();
      const int end = min(n, i - base);
      for (int k = lane; k < end; k += 32) {
        const int dx = sx[k] - x, dy = sy[k] - y;
        if (sv[k] && dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1 &&
            (dx | dy) != 0 && wrap_sub(t, st[k]) <= tw)
          bits |= 1u << ((dy + 1) * 3 + (dx + 1));
      }
      __syncthreads();
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    const bool recent = lane < 9 && lane != 4 &&
                        (((bits >> lane) & 1u) ||
                         (s > NEVER / 2 && wrap_sub(t, s) <= tw));
    keep = v && __popc(__ballot_sync(0xffffffffu, recent)) >= support;
  }
  keep = keep && inb;
  if (live && lane == 4) {
    keep_out[(size_t)b * E + i] = keep;
    scores[(size_t)b * E + i] = keep ? score : -__int_as_float(0x7f800000);
    // The record (b) stages: x | y << 16 | keep << 31 (OUTSIDE when the
    // event is off the surface), and the value the SAE scatter takes.
    rec[(size_t)b * E2 + i] = make_int2(
        inb ? (int)((unsigned)x | (unsigned)y << 16 | (unsigned)keep << 31)
            : OUTSIDE,
        v ? t : NEVER);
  }
}

// Records e and e + 1 of a lane (e even; OUTSIDE past E): one 16-byte
// load.
__device__ __forceinline__ void load_records(const int2* lrec, int E, int e,
                                             int (&p)[EPT], int (&u)[EPT]) {
  int4 w = make_int4(OUTSIDE, NEVER, OUTSIDE, NEVER);
  if (e < E) w = *reinterpret_cast<const int4*>(lrec + e);
  p[0] = w.x;
  u[0] = w.y;
  p[1] = e + 1 < E ? w.z : OUTSIDE;
  u[1] = w.w;
}

__device__ __forceinline__ void unpack16(uint4 w, int (&v)[PIX]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < PIX; ++q) v[q] = (u[q >> 2] >> (8 * (q & 3))) & 0xffu;
}

__device__ __forceinline__ uint4 pack16(const int (&v)[PIX]) {
  unsigned u[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < PIX; ++q)
    u[q >> 2] |= (unsigned)(v[q] & 0xff) << (8 * (q & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// (b) One 64x64 tile of one lane.
__global__ void __launch_bounds__(THREADS)
fused_tile_kernel(uint8_t* __restrict__ tos, int* __restrict__ sae,
                  const int2* __restrict__ rec,
                  const int* __restrict__ bits,
                  const float* __restrict__ ber,
                  const uint8_t* __restrict__ mask, int H, int W, int E,
                  int E2, int r, int th, int stcf_enabled, int vec) {
  extern __shared__ __align__(16) int smem[];
  int* last = smem;                         // [TILE][TILE]: last centred entry
  int* cnt = smem + TILE * TILE;            // [TILE][TILE]: covers after it
  int* list = smem + 2 * TILE * TILE;       // kept, touching: ry << 16 | rx
  __shared__ int tot[2][WARPS];
  const int b = blockIdx.z;
  if (mask != nullptr && !mask[b]) return;   // inactive lane: untouched
  const bool inject = bits != nullptr && ber[b] > 0.f;
  const int bx0 = blockIdx.x * TILE, by0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const size_t off = (size_t)b * H * W;
  const int2* lrec = rec + (size_t)b * E2;

  // The first pass's records are loaded first; each pass loads the next
  // one's while it ranks its own.
  int np[EPT], nu[EPT];
  load_records(lrec, E, tid * EPT, np, nu);

  // This thread's pixels: row `row` of the tile, columns c0 .. c0 + 15.
  const int row = tid >> 2, c0 = (tid & 3) * PIX;
  const int py = by0 + row, px0 = bx0 + c0;
  const bool mine = py < H && px0 < W;
  const size_t p0 = off + (size_t)py * W + px0;
  int v[PIX], bv[PIX];
  // With BER every pixel is rewritten: start its loads now, so that they
  // are in flight while the events are staged.
  if (inject && mine) {
    if (vec) {
      unpack16(*reinterpret_cast<const uint4*>(tos + p0), v);
      const int4* bp = reinterpret_cast<const int4*>(bits + p0);
#pragma unroll
      for (int k = 0; k < PIX / 4; ++k) {
        const int4 w = bp[k];
        bv[4 * k] = w.x; bv[4 * k + 1] = w.y;
        bv[4 * k + 2] = w.z; bv[4 * k + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        const bool in = px0 + q < W;
        v[q] = in ? tos[p0 + q] : 0;
        bv[q] = in ? bits[p0 + q] : 0;
      }
    }
  }
  // No centred entry (-1) and no count yet, for every tile pixel.
  for (int k = tid; k < TILE * TILE / 4; k += THREADS) {
    reinterpret_cast<int4*>(last)[k] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(cnt)[k] = make_int4(0, 0, 0, 0);
  }

  // Stage the kept events touching the tile, in stream order (thread t of
  // a pass holds events 2t and 2t + 1); scatter the SAE of the valid
  // events centred in the tile.
  int n_list = 0;   // uniform across the block
  for (int e0 = 0, pass = 0; e0 < E; e0 += PASS, ++pass) {
    int x[EPT], y[EPT], u[EPT];
    bool k[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      x[q] = np[q] & 0xffff;
      y[q] = (np[q] >> 16) & 0x7fff;
      k[q] = np[q] < 0;   // bit 31
      u[q] = nu[q];
    }
    if (e0 + PASS < E)
      load_records(lrec, E, e0 + PASS + tid * EPT, np, nu);
    int n_t = 0, t_lo = 0;
    bool touch[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      if (stcf_enabled && x[q] >= bx0 && x[q] < bx0 + TILE && x[q] < W &&
          y[q] >= by0 && y[q] < by0 + TILE && y[q] < H)
        atomicMax(sae + off + (size_t)y[q] * W + x[q], u[q]);
      touch[q] = k[q] && x[q] >= bx0 - r && x[q] < bx0 + TILE + r &&
                 y[q] >= by0 - r && y[q] < by0 + TILE + r;
      const unsigned tb = __ballot_sync(0xffffffffu, touch[q]);
      n_t += __popc(tb);
      t_lo += __popc(tb & lower);
    }
    int* t = tot[pass & 1];
    if (lane == 0) t[warp] = n_t;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = t[w];
      before += (w < warp) ? c : 0;
      total += c;
    }
    int pos = n_list + before + t_lo;
#pragma unroll
    for (int q = 0; q < EPT; ++q)
      if (touch[q])
        list[pos++] = ((y[q] - by0 + r) << 16) | (x[q] - bx0 + r);
    n_list += total;
  }
  __syncthreads();   // the list is complete
  if (n_list == 0 && !inject) return;   // uniform: the tile is untouched

  if (!inject && mine) {
    if (vec) {
      unpack16(*reinterpret_cast<const uint4*>(tos + p0), v);
    } else {
#pragma unroll
      for (int q = 0; q < PIX; ++q) v[q] = px0 + q < W ? tos[p0 + q] : 0;
    }
  }

  // The listed events in closed form, `tos_update_batched`'s, with every
  // entry in parallel: per tile pixel the last entry centred there
  // (atomicMax of the list index), then the entries after it whose patch
  // covers the pixel (atomicAdd).  From s = 255 (centred) or the old value,
  // k such events give s - k if that is >= th, else 0: exactly the
  // sequential update, with no writer test and no walk back.  A pixel that
  // no kept event covers keeps its value (for a surface in the TOS
  // invariant, every value 0 or >= th, the closed form's clamp leaves it
  // too).
  for (int n = tid; n < n_list; n += THREADS) {
    const int ent = list[n];
    const int cx = (ent & 0xffff) - r, cy = (ent >> 16) - r;
    if (cx >= 0 && cx < TILE && cy >= 0 && cy < TILE)
      atomicMax(last + cy * TILE + cx, n);
  }
  __syncthreads();
  // Each warp takes every eighth entry and its lanes the patch pixels;
  // o / patch by a 16-bit reciprocal, exact for o < 31^2.
  const int patch = 2 * r + 1, pp = patch * patch;
  const unsigned recip = (65536u + patch - 1) / patch;
  for (int n = warp; n < n_list; n += WARPS) {
    const int ent = list[n];
    const int x0 = (ent & 0xffff) - 2 * r, y0 = (ent >> 16) - 2 * r;
    for (int o = lane; o < pp; o += 32) {
      const int dy = (int)((o * recip) >> 16), dx = o - dy * patch;
      const int tx = x0 + dx, ty = y0 + dy;
      if (tx >= 0 && tx < TILE && ty >= 0 && ty < TILE &&
          n > last[ty * TILE + tx])
        atomicAdd(cnt + ty * TILE + tx, 1);
    }
  }
  __syncthreads();
  if (!mine) return;
#pragma unroll
  for (int q4 = 0; q4 < PIX / 4; ++q4) {
    const int4 c4 = *reinterpret_cast<const int4*>(last + row * TILE + c0 +
                                                   4 * q4);
    const int4 k4 = *reinterpret_cast<const int4*>(cnt + row * TILE + c0 +
                                                   4 * q4);
    const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
    const int ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = ks[q], i = 4 * q4 + q;
      const int s = cs[q] >= 0 ? 255 : v[i];
      if (k > 0 || cs[q] >= 0) v[i] = s - k >= th ? s - k : 0;
    }
  }

  if (inject) {
    // Value-0 codes skip write-back; the xor result wraps to uint8 before
    // decoding, as the reference's astype(uint8) does.
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const int code = v[q] > 224 ? v[q] - 224 : 0;
      const uint8_t res = (uint8_t)(code > 0 ? (code ^ bv[q]) : 0);
      v[q] = res > 0 ? (uint8_t)(res + 224) : 0;
    }
  }

  if (vec) {
    *reinterpret_cast<uint4*>(tos + p0) = pack16(v);
  } else {
#pragma unroll
    for (int q = 0; q < PIX; ++q)
      if (px0 + q < W) tos[p0 + q] = (uint8_t)v[q];
  }
}

}  // namespace

// In place: tos (B,H,W) uint8 and sae (B,H,W) int32 are updated; keep and
// scores (B,E) are written.  bits / ber may be null (no BER), mask may be
// null (every lane active).  rec is scratch of B x (E rounded up to even)
// int32 pairs, 16-byte aligned; xy must be 8-byte aligned.
extern "C" int fused_step_launch(
    uint8_t* tos, int* sae, const float* lut, const int* xy, const int* ts,
    const uint8_t* valid, const int* bits, const float* ber,
    const uint8_t* mask, uint8_t* keep, float* scores, int* rec, int B,
    int H, int W, int E, int patch, int th, int support, int tw,
    int stcf_enabled, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H >= 32768 || W >= 32768 ||
      E < 1 || E > MAX_EVENTS || patch < 1 || patch > 31 ||
      patch % 2 == 0 || (bits != nullptr && ber == nullptr) ||
      (uintptr_t)xy % 8 != 0 || (uintptr_t)rec % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int E2 = E + (E & 1);   // records per lane, padded to 16 bytes
  const dim3 g1((E + WARPS - 1) / WARPS, B);
  stcf_score_kernel<<<g1, THREADS, 0, s>>>(
      reinterpret_cast<const int2*>(xy), ts, valid, sae, lut, keep, scores,
      reinterpret_cast<int2*>(rec), H, W, E, E2, support, tw, stcf_enabled);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const uintptr_t addr = (uintptr_t)tos | (uintptr_t)bits;
  const int vec = W % 16 == 0 && addr % 16 == 0;
  const size_t smem = SURF_BYTES + (size_t)E * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 g2((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fused_tile_kernel<<<g2, THREADS, smem, s>>>(
      tos, sae, reinterpret_cast<const int2*>(rec), bits, ber, mask, H, W,
      E, E2, (patch - 1) / 2, th, stcf_enabled, vec);
  return (int)cudaGetLastError();
}
