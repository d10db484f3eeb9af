// K3: stream compaction of dense result rows into kept-event records.
//
// Replaces the TPU kernel `compact_slots_call` (`_compact_kernel`) in
// src/repro/kernels/compact.py.  For each of L rows of E events (a ring
// push's lanes) it writes record j = (index, score) of the row's j-th kept
// event in stream order, for j < cap; records past the kept count read
// idx = 0, val = -inf; count[row] is the TOTAL kept, so count > cap tells
// the caller to fall back to the dense row.
//
// The TPU kernel walks a row with a serial fori_loop, one lane per grid
// step.  Here one block owns a row and walks it in tiles of THREADS events:
// each thread tests one event, a warp ranks its kept events with
// __ballot_sync and __popc of the lower lanes, the warp totals are scanned
// in shared memory, and a running offset carries the rank across tiles.  A
// thread whose rank is below cap writes its record; then the same block
// fills the unused records.  Stream order is exact by construction.
//
// Bound on the H100: bytes.  Per row the inputs are the E keep bytes and
// the float32 scores of the first min(kept, cap) kept events (no other
// score is read), the outputs cap * 8 + 4 bytes; at the pool's shapes
// (4 to 16 rows of 512) launch latency dominates.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void compact_kernel(const float* __restrict__ scores,
                               const uint8_t* __restrict__ keep,
                               int32_t* __restrict__ idx,
                               float* __restrict__ val,
                               int32_t* __restrict__ count, int E, int cap) {
  __shared__ int warp_total[WARPS];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* s = scores + (size_t)row * E;
  const uint8_t* k = keep + (size_t)row * E;
  int32_t* oi = idx + (size_t)row * cap;
  float* ov = val + (size_t)row * cap;

  int base = 0;  // kept events in the tiles before this one
  for (int t0 = 0; t0 < E; t0 += THREADS) {
    const int e = t0 + tid;
    const bool kept = e < E && k[e] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    const int below = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tile = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_total[w];
      before += (w < warp) ? c : 0;
      tile += c;
    }
    const int rank = base + before + below;
    if (kept && rank < cap) {
      oi[rank] = e;
      ov[rank] = s[e];
    }
    base += tile;
    __syncthreads();  // warp_total is rewritten by the next tile
  }
  for (int j = min(base, cap) + tid; j < cap; j += THREADS) {
    oi[j] = 0;
    ov[j] = -INFINITY;
  }
  if (tid == 0) count[row] = base;
}

}  // namespace

extern "C" int compact_launch(const float* scores, const uint8_t* keep,
                              int32_t* idx, float* val, int32_t* count,
                              int L, int E, int cap, cudaStream_t stream) {
  if (L < 1 || E < 1 || cap < 1 || cap > E) return (int)cudaErrorInvalidValue;
  compact_kernel<<<L, THREADS, 0, stream>>>(scores, keep, idx, val, count, E,
                                            cap);
  return (int)cudaGetLastError();
}
