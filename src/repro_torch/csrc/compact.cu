// K3: stream compaction of dense result rows into kept-event records, and
// the serving pool's ring push built on it.
//
// Replaces the TPU kernel `compact_slots_call` (`_compact_kernel`) in
// src/repro/kernels/compact.py, and the ring update that XLA fuses around
// it (`ring_push` / `ring_push_compact`, src/repro/core/state.py).  For
// each of L rows of E events (a round's lanes) record j = (index, score) is
// the row's j-th kept event in stream order, for j < cap; records past the
// kept count read idx = 0, val = -inf; the count is the TOTAL kept, so
// count > cap tells the caller to fall back to the dense row.
//
// The TPU kernel walks a row with a serial fori_loop, one lane per grid
// step.  Here one block owns a row and walks it in tiles of THREADS events
// (`compact_row`): each thread tests one event, a warp ranks its kept
// events with __ballot_sync and __popc of the lower lanes, the warp totals
// are scanned in shared memory, and a running offset carries the rank
// across tiles.  A thread whose rank is below cap writes its record; then
// the same block fills the unused records.  Stream order is exact by
// construction.  `compact_kernel` is the TPU kernel's function,
// (L, E) -> (idx, val, count).
//
// `ring_push_kernel` is a whole ring push in one launch, where the plain
// version takes 14 (a head copy, one index_copy_ per dense leaf, seven
// cursor updates; on a compact ring two more copies and the compaction).
// One block per lane row copies the row's dense leaves into slot `head`
// (16-byte vectors where both sides are aligned) and ranks the row's
// records straight into the slot's (c_idx, c_val) with `compact_row`
// (COMPACT = true: the compact readout's ring).  Each block's cursor
// thread reads head and count, then, behind a __threadfence(), takes a
// ticket while the others copy; the last block to take one advances head,
// count and dropped and puts the ticket back to 0, so the next push (and a
// recycled ring) starts clean.  Every head read comes before its block's
// ticket, so no block can read the head the last block writes.
//
// Bound on the H100: bytes.  Per row the inputs are the E keep bytes and
// the float32 scores (of the first min(kept, cap) kept events for the
// compaction alone; all of them for the push's dense copy), the outputs
// cap * 8 + 4 bytes (+ the dense row for the push).  At the pool's shapes
// (4 to 16 rows of 512) the launch's own latency dominates.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Record j < cap of row (s, k) is its j-th kept event (index, score); the
// records past min(kept, cap) read (0, -inf).  Returns the total kept.
// Every thread of the block calls it (it holds __syncthreads).
__device__ int compact_row(const float* __restrict__ s,
                           const uint8_t* __restrict__ k,
                           int32_t* __restrict__ oi, float* __restrict__ ov,
                           int E, int cap, int* warp_total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  return base;
}

__global__ void __launch_bounds__(THREADS)
compact_kernel(const float* __restrict__ scores,
               const uint8_t* __restrict__ keep, int32_t* __restrict__ idx,
               float* __restrict__ val, int32_t* __restrict__ count, int E,
               int cap) {
  __shared__ int warp_total[WARPS];
  const size_t row = blockIdx.x;
  const int kept = compact_row(scores + row * E, keep + row * E,
                               idx + row * cap, val + row * cap, E, cap,
                               warp_total);
  if (threadIdx.x == 0) count[row] = kept;
}

}  // namespace

// One result ring (repro_torch.core.state.RingState / CompactRingState);
// kernels/compact.py mirrors this layout in a ctypes Structure.
struct Ring {
  float* scores;      // (R, L, E)
  uint8_t* keep;      // (R, L, E) bool
  int32_t* n_kept;    // (R, L)
  int32_t* vdd_idx;   // (R, L)
  int32_t* n_valid;   // (R, L)
  uint8_t* mask;      // (R, L) bool
  int32_t* cursors;   // head, count, dropped, the push's ticket
  int32_t* c_idx;     // (R, L, cap); null in a dense ring
  float* c_val;       // (R, L, cap)
  int rounds, lanes, events, cap;
};

// One round's lane rows, as the detector step leaves them.
struct Round {
  const float* scores;     // (L, E)
  const uint8_t* keep;     // (L, E) bool
  const int32_t* n_kept;   // (L,)
  const int32_t* vdd_idx;  // (L,)
  const int32_t* n_valid;  // (L,)
  const uint8_t* mask;     // (L,) bool
};

namespace {

// dst[0:n] = src[0:n] by the block: 16-byte vectors when both rows and
// the byte count allow them, else element by element.
template <typename T>
__device__ void copy_row(T* __restrict__ dst, const T* __restrict__ src,
                         int n) {
  const size_t bytes = (size_t)n * sizeof(T);
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
        bytes) & 15) == 0) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < (int)(bytes / 16); i += THREADS) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

// The thread that reads and advances the cursors: the block's last, whose
// warp has the least of the row copy to do.
constexpr int CURSOR_THREAD = THREADS - 1;

template <bool COMPACT>
__global__ void __launch_bounds__(THREADS)
ring_push_kernel(Ring ring, Round in) {
  __shared__ int warp_total[WARPS];
  __shared__ int head;
  const int lane = blockIdx.x, tid = threadIdx.x, E = ring.events;
  int count = 0;
  if (tid == CURSOR_THREAD) {
    head = ring.cursors[0];
    count = ring.cursors[1];
    if (head < 0 || head >= ring.rounds) __trap();  // a corrupt cursor
    __threadfence();  // this block's head read comes before its ticket
  }
  __syncthreads();
  const int slot = head;
  if (tid == CURSOR_THREAD) {
    // Every block has read head before it takes a ticket, so the last
    // block to take one may advance the cursors while the slot is written.
    unsigned* ticket = reinterpret_cast<unsigned*>(ring.cursors + 3);
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      ring.cursors[2] += count == ring.rounds;  // overwrote an undrained slot
      ring.cursors[1] = min(count + 1, ring.rounds);
      ring.cursors[0] = (slot + 1) % ring.rounds;
      *ticket = 0;
    }
  }
  const size_t row = (size_t)slot * ring.lanes + lane;
  const float* s = in.scores + (size_t)lane * E;
  const uint8_t* k = in.keep + (size_t)lane * E;
  copy_row(ring.scores + row * E, s, E);
  copy_row(ring.keep + row * E, k, E);
  if (tid == 0) {
    ring.n_kept[row] = in.n_kept[lane];
    ring.vdd_idx[row] = in.vdd_idx[lane];
    ring.n_valid[row] = in.n_valid[lane];
    ring.mask[row] = in.mask[lane];
  }
  if (COMPACT) {
    compact_row(s, k, ring.c_idx + row * ring.cap, ring.c_val + row * ring.cap,
                E, ring.cap, warp_total);
  }
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

extern "C" int ring_push_launch(const Ring* ring, const float* scores,
                                const uint8_t* keep, const int32_t* n_kept,
                                const int32_t* vdd_idx,
                                const int32_t* n_valid, const uint8_t* mask,
                                cudaStream_t stream) {
  const Round in{scores, keep, n_kept, vdd_idx, n_valid, mask};
  if (ring->rounds < 1 || ring->lanes < 1 || ring->events < 1)
    return (int)cudaErrorInvalidValue;
  if (ring->c_idx != nullptr) {
    if (ring->cap < 1 || ring->cap > ring->events)
      return (int)cudaErrorInvalidValue;
    ring_push_kernel<true><<<ring->lanes, THREADS, 0, stream>>>(*ring, in);
  } else {
    ring_push_kernel<false><<<ring->lanes, THREADS, 0, stream>>>(*ring, in);
  }
  return (int)cudaGetLastError();
}
