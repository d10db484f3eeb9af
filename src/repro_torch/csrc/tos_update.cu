// K4 and K6: the NMC replay of one chunk, on its own, for B lanes in one
// launch.
//
// Replaces two TPU kernels of src/repro/kernels/tos_update.py:
//   K4 `nmc_stream_call` (`_nmc_stream_kernel`): per 128x128 VMEM tile, a
//      fori_loop replays every event: patch decrement with the th clamp,
//      then centre := 255;
//   K6 `nmc_stream_binned_call`: K4 over each 128x128 tile's bin of at most
//      `cap` events (the first cap valid events, in stream order, whose
//      patch touches the tile).
// K5/K7, the closed form, have their own kernel (tos_count.cu).
//
// A pixel's value after the chunk depends only on the ordered events whose
// patch covers it, so no barrier between events is needed when each thread
// owns a pixel and replays those events itself.  One block owns a 32x8
// output tile of one lane (blockIdx.z) and works in two phases:
//
//   (1) stage: the block walks the lane's events in stream order, 256 at a
//       time.  An event "hits" the enclosing 128x128 reference tile when it
//       is valid and its patch touches that tile; its rank among the hits
//       comes from a warp ballot (__ballot_sync + __popc of the lower
//       lanes) and a scan of the eight warp totals, as in K3.  Kept = hit
//       and rank < cap.  The kept events whose patch touches the block's own
//       32x8 tile are appended, in order, to a list in shared memory as
//       coordinates relative to the tile (a second ballot).  With cap = E
//       (K4) nothing is dropped.  Ranking against the 128x128 tile and
//       not the block's sub-tile is what keeps K6 equal to the reference
//       when a tile's hits exceed cap: an event near a tile border may be
//       kept by one tile and dropped by its neighbour.
//   (2) update: each thread takes its pixel and walks the list, replaying
//       each covering event: v = v-1 >= th ? v-1 : 0, and v = 255 at its
//       centre.
//
// Invalid events are skipped; patches are clipped at the image edge (the
// reference pads to 128-multiples and crops the padding away).
//
// Bound on the H100: bytes.  Each input byte read once and each output byte
// written once: at 1280x720, B=1, E=512 that is tos in and out (1.84 MB)
// plus the events, ~0.55 us at 3.35 TB/s; the integer work (E x P^2 patch
// updates) is far below it.  This design reads every event once per block
// in phase (1) (3,600 blocks at 720p, from L2) and keeps no surface in
// shared memory; the tile update is a single coalesced pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int WARPS = THREADS / 32;
constexpr int REF_TILE = 128;   // the reference's tile: bins are per tile

// Exclusive prefix over the warps' totals in `tot`; returns the total.
__device__ __forceinline__ int warp_prefix(const int* tot, int warp,
                                           int* before) {
  int b = 0, t = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = tot[w];
    b += (w < warp) ? c : 0;
    t += c;
  }
  *before = b;
  return t;
}

__global__ void __launch_bounds__(THREADS)
nmc_tile_kernel(const uint8_t* __restrict__ tos_in,
                const int* __restrict__ xy,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ tos_out,
                int H, int W, int E, int r, int th, int cap) {
  extern __shared__ int list[];   // kept, touching events: ry << 16 | rx
  __shared__ int hit_tot[WARPS], touch_tot[WARPS];
  const int b = blockIdx.z;
  const int bx0 = blockIdx.x * TILE_W, by0 = blockIdx.y * TILE_H;
  const int tx0 = bx0 / REF_TILE * REF_TILE;
  const int ty0 = by0 / REF_TILE * REF_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int* lxy = xy + (size_t)b * E * 2;
  const uint8_t* lval = valid + (size_t)b * E;

  // (1) stage this tile's events in stream order.
  int n_hit = 0, n_list = 0;   // uniform across the block
  for (int e0 = 0; e0 < E; e0 += THREADS) {
    const int e = e0 + tid;
    int x = 0, y = 0;
    bool v = false;
    if (e < E) {
      x = lxy[2 * e];
      y = lxy[2 * e + 1];
      v = lval[e] != 0;
    }
    const bool hit = v && x >= tx0 - r && x < tx0 + REF_TILE + r &&
                     y >= ty0 - r && y < ty0 + REF_TILE + r;
    const unsigned hit_bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) hit_tot[warp] = __popc(hit_bits);
    __syncthreads();
    int before;
    const int hits = warp_prefix(hit_tot, warp, &before);
    const int rank = n_hit + before + __popc(hit_bits & lower);
    const bool touch = hit && rank < cap && x >= bx0 - r &&
                       x < bx0 + TILE_W + r && y >= by0 - r &&
                       y < by0 + TILE_H + r;
    const unsigned touch_bits = __ballot_sync(0xffffffffu, touch);
    if (lane == 0) touch_tot[warp] = __popc(touch_bits);
    __syncthreads();
    const int touches = warp_prefix(touch_tot, warp, &before);
    if (touch) {
      list[n_list + before + __popc(touch_bits & lower)] =
          ((y - by0 + r) << 16) | (x - bx0 + r);
    }
    n_hit += hits;
    n_list += touches;
    __syncthreads();   // the list is complete; the totals are rewritten next
  }

  // (2) update this thread's pixel.
  const int lx = tid % TILE_W, ly = tid / TILE_W;
  const int px = bx0 + lx, py = by0 + ly;
  if (px >= W || py >= H) return;
  const size_t p = (size_t)b * H * W + (size_t)py * W + px;
  const int cx = lx + r, cy = ly + r;   // the pixel in list coordinates
  int val = tos_in[p];
  for (int k = 0; k < n_list; ++k) {
    const int ent = list[k];
    const int ex = ent & 0xffff, ey = ent >> 16;
    if (abs(ex - cx) <= r && abs(ey - cy) <= r) {
      val = (val - 1 >= th) ? val - 1 : 0;
      if (ex == cx && ey == cy) val = 255;
    }
  }
  tos_out[p] = (uint8_t)val;
}

int launch(const uint8_t* tos_in, const int* xy, const uint8_t* valid,
           uint8_t* tos_out, int B, int H, int W, int E, int patch, int th,
           int cap, void* stream) {
  if (B < 1 || H < 1 || W < 1 || E < 1 || patch < 1 || patch > 31 ||
      patch % 2 == 0 || cap < 1 || cap > E || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  const size_t smem = (size_t)E * sizeof(int);
  nmc_tile_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tos_in, xy, valid, tos_out, H, W, E, (patch - 1) / 2, th, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: every event of the chunk (cap = E).
extern "C" int nmc_stream_launch(const uint8_t* tos_in, const int* xy,
                                 const uint8_t* valid, const int* centre,
                                 uint8_t* tos_out, int B, int H, int W,
                                 int E, int patch, int th, int cap,
                                 void* stream) {
  (void)centre;
  (void)cap;
  return launch(tos_in, xy, valid, tos_out, B, H, W, E, patch, th, E,
                stream);
}

// K6: each 128x128 tile's first `cap` hits.
extern "C" int nmc_stream_binned_launch(const uint8_t* tos_in, const int* xy,
                                        const uint8_t* valid,
                                        const int* centre, uint8_t* tos_out,
                                        int B, int H, int W, int E, int patch,
                                        int th, int cap, void* stream) {
  (void)centre;
  return launch(tos_in, xy, valid, tos_out, B, H, W, E, patch, th, cap,
                stream);
}
