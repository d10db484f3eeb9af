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
// K5/K7, the closed form with precomputed centre values, have their own
// kernel (tos_count.cu).
//
// The serial replay has a closed form, the one K1's tile pass computes
// (fused_step.cu): a pixel ends at s - k if that is >= th, else 0, where s
// is 255 when some listed event is centred on it (else its old value) and
// k counts the listed events after the last such centre whose patch covers
// it; a pixel that no such event covers keeps s.  That is the sequential
// update exactly for any surface and any th >= 0 (a value that reaches 0
// stays 0); for th < 0 values would go negative, so it is refused.
//
// One block owns a 64x64 output tile of one lane (blockIdx.z), 256
// threads, each thread 16 pixels of one row; where a chunk holds more than
// 16 events per 64x64 tile on average (DAVIS240 at E=512, not 1280x720),
// 32x32 tiles and 4 pixels a thread instead:
//
//   (1) the thread's 16-byte (4-byte) load of its pixels of tos_in is
//       issued first: the launcher is functional, so every pixel is
//       written, and the copy overlaps the staging;
//   (2) stage: the block reads the lane's events once, in stream order,
//       512 per pass (two per thread, one 16-byte load of xy and one
//       2-byte load of valid where aligned, the next pass's in flight).
//       Unless cap >= E, an event "hits" the enclosing 128x128 reference
//       tile (halo r) when it is valid and its patch touches that tile; its
//       rank among the hits comes from a warp ballot (__ballot_sync +
//       __popc of the lower lanes) and a scan of the eight warp totals, and
//       kept = hit and rank < cap.  A tile lies in one 128-tile, so the
//       rank is the reference's; with cap = E (K4) every valid event is
//       kept.  The kept events whose patch touches the block's own tile
//       (halo r) are appended to a shared-memory list in stream order (a
//       second ballot and scan; one barrier per pass, two when ranking),
//       and an entry centred in the tile leaves its list index at its
//       centre by shared-memory atomicMax (`last`, -1 where none);
//   (3) a tile with an empty list stores its pixels unchanged; otherwise
//       every listed entry at once: atomicAdd of 1 at each covered tile
//       pixel whose `last` is below the entry's index (`cnt`).  A warp
//       takes an entry and its lanes consecutive patch offsets; the tables'
//       rows are padded to TILE + patch words, so those lanes fall on 32
//       different banks;
//   (4) each thread applies the closed form to its pixels and stores them
//       with one 16-byte (4-byte) store.
//
// Invalid events are skipped; patches are clipped at the image edge (the
// reference pads to 128-multiples and crops the padding away).
//
// Bound on the H100: bytes.  Each input byte read once and each output byte
// written once: at 1280x720, B=1, E=512 that is tos in and out (1.84 MB)
// plus the events, ~0.55 us at 3.35 TB/s; the integer work (E x P^2 cover
// counts) is far below it.  The design reads each pixel once with one
// vector load issued before the staging, reads the events once per tile
// (240 blocks at 720p, from L2), and has no serial chain longer than E/512
// passes: the covers are counted in parallel.  8,192 events in one tile
// stay exact (the list and the two padded int32 tables take up to 80 KB of
// shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPT = 2;                       // events per thread per pass
constexpr int PASS = THREADS * EPT;
constexpr int REF_TILE = 128;   // the reference's tile: bins are per tile
constexpr int MAX_EVENTS = 8192;

struct Events {
  int x[EPT], y[EPT];
  bool v[EPT];
};

// Events e and e + 1 of a lane (e even); invalid past E.  `vec`: xy is
// 16-byte and valid 2-byte aligned at every even e (E even).
__device__ __forceinline__ void load_events(const int* lxy,
                                            const uint8_t* lval, int E,
                                            int e, int vec, Events& ev) {
  if (vec) {
    int4 p = make_int4(0, 0, 0, 0);
    unsigned m = 0;
    if (e < E) {
      p = *reinterpret_cast<const int4*>(lxy + 2 * e);
      m = *reinterpret_cast<const unsigned short*>(lval + e);
    }
    ev.x[0] = p.x;
    ev.y[0] = p.y;
    ev.x[1] = p.z;
    ev.y[1] = p.w;
    ev.v[0] = (m & 0xffu) != 0;
    ev.v[1] = (m >> 8) != 0;
  } else {
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      ev.x[q] = ev.y[q] = 0;
      ev.v[q] = false;
      if (e + q < E) {
        ev.x[q] = lxy[2 * (e + q)];
        ev.y[q] = lxy[2 * (e + q) + 1];
        ev.v[q] = lval[e + q] != 0;
      }
    }
  }
}

// PIX (16 or 4) bytes of one row: one 16- or 4-byte access.
template <int PIX>
__device__ __forceinline__ void load_px(const uint8_t* p, int (&v)[PIX]) {
  unsigned u[PIX / 4];
  if constexpr (PIX == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    u[0] = w.x;
    u[1] = w.y;
    u[2] = w.z;
    u[3] = w.w;
  } else {
    u[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int q = 0; q < PIX; ++q) v[q] = (u[q >> 2] >> (8 * (q & 3))) & 0xffu;
}

template <int PIX>
__device__ __forceinline__ void store_px(uint8_t* p, const int (&v)[PIX]) {
  unsigned u[PIX / 4] = {};
#pragma unroll
  for (int q = 0; q < PIX; ++q)
    u[q >> 2] |= (unsigned)(v[q] & 0xff) << (8 * (q & 3));
  if constexpr (PIX == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    *reinterpret_cast<unsigned*>(p) = u[0];
  }
}

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

// One TILE x TILE tile of one lane.  The two int32 tables have a row
// stride of S = TILE + patch words: the lanes of a warp take consecutive
// offsets o = dy * patch + dx of one entry's patch, at banks o mod 32.
template <int TILE>
__global__ void __launch_bounds__(THREADS)
nmc_tile_kernel(const uint8_t* __restrict__ tos_in,
                const int* __restrict__ xy,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ tos_out, int H, int W, int E, int r,
                int th, int cap, int vec_ev, int vec_px) {
  constexpr int PIX = TILE * TILE / THREADS;   // 16 or 4 pixels of a row
  constexpr int ROW_T = TILE / PIX;            // threads per tile row
  const int patch = 2 * r + 1, S = TILE + patch;
  extern __shared__ __align__(16) int smem[];
  int* last = smem;                     // [TILE][S]: last centred entry
  int* cnt = smem + TILE * S;           // [TILE][S]: covers after it
  int* list = smem + 2 * TILE * S;      // kept, touching: ry << 16 | rx
  __shared__ int hit_tot[2][WARPS], touch_tot[2][WARPS];
  const int b = blockIdx.z;
  const int bx0 = blockIdx.x * TILE, by0 = blockIdx.y * TILE;
  const int tx0 = bx0 / REF_TILE * REF_TILE;
  const int ty0 = by0 / REF_TILE * REF_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int* lxy = xy + (size_t)b * E * 2;
  const uint8_t* lval = valid + (size_t)b * E;
  const bool ranked = cap < E;   // else every valid event is kept

  // The first pass's events are loaded first; each pass loads the next
  // one's while it ranks its own.
  Events nxt;
  load_events(lxy, lval, E, tid * EPT, vec_ev, nxt);

  // This thread's pixels, row `row` of the tile, columns c0 .. c0 + PIX-1:
  // their load is in flight while the events are staged.
  const int row = tid / ROW_T, c0 = (tid % ROW_T) * PIX;
  const int py = by0 + row, px0 = bx0 + c0;
  const bool mine = py < H && px0 < W;
  const size_t p0 = (size_t)b * H * W + (size_t)py * W + px0;
  int v[PIX];
  if (mine) {
    if (vec_px) {
      load_px<PIX>(tos_in + p0, v);
    } else {
#pragma unroll
      for (int q = 0; q < PIX; ++q) v[q] = px0 + q < W ? tos_in[p0 + q] : 0;
    }
  }
  // No centred entry (-1) and no count yet, for every tile pixel.
  for (int k = tid; k < TILE * S / 4; k += THREADS) {
    reinterpret_cast<int4*>(last)[k] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(cnt)[k] = make_int4(0, 0, 0, 0);
  }

  // Stage the kept events touching the tile, in stream order (thread t of
  // a pass holds events 2t and 2t + 1); an entry centred in the tile
  // leaves its list index at its centre (atomicMax: the last one wins).
  int n_hit = 0, n_list = 0;   // uniform across the block
  for (int e0 = 0, pass = 0; e0 < E; e0 += PASS, ++pass) {
    const Events ev = nxt;
    if (e0 + PASS < E)
      load_events(lxy, lval, E, e0 + PASS + tid * EPT, vec_ev, nxt);
    bool kept[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) kept[q] = ev.v[q];
    if (ranked) {   // uniform
      bool hit[EPT];
      int h_t = 0, h_lo = 0;
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        hit[q] = ev.v[q] && ev.x[q] >= tx0 - r &&
                 ev.x[q] < tx0 + REF_TILE + r && ev.y[q] >= ty0 - r &&
                 ev.y[q] < ty0 + REF_TILE + r;
        const unsigned hb = __ballot_sync(0xffffffffu, hit[q]);
        h_t += __popc(hb);
        h_lo += __popc(hb & lower);
      }
      int* ht = hit_tot[pass & 1];
      if (lane == 0) ht[warp] = h_t;
      __syncthreads();
      int before;
      const int hits = warp_prefix(ht, warp, &before);
      int rank = n_hit + before + h_lo;
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        kept[q] = hit[q] && rank < cap;
        rank += hit[q];
      }
      n_hit += hits;
    }
    bool touch[EPT];
    int t_t = 0, t_lo = 0;
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      touch[q] = kept[q] && ev.x[q] >= bx0 - r && ev.x[q] < bx0 + TILE + r &&
                 ev.y[q] >= by0 - r && ev.y[q] < by0 + TILE + r;
      const unsigned tb = __ballot_sync(0xffffffffu, touch[q]);
      t_t += __popc(tb);
      t_lo += __popc(tb & lower);
    }
    int* tt = touch_tot[pass & 1];
    if (lane == 0) tt[warp] = t_t;
    __syncthreads();   // also orders the tables' set-up before the atomics
    int before;
    const int touches = warp_prefix(tt, warp, &before);
    int pos = n_list + before + t_lo;
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      if (touch[q]) {
        const int cx = ev.x[q] - bx0, cy = ev.y[q] - by0;
        list[pos] = ((cy + r) << 16) | (cx + r);
        if (cx >= 0 && cx < TILE && cy >= 0 && cy < TILE)
          atomicMax(last + cy * S + cx, pos);
        ++pos;
      }
    }
    n_list += touches;
  }
  __syncthreads();   // the list and the centres are complete

  if (n_list > 0) {   // uniform
    // Per tile pixel the entries after its last centred one whose patch
    // covers it (atomicAdd): exact in any order.  Each warp takes every
    // eighth entry and its lanes the patch pixels, two offsets a lane per
    // step with both `last` reads issued before either atomic and the
    // warp's next entry read ahead; o / patch by a 16-bit reciprocal, exact
    // for o < 31^2.
    const int pp = patch * patch;
    const unsigned recip = (65536u + patch - 1) / patch;
    int ent = warp < n_list ? list[warp] : 0;
    for (int n = warp; n < n_list; n += WARPS) {
      const int ahead = n + WARPS < n_list ? list[n + WARPS] : 0;
      const int x0 = (ent & 0xffff) - 2 * r, y0 = (ent >> 16) - 2 * r;
      for (int o = lane; o < pp; o += 64) {
        int at[2];
        bool in[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ok = o + 32 * k;
          const int dy = (int)((ok * recip) >> 16), dx = ok - dy * patch;
          const int tx = x0 + dx, ty = y0 + dy;
          in[k] = ok < pp && tx >= 0 && tx < TILE && ty >= 0 && ty < TILE;
          at[k] = in[k] ? ty * S + tx : 0;
        }
        const int l0 = last[at[0]], l1 = last[at[1]];
        if (in[0] && n > l0) atomicAdd(cnt + at[0], 1);
        if (in[1] && n > l1) atomicAdd(cnt + at[1], 1);
      }
      ent = ahead;
    }
    __syncthreads();
    if (mine) {
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        const int k = cnt[row * S + c0 + q];
        const int s = last[row * S + c0 + q] >= 0 ? 255 : v[q];
        v[q] = k == 0 ? s : (s - k >= th ? s - k : 0);
      }
    }
  }

  if (!mine) return;
  if (vec_px) {
    store_px<PIX>(tos_out + p0, v);
  } else {
#pragma unroll
    for (int q = 0; q < PIX; ++q)
      if (px0 + q < W) tos_out[p0 + q] = (uint8_t)v[q];
  }
}

template <int TILE>
int launch_tiles(const uint8_t* tos_in, const int* xy, const uint8_t* valid,
                 uint8_t* tos_out, int B, int H, int W, int E, int patch,
                 int th, int cap, cudaStream_t stream) {
  constexpr int PIX = TILE * TILE / THREADS;
  const int vec_ev = E % 2 == 0 && (uintptr_t)xy % 16 == 0 &&
                     (uintptr_t)valid % 2 == 0;
  const int vec_px = W % PIX == 0 &&
                     ((uintptr_t)tos_in | (uintptr_t)tos_out) % PIX == 0;
  const size_t smem = (2 * (size_t)TILE * (TILE + patch) + E) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nmc_tile_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  nmc_tile_kernel<TILE><<<grid, THREADS, smem, stream>>>(
      tos_in, xy, valid, tos_out, H, W, E, (patch - 1) / 2, th, cap, vec_ev,
      vec_px);
  return (int)cudaGetLastError();
}

int launch(const uint8_t* tos_in, const int* xy, const uint8_t* valid,
           uint8_t* tos_out, int B, int H, int W, int E, int patch, int th,
           int cap, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || E < 1 || E > MAX_EVENTS ||
      patch < 1 || patch > 31 || patch % 2 == 0 || th < 0 || cap < 1 ||
      cap > E)
    return (int)cudaErrorInvalidValue;
  // 64x64 tiles, unless a lane's chunk holds more than 16 events per 64x64
  // tile on average: then 32x32, whose lists are shorter and whose blocks
  // are four times as many (DAVIS240: 48 blocks a lane, not 12).
  const long tiles64 = (long)((H + 63) / 64) * ((W + 63) / 64);
  const bool small = E > 16 * tiles64;
  cudaStream_t s = (cudaStream_t)stream;
  return small ? launch_tiles<32>(tos_in, xy, valid, tos_out, B, H, W, E,
                                  patch, th, cap, s)
               : launch_tiles<64>(tos_in, xy, valid, tos_out, B, H, W, E,
                                  patch, th, cap, s);
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
