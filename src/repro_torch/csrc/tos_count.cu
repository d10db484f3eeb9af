// K5 and K7: the closed-form TOS update of one chunk, cover counts on the
// tensor cores, for B lanes in one launch.
//
// Replaces two TPU kernels of src/repro/kernels/tos_update.py:
//   K5 `batched_fused_call` (:328, `_batched_fused_kernel_vmem`): per
//      128x128 tile, k_total = RowBand^T @ ColBand as a float32 one-hot
//      matmul on the MXU, then clamp(tos - k_total) at th with the
//      precomputed centre values overlaid;
//   K7 `batched_fused_binned_call` (:292): K5 over each 128x128 tile's bin
//      of at most `cap` events (the first cap valid events, in stream order,
//      whose patch touches the tile, halo r).
//
// Per pixel: count = the valid (kept) events whose P x P patch covers it;
// v = tos - count; v = v >= th ? v : 0 on every pixel (count 0 included);
// v = centre where centre >= 0.  The centre surface (last-writer values, -1
// elsewhere) comes from the caller, as in the reference's wrapper.
//
// Bound on the H100: bytes.  tos read and written, the int32 centre read
// once, the events read once: at 1280x720, B=1, E=512 that is 5.53 MB, 1.65
// us at 3.35 TB/s.  The counts are 0/1 products, far below the tensor-core
// rate.  The design keeps every SM's copies in flight from the first cycle
// and does the rest under them:
//
//   * One block of 256 threads owns a 64x64 output tile of one lane
//     (blockIdx.z); 64 divides 128, so a tile lies in one reference tile
//     and K7's rank stays a prefix count over that tile's hits.  At
//     1280x720 that is 240 blocks, at most two per SM: one wave.
//   * (0) The block's tos (uint8) and centre (int32) tiles go to shared
//     memory with 16-byte `cp.async` copies issued first and waited for only
//     in the epilogue (scalar copies where W is not a multiple of 16).  TMA
//     would need a tensor map built on the host per call and buys nothing
//     over cp.async at 20 KB per block.
//   * (1) The block reads its lane's events once, 512 per pass (two per
//     thread).  The first pass is loaded before the copies are issued, so
//     that it does not queue behind them, and each pass prefetches the next
//     (tools/tos_count_phases.py times the order the other way round).  An
//     event hits the enclosing 128x128 reference tile when it is valid and
//     its patch touches that tile; its rank among the hits comes from warp
//     ballots and a scan of the eight warp totals.  Kept = hit and rank <
//     cap (cap = E for K5).  Kept events whose patch touches the
//     block's own tile are appended, in stream order, to a shared-memory
//     list as tile-relative (x + r, y + r), padded with a sentinel that
//     covers nothing to a multiple of 32.  One barrier per pass while the
//     cap is not crossed; a pass past the cap ends the scan.
//   * (2) The list is taken 32 events at a time.  The block builds the row
//     band (64 tile rows x 32 events) and the column band (64 tile cols x
//     32 events) as fp16 0/1 in shared memory, double-buffered, so each
//     chunk costs one barrier; each thread builds 8 entries of each band
//     with one unsigned compare apiece and two 16-byte stores.  Each of the
//     8 warps owns a 16x32 piece of the tile (4 n-tiles of 8) and runs
//     `mma.sync.m16n8k16` f16 x f16 -> f32 on fragments read by `ldmatrix`:
//     per chunk 6 ldmatrix.x4 and 8 mma per warp.  0/1 operands summed in
//     fp32 are exact up to 2^24, far above the 8,192 events a chunk can
//     hold.  An empty list skips the loop, never the epilogue.
//   * (3) Epilogue: each thread reads its accumulator fragments' tos and
//     centre from the staged tiles, applies subtract, threshold and overlay,
//     writes the uint8 result over the staged tos, and the block stores the
//     tile with 16-byte stores.
//
// `mma.sync` and not `wgmma`: a tile's list is short on a sparse chunk (a
// few dozen events at HD), so the k-loop is a few steps; wgmma's 64-row
// warpgroup tiles and descriptors would add set-up latency and buy rate the
// kernel cannot use, its time being the surface copies.  Row strides in
// shared memory are padded (bands 80 B, tos 80 B, centre 288 B) so that
// ldmatrix, the band stores and the epilogue's fragment reads are free of
// bank conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // output tile edge (rows and cols)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPT = 2;            // events per thread per staging pass
constexpr int PASS = THREADS * EPT;
constexpr int KC = 32;            // events per band chunk
constexpr int REF_TILE = 128;     // the reference's tile: bins are per tile
constexpr int MAX_EVENTS = 8192;

constexpr int TOS_STRIDE = TILE + 16;   // bytes per staged tos row
constexpr int CEN_STRIDE = TILE + 8;    // int32 per staged centre row
constexpr int BAND_STRIDE = KC + 8;     // fp16 per band row
constexpr int TOS_OFF = 0;
constexpr int CEN_OFF = TOS_OFF + TILE * TOS_STRIDE;
constexpr int BAND_OFF = CEN_OFF + TILE * CEN_STRIDE * 4;
constexpr int BAND_BYTES = TILE * BAND_STRIDE * 2;      // one band
constexpr int TOT_OFF = BAND_OFF + 2 * 2 * BAND_BYTES;  // 2 buffers x 2 bands
constexpr int LIST_OFF = TOT_OFF + 2 * 3 * WARPS * 4;   // 2 parities x 3 sums
constexpr int SENTINEL = 0x7fff7fff;    // (x, y) that covers no tile pixel
constexpr uint32_t ONE_LO = 0x3C00u;    // fp16 1.0 in the low half
constexpr uint32_t ONE_HI = 0x3C000000u;

static_assert(CEN_OFF % 16 == 0 && BAND_OFF % 16 == 0 && LIST_OFF % 16 == 0,
              "shared-memory regions must be 16-B aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Events e .. e + EPT - 1 of a lane (invalid past E).
__device__ __forceinline__ void load_events(const int* lxy,
                                            const uint8_t* lval, int E,
                                            int e, int (&x)[EPT],
                                            int (&y)[EPT], bool (&v)[EPT]) {
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const bool in = e + i < E;
    x[i] = in ? lxy[2 * (e + i)] : 0;
    y[i] = in ? lxy[2 * (e + i) + 1] : 0;
    v[i] = in && lval[e + i] != 0;
  }
}

// Two packed fp16 0/1 values: whether events `lo` and `hi` (one relative
// coordinate each, + r) cover tile row or column `m`.
__device__ __forceinline__ uint32_t band2(int lo, int hi, int m, int span) {
  return ((unsigned)(lo - m) <= (unsigned)span ? ONE_LO : 0u) |
         ((unsigned)(hi - m) <= (unsigned)span ? ONE_HI : 0u);
}

__global__ void __launch_bounds__(THREADS)
tos_count_kernel(const uint8_t* __restrict__ tos_in,
                 const int* __restrict__ xy,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ centre,
                 uint8_t* __restrict__ tos_out,
                 int H, int W, int E, int r, int th, int cap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* tos_s = smem + TOS_OFF;
  int* cen_s = reinterpret_cast<int*>(smem + CEN_OFF);
  uint16_t* bands = reinterpret_cast<uint16_t*>(smem + BAND_OFF);
  int* tots = reinterpret_cast<int*>(smem + TOT_OFF);  // hit, touch, kept
  int* list = reinterpret_cast<int*>(smem + LIST_OFF);

  const int b = blockIdx.z;
  const int bx0 = blockIdx.x * TILE, by0 = blockIdx.y * TILE;
  const int tx0 = bx0 / REF_TILE * REF_TILE;
  const int ty0 = by0 / REF_TILE * REF_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const size_t off = (size_t)b * H * W;
  const int* lxy = xy + (size_t)b * E * 2;
  const uint8_t* lval = valid + (size_t)b * E;

  // The first pass's events are loaded before the surface copies are
  // issued, so that they do not queue behind 20 KB of copies; each pass
  // loads the next one's while it ranks its own.
  int nx[EPT], ny[EPT];
  bool nv[EPT];
  load_events(lxy, lval, E, tid * EPT, nx, ny, nv);

  // (0) the surface tiles -> shared memory.
  if (vec) {
    {
      const int row = tid >> 2, cc = (tid & 3) * 16;
      const int gy = by0 + row, gx = bx0 + cc;
      const bool in = gy < H && gx < W;
      cp_async16(tos_s + row * TOS_STRIDE + cc,
                 in ? tos_in + off + (size_t)gy * W + gx : tos_in, in);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 4, cc = (c & 15) * 4;
      const int gy = by0 + row, gx = bx0 + cc;
      const bool in = gy < H && gx < W;
      cp_async16(cen_s + row * CEN_STRIDE + cc,
                 in ? centre + off + (size_t)gy * W + gx : centre, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = tid; i < TILE * TILE; i += THREADS) {
      const int row = i / TILE, col = i % TILE;
      const int gy = by0 + row, gx = bx0 + col;
      const bool in = gy < H && gx < W;
      const size_t p = off + (size_t)gy * W + gx;
      tos_s[row * TOS_STRIDE + col] = in ? tos_in[p] : 0;
      cen_s[row * CEN_STRIDE + col] = in ? centre[p] : -1;
    }
  }

  // (1) stage this tile's kept events in stream order.
  int n_hit = 0, n_list = 0;   // uniform across the block
  for (int e0 = 0, pass = 0; e0 < E; e0 += PASS, ++pass) {
    int* tot = tots + (pass & 1) * 3 * WARPS;   // warps' sums, this pass
    int x[EPT], y[EPT];
    bool hit[EPT], touch[EPT];
    unsigned hb[EPT], tb[EPT];
    bool v[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      x[i] = nx[i];
      y[i] = ny[i];
      v[i] = nv[i];
    }
    if (e0 + PASS < E)
      load_events(lxy, lval, E, e0 + PASS + tid * EPT, nx, ny, nv);
    int n_h = 0, n_t = 0, h_lo = 0, t_lo = 0;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      hit[i] = v[i] && x[i] >= tx0 - r && x[i] < tx0 + REF_TILE + r &&
               y[i] >= ty0 - r && y[i] < ty0 + REF_TILE + r;
      touch[i] = hit[i] && x[i] >= bx0 - r && x[i] < bx0 + TILE + r &&
                 y[i] >= by0 - r && y[i] < by0 + TILE + r;
      hb[i] = __ballot_sync(0xffffffffu, hit[i]);
      tb[i] = __ballot_sync(0xffffffffu, touch[i]);
      n_h += __popc(hb[i]);
      n_t += __popc(tb[i]);
      h_lo += __popc(hb[i] & lower);
      t_lo += __popc(tb[i] & lower);
    }
    if (lane == 0) {
      tot[warp] = n_h;
      tot[WARPS + warp] = n_t;
    }
    __syncthreads();
    int h_before, t_before;
    const int hits = warp_prefix(tot, warp, &h_before);
    const int touches = warp_prefix(tot + WARPS, warp, &t_before);
    if (n_hit + hits <= cap) {   // every hit of this pass is kept
      int pos = n_list + t_before + t_lo;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (touch[i])
          list[pos++] = ((y[i] - by0 + r) << 16) | (x[i] - bx0 + r);
      }
      n_list += touches;
    } else {                     // the pass crosses cap
      int rank = n_hit + h_before + h_lo;
      bool kept[EPT];
      unsigned kb[EPT];
      int n_k = 0, k_lo = 0;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        kept[i] = touch[i] && rank < cap;
        rank += hit[i];
        kb[i] = __ballot_sync(0xffffffffu, kept[i]);
        n_k += __popc(kb[i]);
        k_lo += __popc(kb[i] & lower);
      }
      if (lane == 0) tot[2 * WARPS + warp] = n_k;
      __syncthreads();
      int k_before;
      const int n_kept = warp_prefix(tot + 2 * WARPS, warp, &k_before);
      int pos = n_list + k_before + k_lo;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (kept[i])
          list[pos++] = ((y[i] - by0 + r) << 16) | (x[i] - bx0 + r);
      }
      n_list += n_kept;
    }
    n_hit += hits;
    if (n_hit >= cap) break;     // no later hit is kept
  }
  const int n_chunks = (n_list + KC - 1) / KC;
  for (int i = n_list + tid; i < n_chunks * KC; i += THREADS)
    list[i] = SENTINEL;
  __syncthreads();               // the list is complete

  // (2) counts: RowBand^T @ ColBand on the tensor cores, 32 events a chunk.
  const int span = 2 * r;
  const int mi = warp & 3, nh = warp >> 2;   // this warp's 16x32 piece
  const int bm = tid & (TILE - 1), bk = (tid >> 6) * 8;   // my band entries
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    uint16_t* rb = bands + (c & 1) * 2 * (TILE * BAND_STRIDE);
    uint16_t* cb = rb + TILE * BAND_STRIDE;
    const int4 e_lo = *reinterpret_cast<const int4*>(list + c * KC + bk);
    const int4 e_hi = *reinterpret_cast<const int4*>(list + c * KC + bk + 4);
    const int ent[8] = {e_lo.x, e_lo.y, e_lo.z, e_lo.w,
                        e_hi.x, e_hi.y, e_hi.z, e_hi.w};
    uint4 rw, cw;
    rw.x = band2(ent[0] >> 16, ent[1] >> 16, bm, span);
    rw.y = band2(ent[2] >> 16, ent[3] >> 16, bm, span);
    rw.z = band2(ent[4] >> 16, ent[5] >> 16, bm, span);
    rw.w = band2(ent[6] >> 16, ent[7] >> 16, bm, span);
    cw.x = band2(ent[0] & 0xffff, ent[1] & 0xffff, bm, span);
    cw.y = band2(ent[2] & 0xffff, ent[3] & 0xffff, bm, span);
    cw.z = band2(ent[4] & 0xffff, ent[5] & 0xffff, bm, span);
    cw.w = band2(ent[6] & 0xffff, ent[7] & 0xffff, bm, span);
    *reinterpret_cast<uint4*>(rb + bm * BAND_STRIDE + bk) = rw;
    *reinterpret_cast<uint4*>(cb + bm * BAND_STRIDE + bk) = cw;
    __syncthreads();   // one barrier a chunk: the other buffer is free
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, rb + (16 * mi + (lane & 15)) * BAND_STRIDE + kk +
                         (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cb + (32 * nh + 16 * jp + ((lane >> 4) << 3) +
                              (lane & 7)) * BAND_STRIDE +
                             kk + ((lane >> 3) & 1) * 8);
        mma_16816(acc[2 * jp], a, bf[0], bf[1]);
        mma_16816(acc[2 * jp + 1], a, bf[2], bf[3]);
      }
    }
  }

  // (3) epilogue: subtract, threshold, centre overlay; store the tile.
  if (vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mi + g + 8 * h;
      const int col = 32 * nh + 8 * j + 2 * t4;
      uint16_t* tp = reinterpret_cast<uint16_t*>(tos_s + row * TOS_STRIDE +
                                                 col);
      const int2 cen =
          *reinterpret_cast<const int2*>(cen_s + row * CEN_STRIDE + col);
      const unsigned pair = *tp;
      int v0 = (int)(pair & 0xffu) - __float2int_rn(acc[j][2 * h]);
      int v1 = (int)(pair >> 8) - __float2int_rn(acc[j][2 * h + 1]);
      v0 = v0 >= th ? v0 : 0;
      v1 = v1 >= th ? v1 : 0;
      if (cen.x >= 0) v0 = cen.x;
      if (cen.y >= 0) v1 = cen.y;
      *tp = (uint16_t)((v0 & 0xff) | ((v1 & 0xff) << 8));
    }
  }
  __syncthreads();
  if (vec) {
    const int row = tid >> 2, cc = (tid & 3) * 16;
    const int gy = by0 + row, gx = bx0 + cc;
    if (gy < H && gx < W)
      *reinterpret_cast<uint4*>(tos_out + off + (size_t)gy * W + gx) =
          *reinterpret_cast<const uint4*>(tos_s + row * TOS_STRIDE + cc);
  } else {
    for (int i = tid; i < TILE * TILE; i += THREADS) {
      const int row = i / TILE, col = i % TILE;
      const int gy = by0 + row, gx = bx0 + col;
      if (gy < H && gx < W)
        tos_out[off + (size_t)gy * W + gx] = tos_s[row * TOS_STRIDE + col];
    }
  }
}

int launch(const uint8_t* tos_in, const int* xy, const uint8_t* valid,
           const int* centre, uint8_t* tos_out, int B, int H, int W, int E,
           int patch, int th, int cap, void* stream) {
  if (B < 1 || H < 1 || W < 1 || E < 1 || E > MAX_EVENTS || patch < 1 ||
      patch > 31 || patch % 2 == 0 || cap < 1 || cap > E || B > 65535 ||
      centre == nullptr)
    return (int)cudaErrorInvalidValue;
  const int chunks = (E + KC - 1) / KC;
  const size_t smem = LIST_OFF + (size_t)chunks * KC * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tos_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t addr = (uintptr_t)tos_in | (uintptr_t)centre |
                         (uintptr_t)tos_out;
  const int vec = W % 16 == 0 && addr % 16 == 0;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  tos_count_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tos_in, xy, valid, centre, tos_out, H, W, E, (patch - 1) / 2, th, cap,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: counts over every event, threshold, centre overlay.
extern "C" int batched_fused_launch(const uint8_t* tos_in, const int* xy,
                                    const uint8_t* valid, const int* centre,
                                    uint8_t* tos_out, int B, int H, int W,
                                    int E, int patch, int th, int cap,
                                    void* stream) {
  (void)cap;
  return launch(tos_in, xy, valid, centre, tos_out, B, H, W, E, patch, th, E,
                stream);
}

// K7: K5's counts over each 128x128 tile's first `cap` hits.
extern "C" int batched_fused_binned_launch(const uint8_t* tos_in,
                                           const int* xy,
                                           const uint8_t* valid,
                                           const int* centre,
                                           uint8_t* tos_out, int B, int H,
                                           int W, int E, int patch, int th,
                                           int cap, void* stream) {
  return launch(tos_in, xy, valid, centre, tos_out, B, H, W, E, patch, th,
                cap, stream);
}
