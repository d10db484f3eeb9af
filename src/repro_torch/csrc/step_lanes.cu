// The detector step's per-lane scalar chains, as two launches a step: the
// online DVFS pick before K1 (`dvfs_pick_kernel`) and the books after it
// (`step_books_kernel`).  The plain versions are `kernels/step_lanes.py`'s
// `dvfs_pick_ref` (`core/dvfs.online_vdd_from_chunk_ts`, the cap, the lane
// mask's select and the operating-point gathers) and `step_books_ref` (the
// kept count, the three books and their lane-mask selects).
//
// They replace no TPU kernel: in the JAX package XLA fuses these chains
// (src/repro/core/dvfs.py `online_vdd_from_chunk_ts`, src/repro/core/state.py
// `_operating_point` and the books of `detector_step`).  Eagerly they are
// some 65 small launches before K1 and 14-22 after it, each with its Python
// and dispatch cost, on a host that already paces the serving pool's round.
//
// dvfs_pick_kernel, for lane l with chunk-relative int32 times ts[l, :] and
// the valid mask valid[l, :] (floor division throughout, as
// `torch.div(..., rounding_mode="floor")`; int32 adds wrap):
//   w_first = ts[l, 0] // half, w_last = ts[l, E-1] // half,
//   d = w_first - win: rotate (cur, prev1, prev2) up to w_first,
//   need = float(min(p1, sat) + min(p2, sat)) * inv_tw * headroom
//          (two float32 multiplies, each rounded),
//   idx = the first point whose capacity is >= need, else P - 1, then
//         min(idx, cap) (the lane's cap, or one cap for every lane),
//   the coefficients read point idx (a negative idx counts from the end, as
//         a tensor index does),
//   n_k = valid events of half-window w_last - k (k = 0, 1, 2), folded into
//         the rotated counters by e = w_last - w_first; a lane with no
//         valid event, or one the lane mask leaves out, keeps its counters.
// step_books_kernel, for lane l: n_kept = the kept events of keep[l, :];
// kept_total + n_kept and acc + n_kept * coef as one float64 multiply and
// one float64 add (`__dmul_rn`, `__dadd_rn`), rounded once to float32, for
// the energy and latency books; lanes the mask leaves out keep their books
// (their n_kept is still written).
//
// Bound on the H100: bytes, and below them the launch.  Each kernel reads
// its lane's events once (the pick 5 bytes an event, ts and valid; the
// books 1, keep) and a few words a lane: at the serving cells' shapes
// (4 x 512, 16 x 128..2048 events) that is 1-160 KB, 0.3-50 ns at
// 3.35 TB/s, far below a launch's few microseconds
// (`benchmarks/bounds.step_lanes_bound`).
//
// Design: one block of THREADS per lane, the lanes on the grid, so any lane
// count and chunk size take one launch.  The block's threads stride the
// lane's events with coalesced loads and keep their counts in registers;
// `__reduce_add_sync` sums a warp, shared memory the warps; then thread 0
// runs the lane's scalar chain and writes its outputs.  Each output row is
// a row of one int32 and one float32 block that the launcher allocates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_POINTS = 8;      // operating points the table may hold

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Floor division by a positive divisor.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a < 0 && q * b != a) ? q - 1 : q;
}

// The block's sums of N per-thread counts, in thread 0's v (the other
// threads' v are partial).  Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void block_sum(int (&v)[N]) {
  __shared__ int part[N][WARPS];
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = __reduce_add_sync(0xffffffffu, v[k]);
    if ((threadIdx.x & 31) == 0) part[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[k][w];
      v[k] = s;
    }
  }
}

// Rate rows in and out: win, cur, prev1, prev2; out_i also holds vdd_idx
// (row 4), out_f ber, energy_coef, latency_coef; table is (4, P): caps,
// ber, energy_pj, latency_ns.  cap_row (B,) or null for one cap; mask (B,)
// or null for every lane.
__global__ void __launch_bounds__(THREADS)
dvfs_pick_kernel(const int32_t* __restrict__ win,
                 const int32_t* __restrict__ cur,
                 const int32_t* __restrict__ prev1,
                 const int32_t* __restrict__ prev2,
                 const int32_t* __restrict__ ts,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ table,
                 const int32_t* __restrict__ cap_row,
                 const uint8_t* __restrict__ mask,
                 int32_t* __restrict__ out_i, float* __restrict__ out_f,
                 int B, int E, int P, int half, int sat, float inv_tw,
                 float headroom, int cap) {
  const int l = blockIdx.x;
  const int32_t* t = ts + (size_t)l * E;
  const uint8_t* v = valid + (size_t)l * E;
  const int w_last = floor_div(t[E - 1], half);
  const int w_1 = wsub(w_last, 1), w_2 = wsub(w_last, 2);
  int c[4] = {0, 0, 0, 0};  // valid, n0, n1, n2
  for (int i = threadIdx.x; i < E; i += THREADS) {
    if (v[i] != 0) {
      const int w = floor_div(t[i], half);
      c[0] += 1;
      c[1] += w == w_last;
      c[2] += w == w_1;
      c[3] += w == w_2;
    }
  }
  block_sum(c);
  if (threadIdx.x != 0) return;

  const int o_win = win[l], o_cur = cur[l], o_p1 = prev1[l], o_p2 = prev2[l];
  const int w_first = floor_div(t[0], half);
  const int d = wsub(w_first, o_win);
  const int r_cur = d == 0 ? o_cur : 0;
  const int r_p1 = d == 0 ? o_p1 : (d == 1 ? o_cur : 0);
  const int r_p2 = d == 0 ? o_p2 : (d == 1 ? o_p1 : (d == 2 ? o_cur : 0));

  const int pair = wadd(min(r_p1, sat), min(r_p2, sat));
  const float need =
      __fmul_rn(__fmul_rn(__int2float_rn(pair), inv_tw), headroom);
  int idx = P - 1;
  for (int i = 0; i < P; ++i) {
    if (table[i] >= need) {
      idx = i;
      break;
    }
  }
  idx = min(idx, cap_row != nullptr ? cap_row[l] : cap);
  const int g = max(idx < 0 ? idx + P : idx, 0);  // 0 for a cap below -P

  const int e = wsub(w_last, w_first);
  const bool keep_old = c[0] == 0 || (mask != nullptr && mask[l] == 0);
  out_i[l] = keep_old ? o_win : w_last;
  out_i[B + l] = keep_old ? o_cur : wadd(c[1], e == 0 ? r_cur : 0);
  out_i[2 * B + l] =
      keep_old ? o_p1 : wadd(c[2], e == 0 ? r_p1 : (e == 1 ? r_cur : 0));
  out_i[3 * B + l] =
      keep_old ? o_p2
               : wadd(c[3], e == 0 ? r_p2
                                   : (e == 1 ? r_p1 : (e == 2 ? r_cur : 0)));
  out_i[4 * B + l] = idx;
  out_f[l] = table[P + g];
  out_f[B + l] = table[2 * P + g];
  out_f[2 * B + l] = table[3 * P + g];
}

__device__ __forceinline__ float book(float acc, int nk, float coef) {
  return __double2float_rn(
      __dadd_rn((double)acc, __dmul_rn((double)nk, (double)coef)));
}

// out_i rows: n_kept, kept_total; out_f rows: energy_pj, latency_ns.
__global__ void __launch_bounds__(THREADS)
step_books_kernel(const uint8_t* __restrict__ keep,
                  const int32_t* __restrict__ kept_total,
                  const float* __restrict__ energy_pj,
                  const float* __restrict__ latency_ns,
                  const float* __restrict__ energy_coef,
                  const float* __restrict__ latency_coef,
                  const uint8_t* __restrict__ mask,
                  int32_t* __restrict__ out_i, float* __restrict__ out_f,
                  int B, int E) {
  const int l = blockIdx.x;
  const uint8_t* k = keep + (size_t)l * E;
  int c[1] = {0};
  for (int i = threadIdx.x; i < E; i += THREADS) c[0] += k[i] != 0;
  block_sum(c);
  if (threadIdx.x != 0) return;
  const int nk = c[0];
  out_i[l] = nk;
  if (mask != nullptr && mask[l] == 0) {
    out_i[B + l] = kept_total[l];
    out_f[l] = energy_pj[l];
    out_f[B + l] = latency_ns[l];
    return;
  }
  out_i[B + l] = wadd(kept_total[l], nk);
  out_f[l] = book(energy_pj[l], nk, energy_coef[l]);
  out_f[B + l] = book(latency_ns[l], nk, latency_coef[l]);
}

}  // namespace

extern "C" int dvfs_pick_launch(const int32_t* win, const int32_t* cur,
                                const int32_t* prev1, const int32_t* prev2,
                                const int32_t* ts, const uint8_t* valid,
                                const float* table, const int32_t* cap_row,
                                const uint8_t* mask, int32_t* out_i,
                                float* out_f, int B, int E, int P, int half,
                                int sat, float inv_tw, float headroom,
                                int cap, cudaStream_t stream) {
  if (B < 1 || E < 1 || P < 1 || P > MAX_POINTS || half < 1)
    return (int)cudaErrorInvalidValue;
  dvfs_pick_kernel<<<B, THREADS, 0, stream>>>(
      win, cur, prev1, prev2, ts, valid, table, cap_row, mask, out_i, out_f,
      B, E, P, half, sat, inv_tw, headroom, cap);
  return (int)cudaGetLastError();
}

extern "C" int step_books_launch(const uint8_t* keep,
                                 const int32_t* kept_total,
                                 const float* energy_pj,
                                 const float* latency_ns,
                                 const float* energy_coef,
                                 const float* latency_coef,
                                 const uint8_t* mask, int32_t* out_i,
                                 float* out_f, int B, int E,
                                 cudaStream_t stream) {
  if (B < 1 || E < 1) return (int)cudaErrorInvalidValue;
  step_books_kernel<<<B, THREADS, 0, stream>>>(
      keep, kept_total, energy_pj, latency_ns, energy_coef, latency_coef,
      mask, out_i, out_f, B, E);
  return (int)cudaGetLastError();
}
