// K1: one chunk of the detector step for B lanes at once — STCF keep and
// LUT score, SAE scatter-max, TOS patch update, BER write errors.
//
// Replaces the TPU kernel `fused_chunk_step_call` (`_fused_kernel`) in
// src/repro/kernels/fused_step.py.  That kernel replays every event serially
// in each 128x128 tile with the whole SAE resident in VMEM; at 1280x720 the
// SAE alone is 3.7 MB, far beyond one SM's 227 KB of shared memory, so this
// port is built from the reference's event-parallel closed forms instead
// (`stcf_chunked`, `tos_update_batched`), integer-exact by construction:
//
//   copy  tos_in -> tos_out, sae_in -> sae_out       (cudaMemcpyAsync)
//   (a+b) stcf_score_kernel: one thread per event.  Keep = enough of the 8
//         neighbours fired within tw, read from sae_in (the SAE before the
//         chunk) OR from an earlier valid event of this chunk; score =
//         keep ? lut[y,x] : -inf; then atomicMax(sae_out[y,x], t).
//   (c)   tos_patch_kernel: one thread per (kept event, patch pixel).  Only
//         the last kept event whose patch covers a pixel writes it, so each
//         pixel has one writer and no atomics are needed.  Its value is
//         th-clamp(255 - k) if some kept event is centred there (k = kept
//         coverers after the last such centre), else th-clamp(tos0 - k).
//   (d)   ber_apply_kernel (only when injecting): dense pass applying the
//         5-bit encode / xor / decode of `ber.apply_write_errors`.
//
// All launches go to the caller's stream in this order: (c) reads the keep
// flags (a) wrote, (d) reads the surface (c) wrote.
//
// Bound on the H100: bytes.  The surfaces are copied once and the BER pass
// streams tos + bits; the per-event work is O(E^2) integer compares on
// shared memory, microseconds at E = 512.
//
// Timestamp differences wrap modulo 2^32 exactly as the reference's int32
// arithmetic does, computed in unsigned arithmetic so no signed overflow
// (undefined in C++) can occur.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NEVER = -(1 << 30);
constexpr int THREADS = 256;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__global__ void stcf_score_kernel(
    const int* __restrict__ xy, const int* __restrict__ ts,
    const uint8_t* __restrict__ valid, const int* __restrict__ sae_in,
    int* __restrict__ sae_out, const float* __restrict__ lut,
    uint8_t* __restrict__ keep_out, float* __restrict__ scores,
    int H, int W, int E, int support, int tw, int stcf_enabled) {
  __shared__ int sx[THREADS], sy[THREADS], st[THREADS], sv[THREADS];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int* lxy = xy + (size_t)b * E * 2;
  const int* lts = ts + (size_t)b * E;
  const uint8_t* lval = valid + (size_t)b * E;
  const size_t plane = (size_t)H * W;

  int x = 0, y = 0, t = 0, v = 0;
  if (i < E) {
    x = lxy[2 * i];
    y = lxy[2 * i + 1];
    t = lts[i];
    v = lval[i] != 0;
  }
  const bool inb = x >= 0 && x < W && y >= 0 && y < H;

  // Earlier valid in-chunk events within tw, one bit per neighbour offset.
  unsigned chunk_bits = 0;
  const int block_end = min(E, (int)(blockIdx.x + 1) * THREADS);
  if (stcf_enabled) {
    for (int base = 0; base < block_end; base += THREADS) {
      const int j = base + threadIdx.x;
      if (j < E) {
        sx[threadIdx.x] = lxy[2 * j];
        sy[threadIdx.x] = lxy[2 * j + 1];
        st[threadIdx.x] = lts[j];
        sv[threadIdx.x] = lval[j] != 0;
      }
      __syncthreads();
      const int n = min(THREADS, i - base);
      for (int k = 0; k < n; ++k) {
        const int dx = sx[k] - x, dy = sy[k] - y;
        if (sv[k] && dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1 &&
            (dx | dy) != 0 && wrap_sub(t, st[k]) <= tw) {
          chunk_bits |= 1u << ((dy + 1) * 3 + (dx + 1));
        }
      }
      __syncthreads();
    }
  }
  if (i >= E) return;

  bool keep = v;
  if (stcf_enabled) {
    const int* sae = sae_in + b * plane;
    int count = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dx == 0 && dy == 0) continue;
        const int qy = y + dy, qx = x + dx;
        bool recent = (chunk_bits >> ((dy + 1) * 3 + (dx + 1))) & 1u;
        if (qy >= 0 && qy < H && qx >= 0 && qx < W) {
          const int s = sae[(size_t)qy * W + qx];
          recent |= s > NEVER / 2 && wrap_sub(t, s) <= tw;
        }
        count += recent;
      }
    }
    keep = v && count >= support;
    // Padding slots max in NEVER, exactly like the reference's scatter.
    if (inb) atomicMax(sae_out + b * plane + (size_t)y * W + x, v ? t : NEVER);
  }
  keep = keep && inb;
  keep_out[(size_t)b * E + i] = keep;
  scores[(size_t)b * E + i] =
      keep ? lut[b * plane + (size_t)y * W + x] : -__int_as_float(0x7f800000);
}

__global__ void tos_patch_kernel(
    const int* __restrict__ xy, const uint8_t* __restrict__ keep,
    const uint8_t* __restrict__ tos_in, uint8_t* __restrict__ tos_out,
    int H, int W, int E, int patch, int th) {
  extern __shared__ int ev[];  // kept ? x | y << 16 : -1, for the lane
  const int b = blockIdx.y;
  const int* lxy = xy + (size_t)b * E * 2;
  const uint8_t* lkeep = keep + (size_t)b * E;
  for (int j = threadIdx.x; j < E; j += blockDim.x) {
    ev[j] = lkeep[j] ? (lxy[2 * j] | (lxy[2 * j + 1] << 16)) : -1;
  }
  __syncthreads();

  const int pp = patch * patch, r = (patch - 1) / 2;
  const long item = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long)E * pp) return;
  const int i = (int)(item / pp), o = (int)(item % pp);
  const int e_i = ev[i];
  if (e_i < 0) return;
  const int px = (e_i & 0xffff) + o % patch - r;
  const int py = (e_i >> 16) + o / patch - r;
  if (px < 0 || px >= W || py < 0 || py >= H) return;

  // Writer test: no later kept event covers (px, py).
  for (int j = i + 1; j < E; ++j) {
    const int e = ev[j];
    if (e >= 0 && abs((e & 0xffff) - px) <= r && abs((e >> 16) - py) <= r)
      return;
  }
  // Walk back to the last kept event centred here, counting coverers.
  const int centre = px | (py << 16);
  int cnt = 0, start = -1;
  for (int j = i; j >= 0; --j) {
    const int e = ev[j];
    if (e < 0) continue;
    if (e == centre) { start = 255; break; }
    cnt += abs((e & 0xffff) - px) <= r && abs((e >> 16) - py) <= r;
  }
  const size_t p = (size_t)b * H * W + (size_t)py * W + px;
  if (start < 0) start = tos_in[p];
  const int val = start - cnt;
  tos_out[p] = (uint8_t)(val >= th ? val : 0);
}

__global__ void ber_apply_kernel(uint8_t* __restrict__ tos,
                                 const int* __restrict__ bits,
                                 const float* __restrict__ ber,
                                 int plane, size_t n) {
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (size_t)gridDim.x * blockDim.x) {
    if (!(ber[p / plane] > 0.f)) continue;   // ber == 0: identity
    const int v = tos[p];
    const int code = v > 224 ? v - 224 : 0;
    // Value-0 codes skip write-back; the xor result wraps to uint8 before
    // decoding, as the reference's astype(uint8) does.
    const uint8_t res = (uint8_t)(code > 0 ? (code ^ bits[p]) : 0);
    tos[p] = res > 0 ? (uint8_t)(res + 224) : 0;
  }
}

}  // namespace

extern "C" int fused_step_launch(
    const uint8_t* tos_in, uint8_t* tos_out, const int* sae_in, int* sae_out,
    const float* lut, const int* xy, const int* ts, const uint8_t* valid,
    const int* bits, const float* ber, uint8_t* keep, float* scores,
    int B, int H, int W, int E, int patch, int th, int support, int tw,
    int stcf_enabled, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)B * H * W;
  cudaError_t err;
  if ((err = cudaMemcpyAsync(tos_out, tos_in, n, cudaMemcpyDeviceToDevice, s)))
    return err;
  if ((err = cudaMemcpyAsync(sae_out, sae_in, n * sizeof(int),
                             cudaMemcpyDeviceToDevice, s)))
    return err;

  const dim3 g1((E + THREADS - 1) / THREADS, B);
  stcf_score_kernel<<<g1, THREADS, 0, s>>>(xy, ts, valid, sae_in, sae_out,
                                           lut, keep, scores, H, W, E,
                                           support, tw, stcf_enabled);
  if ((err = cudaGetLastError())) return err;

  const long items = (long)E * patch * patch;
  const dim3 g2((unsigned)((items + THREADS - 1) / THREADS), B);
  tos_patch_kernel<<<g2, THREADS, E * sizeof(int), s>>>(
      xy, keep, tos_in, tos_out, H, W, E, patch, th);
  if ((err = cudaGetLastError())) return err;

  if (bits != nullptr) {
    const unsigned blocks = (unsigned)std::min<size_t>(
        (n + THREADS - 1) / THREADS, 132 * 16);
    ber_apply_kernel<<<blocks, THREADS, 0, s>>>(tos_out, bits, ber, H * W, n);
    if ((err = cudaGetLastError())) return err;
  }
  return 0;
}
