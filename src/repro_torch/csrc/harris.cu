// K2: Harris response R = det(M) - k * tr(M)^2 over tos / 255, for B lanes.
//
// Replaces the TPU kernel `harris_call` (`_harris_kernel`) in
// src/repro/kernels/harris_conv.py, which holds the whole padded surface in
// VMEM and walks 64-row strips.  Here one block owns a 32 x 32 output tile:
// it stages the tile plus a halo of (sobel/2 + window/2) pixels of tos / 255
// in shared memory (zero outside the surface, the reference's single zero
// pad), computes gx and gy over the tile plus the window halo, then the box
// sums of gx^2, gy^2, gx*gy and the det / trace tail.  Any surface size
// tiles; there is no size limit and no fallback.
//
// Rounding: every product and sum is a separate round-to-nearest operation
// (__fmul_rn / __fadd_rn, which nvcc never contracts into FMAs), in the
// order of the reference's `_conv2_valid` left fold — row-major taps, zero
// taps skipped, starting from 0 — and `tos / 255` is a multiply by the
// float32 reciprocal of 255.  That is exactly the plain PyTorch spelling
// (`core/harris.py`), so kernel and plain version agree bit for bit.
//
// Bound on the H100: float32 operations (about 240 per pixel at 5 x 5 Sobel
// and window) against 5 bytes of traffic per pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int MAXK = 7;            // largest Sobel / window size taken
constexpr int MAXR = MAXK / 2;
constexpr int THREADS = 256;

struct HarrisParams {
  float gx[MAXK * MAXK];
  float gy[MAXK * MAXK];
  int ks;        // Sobel size
  int ws;        // window size
  float wtap;    // 1 / ws^2 in float32
  float inv255;  // float32 reciprocal of 255
  float k;
};

__global__ void harris_kernel(const uint8_t* __restrict__ tos,
                              float* __restrict__ out, int H, int W,
                              HarrisParams p) {
  __shared__ float img[TILE + 4 * MAXR][TILE + 4 * MAXR];
  __shared__ float gxs[TILE + 2 * MAXR][TILE + 2 * MAXR];
  __shared__ float gys[TILE + 2 * MAXR][TILE + 2 * MAXR];

  const int rs = p.ks / 2, rw = p.ws / 2, halo = rs + rw;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TILE, ox0 = blockIdx.x * TILE;
  const uint8_t* src = tos + (size_t)b * H * W;

  const int n_in = TILE + 2 * halo;
  for (int idx = threadIdx.x; idx < n_in * n_in; idx += THREADS) {
    const int iy = idx / n_in, ix = idx % n_in;
    const int gy = oy0 - halo + iy, gx = ox0 - halo + ix;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __fmul_rn((float)src[(size_t)gy * W + gx], p.inv255);
    img[iy][ix] = v;
  }
  __syncthreads();

  const int n_g = TILE + 2 * rw;
  for (int idx = threadIdx.x; idx < n_g * n_g; idx += THREADS) {
    const int u = idx / n_g, v = idx % n_g;
    float ax = 0.f, ay = 0.f;
    for (int i = 0; i < p.ks; ++i) {
      for (int j = 0; j < p.ks; ++j) {
        const float s = img[u + i][v + j];
        const float tx = p.gx[i * p.ks + j], ty = p.gy[i * p.ks + j];
        if (tx != 0.f) ax = __fadd_rn(ax, __fmul_rn(tx, s));
        if (ty != 0.f) ay = __fadd_rn(ay, __fmul_rn(ty, s));
      }
    }
    gxs[u][v] = ax;
    gys[u][v] = ay;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int u = idx / TILE, v = idx % TILE;
    const int oy = oy0 + u, ox = ox0 + v;
    if (oy >= H || ox >= W) continue;
    float a = 0.f, bb = 0.f, c = 0.f;
    for (int i = 0; i < p.ws; ++i) {
      for (int j = 0; j < p.ws; ++j) {
        const float gx = gxs[u + i][v + j], gy = gys[u + i][v + j];
        a = __fadd_rn(a, __fmul_rn(p.wtap, __fmul_rn(gx, gx)));
        bb = __fadd_rn(bb, __fmul_rn(p.wtap, __fmul_rn(gy, gy)));
        c = __fadd_rn(c, __fmul_rn(p.wtap, __fmul_rn(gx, gy)));
      }
    }
    const float det = __fsub_rn(__fmul_rn(a, bb), __fmul_rn(c, c));
    const float tr = __fadd_rn(a, bb);
    out[(size_t)b * H * W + (size_t)oy * W + ox] =
        __fsub_rn(det, __fmul_rn(__fmul_rn(p.k, tr), tr));
  }
}

}  // namespace

// gx, gy: host arrays of ks * ks float32 taps (row-major).
extern "C" int harris_launch(const uint8_t* tos, float* out, int B, int H,
                             int W, int ks, int ws, const float* gx,
                             const float* gy, float wtap, float inv255,
                             float k, void* stream) {
  if (ks < 1 || ks > MAXK || ws < 1 || ws > MAXK) return cudaErrorInvalidValue;
  HarrisParams p = {};
  for (int i = 0; i < ks * ks; ++i) {
    p.gx[i] = gx[i];
    p.gy[i] = gy[i];
  }
  p.ks = ks;
  p.ws = ws;
  p.wtap = wtap;
  p.inv255 = inv255;
  p.k = k;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  harris_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(tos, out, H, W, p);
  return cudaGetLastError();
}
