// K2: Harris response R = det(M) - k * tr(M)^2 over tos / 255, for B lanes.
//
// Replaces the TPU kernel `harris_call` (`_harris_kernel`) in
// src/repro/kernels/harris_conv.py, which holds the whole padded surface in
// VMEM and walks 64-row strips.  Here one block of 256 threads owns a 64 x 32
// output tile (64 wide, so the halo is a small share of the work) and runs
// three phases in shared memory:
//
//   (0) the tile plus a halo of (sobel/2 + window/2) pixels of tos / 255
//       (zero outside the surface: the reference's single zero pad);
//   (1) gx and gy over the tile plus the window halo.  A thread takes a
//       vertical strip of 4 gradient pixels in one column and walks the
//       image rows in ascending order, loading each row's taps once for
//       every output of the strip that reads it.  It stores the three
//       products the box sums read, wtap * (gx * gx), wtap * (gy * gy) and
//       wtap * (gx * gy), once per gradient pixel: they do not depend on the
//       output that reads them;
//   (2) each thread takes a vertical strip of 8 outputs in one column and
//       walks the product rows in ascending order, so each shared word is
//       loaded once for all the strip's outputs that read it, and folds 25
//       adds per sum (at 5 x 5), then the det / trace tail.
//
// The kernel is a template on (Sobel size, window size), odd 3..7 and 1..7:
// every loop is unrolled, every tap is a compile-time offset into the
// kernel's parameters (a constant-bank operand of its multiply), and the
// Sobel zero taps (the middle column of gx, the middle row of gy, which the
// launcher checks) are never issued.
//
// Rounding: every product and sum is a separate round-to-nearest operation
// (__fmul_rn / __fadd_rn, which nvcc never contracts into FMAs), in the
// order of the reference's `_conv2_valid` left fold — row-major taps, zero
// taps skipped, starting from 0 — and `tos / 255` is a multiply by the
// float32 reciprocal of 255.  Walking rows in ascending order keeps each
// output's fold order, and wtap * (g * g) is rounded as the reference's
// `tap * slice` of its `gx * gx` is.  That is exactly the plain PyTorch
// spelling (`core/harris.py`), so kernel and plain version agree bit for
// bit.  A separable Sobel or running box sums would change the bits.
//
// Bound on the H100: float32 operations at this rounding contract.  Each
// separately rounded add or multiply is one instruction, 128 per SM per
// clock, half the rate that counts an FMA as two operations: at 5 x 5 about
// 170 per pixel (40 + 40 for the gradients on the halo, 6 for the products,
// 75 for the box sums, 7 for the tail), 4.7 us at 1280 x 720, against
// 5 bytes per pixel (1.4 us).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;             // output tile width
constexpr int TH = 32;             // output tile height
constexpr int THREADS = 256;
constexpr int SG = 4;              // gradient pixels per thread strip
constexpr int SO = TH * TW / THREADS;   // outputs per thread strip (8)
constexpr int MAXK = 7;            // largest Sobel / window size taken

static_assert(THREADS % TW == 0 && TH % SO == 0, "strip layout");

struct HarrisParams {
  float gx[MAXK * MAXK];
  float gy[MAXK * MAXK];
  float wtap;    // 1 / ws^2 in float32
  float inv255;  // float32 reciprocal of 255
  float k;
};

template <int KS, int WS>
__global__ void __launch_bounds__(THREADS)
harris_kernel(const uint8_t* __restrict__ tos, float* __restrict__ out,
              int H, int W, const HarrisParams p) {
  constexpr int RS = KS / 2, RW = WS / 2, HALO = RS + RW;
  constexpr int GH = TH + 2 * RW, GW = TW + 2 * RW;   // gradient region
  constexpr int NSTRIP = (GH + SG - 1) / SG;
  // Image rows for every strip, the last one's rows past GH included.
  constexpr int IH = NSTRIP * SG + KS - 1, IW = GW + KS - 1;
  __shared__ float img[IH][IW];
  __shared__ float pa[GH][GW], pb[GH][GW], pc[GH][GW];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const uint8_t* src = tos + (size_t)b * H * W;

  // (0) tos / 255 over the tile and its halo, 0 outside the surface.
  for (int idx = tid; idx < IH * IW; idx += THREADS) {
    const int iy = idx / IW, ix = idx % IW;
    const int gy = oy0 - HALO + iy, gx = ox0 - HALO + ix;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __fmul_rn((float)src[(size_t)gy * W + gx], p.inv255);
    img[iy][ix] = v;
  }
  __syncthreads();

  // (1) gradients, 4 rows per thread, and the three products per pixel.
  for (int it = tid; it < NSTRIP * GW; it += THREADS) {
    const int u0 = it / GW * SG, v = it % GW;
    float ax[SG], ay[SG];
#pragma unroll
    for (int s = 0; s < SG; ++s) ax[s] = ay[s] = 0.f;
#pragma unroll
    for (int rr = 0; rr < SG + KS - 1; ++rr) {
      float row[KS];
#pragma unroll
      for (int j = 0; j < KS; ++j) row[j] = img[u0 + rr][v + j];
#pragma unroll
      for (int s = 0; s < SG; ++s) {
        const int i = rr - s;   // tap row of output s
        if (i < 0 || i >= KS) continue;
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          if (j != RS)
            ax[s] = __fadd_rn(ax[s], __fmul_rn(p.gx[i * KS + j], row[j]));
          if (i != RS)
            ay[s] = __fadd_rn(ay[s], __fmul_rn(p.gy[i * KS + j], row[j]));
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SG; ++s) {
      const int u = u0 + s;
      if (u < GH) {
        pa[u][v] = __fmul_rn(p.wtap, __fmul_rn(ax[s], ax[s]));
        pb[u][v] = __fmul_rn(p.wtap, __fmul_rn(ay[s], ay[s]));
        pc[u][v] = __fmul_rn(p.wtap, __fmul_rn(ax[s], ay[s]));
      }
    }
  }
  __syncthreads();

  // (2) box sums over 8 output rows per thread, then the tail.
  const int c = tid % TW, u0 = tid / TW * SO;
  float a[SO], bb[SO], cc[SO];
#pragma unroll
  for (int s = 0; s < SO; ++s) a[s] = bb[s] = cc[s] = 0.f;
#pragma unroll
  for (int rr = 0; rr < SO + WS - 1; ++rr) {
    float ra[WS], rb[WS], rc[WS];
#pragma unroll
    for (int j = 0; j < WS; ++j) {
      ra[j] = pa[u0 + rr][c + j];
      rb[j] = pb[u0 + rr][c + j];
      rc[j] = pc[u0 + rr][c + j];
    }
#pragma unroll
    for (int s = 0; s < SO; ++s) {
      const int i = rr - s;   // window row of output s
      if (i < 0 || i >= WS) continue;
#pragma unroll
      for (int j = 0; j < WS; ++j) {
        a[s] = __fadd_rn(a[s], ra[j]);
        bb[s] = __fadd_rn(bb[s], rb[j]);
        cc[s] = __fadd_rn(cc[s], rc[j]);
      }
    }
  }
  const int ox = ox0 + c;
  if (ox >= W) return;
#pragma unroll
  for (int s = 0; s < SO; ++s) {
    const int oy = oy0 + u0 + s;
    if (oy >= H) break;
    const float det = __fsub_rn(__fmul_rn(a[s], bb[s]),
                                __fmul_rn(cc[s], cc[s]));
    const float tr = __fadd_rn(a[s], bb[s]);
    out[(size_t)b * H * W + (size_t)oy * W + ox] =
        __fsub_rn(det, __fmul_rn(__fmul_rn(p.k, tr), tr));
  }
}

template <int KS, int WS>
cudaError_t launch(const uint8_t* tos, float* out, int B, int H, int W,
                   const HarrisParams& p, cudaStream_t s) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  harris_kernel<KS, WS><<<grid, THREADS, 0, s>>>(tos, out, H, W, p);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_ws(int ws, const uint8_t* tos, float* out, int B, int H,
                      int W, const HarrisParams& p, cudaStream_t s) {
  switch (ws) {
    case 1: return launch<KS, 1>(tos, out, B, H, W, p, s);
    case 3: return launch<KS, 3>(tos, out, B, H, W, p, s);
    case 5: return launch<KS, 5>(tos, out, B, H, W, p, s);
    case 7: return launch<KS, 7>(tos, out, B, H, W, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// gx, gy: host arrays of ks * ks float32 taps (row-major), zero exactly in
// gx's middle column and gy's middle row (the extended Sobel's).
extern "C" int harris_launch(const uint8_t* tos, float* out, int B, int H,
                             int W, int ks, int ws, const float* gx,
                             const float* gy, float wtap, float inv255,
                             float k, void* stream) {
  if (ks < 3 || ks > MAXK || ks % 2 == 0 || B < 1 || B > 65535 || H < 1 ||
      W < 1)
    return cudaErrorInvalidValue;
  HarrisParams p = {};
  for (int i = 0; i < ks; ++i) {
    for (int j = 0; j < ks; ++j) {
      const float tx = gx[i * ks + j], ty = gy[i * ks + j];
      if ((tx == 0.f) != (j == ks / 2) || (ty == 0.f) != (i == ks / 2))
        return cudaErrorInvalidValue;
      p.gx[i * ks + j] = tx;
      p.gy[i * ks + j] = ty;
    }
  }
  p.wtap = wtap;
  p.inv255 = inv255;
  p.k = k;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ks) {
    case 3: return launch_ws<3>(ws, tos, out, B, H, W, p, s);
    case 5: return launch_ws<5>(ws, tos, out, B, H, W, p, s);
    case 7: return launch_ws<7>(ws, tos, out, B, H, W, p, s);
    default: return cudaErrorInvalidValue;
  }
}
