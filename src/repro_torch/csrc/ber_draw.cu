// The write-error draw: every lane's threefry key split and its per-pixel
// 5-bit xor masks in one launch, bit-exact to `jax.random.split` followed by
// `jax.random.bernoulli` (the plain versions: `prng.split` and
// `ber.write_error_bits`, src/repro_torch/core/).
//
// It replaces no TPU kernel: the JAX package draws the bits with
// `jax.random.bernoulli` (src/repro/core/ber.py `write_error_bits`) and
// leaves the draw to XLA.  It was added because the plain version issues
// the 20 threefry rounds from Python as int64 tensor ops over a
// (B, H, W, 5) counter array: some 360 launches a detector step, ~20 ms for
// four 1280x720 lanes, which made the draw nearly all of the serving
// pool's device time.
//
// For lane l with key words (k1, k2), held as uint32 values in int64:
//   new key  = threefry2x32(k1, k2; 0, 0)
//   sub      = threefry2x32(k1, k2; 0, 1)          (prng.split's counters)
// and for pixel p = y * W + x and bit b in 0..4, counter n = 5p + b as the
// words (hi, lo) = (n >> 32, n & 0xFFFFFFFF) (prng._counts):
//   bits     = x1 ^ x2 of threefry2x32(sub; hi, lo)
//   flip     = float(bits >> 9) * 2^-23 < ber[l]   (float32, exact: JAX's
//                                                    mode "low")
//   mask[l, p] = sum_b flip_b << b                  (int32 in [0, 31])
//
// Bound on the H100: integer operations.  A threefry block is 72 (the two
// initial key adds, 20 rounds of add, rotate and xor, five injections of
// two adds), 76 with the xor of its words, the shift, the compare and the
// bit set; a pixel takes 5.  The adds can issue on the FMA pipe (IMAD), but
// the 20 rotates (SHF) and 20 xors (LOP3) of a block, and the xor and shift
// after it, only on the integer ALU pipe, 64 lanes an SM a clock: 42 a bit.
// Four 1280x720 lanes are 18.4 M blocks, 0.77 G ALU operations, 0.046 ms at
// 64 lanes x 132 SMs x 1.98 GHz (all 1.4 G operations at the issue rate of
// 128 lanes an SM take 0.042 ms); the masks are 4 bytes a pixel (14.7 MB,
// 4.4 us at 3.35 TB/s), so operations bound it by ~10x
// (`benchmarks/bounds.ber_draw_bound`).
//
// Design: one thread per pixel on a grid of (pixel tiles of THREADS,
// lanes), so that DAVIS240 x16 (169 x 16 blocks) fills the 132 SMs as
// 1280x720 x4 (3,600 x 4) does.  The 20 rounds are unrolled with the
// rotations as compile-time constants (`__funnelshift_l`, one SHF each) on
// 32-bit registers; only the counter is formed in 64 bits, once a bit.
// Thread 0 of a block computes the lane's sub key and reads its rate once,
// into shared memory; block 0 of a lane also writes the lane's new key, into
// a separate output, since the other blocks still read the old key.  Each
// thread makes one coalesced int32 store.  Nothing is allocated here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BITS = 5;          // the storage code's bits per pixel
constexpr int MAX_LANES = 65535;  // gridDim.y

template <int R>
__device__ __forceinline__ void mix(uint32_t& x1, uint32_t& x2) {
  x1 += x2;
  x2 = __funnelshift_l(x2, x2, R) ^ x1;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four(uint32_t& x1, uint32_t& x2) {
  mix<R0>(x1, x2);
  mix<R1>(x1, x2);
  mix<R2>(x1, x2);
  mix<R3>(x1, x2);
}

// Threefry-2x32, 20 rounds, with jax._src.prng's key-injection schedule.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k1, uint32_t k2,
                                              uint32_t x1, uint32_t x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
  four<13, 15, 26, 6>(x1, x2);
  x1 += k2;
  x2 += k3 + 1u;
  four<17, 29, 16, 24>(x1, x2);
  x1 += k3;
  x2 += k1 + 2u;
  four<13, 15, 26, 6>(x1, x2);
  x1 += k1;
  x2 += k2 + 3u;
  four<17, 29, 16, 24>(x1, x2);
  x1 += k2;
  x2 += k3 + 4u;
  four<13, 15, 26, 6>(x1, x2);
  x1 += k3;
  x2 += k1 + 5u;
  return make_uint2(x1, x2);
}

__global__ void __launch_bounds__(THREADS)
ber_draw_kernel(const int64_t* __restrict__ key,
                const float* __restrict__ ber, int64_t* __restrict__ new_key,
                int32_t* __restrict__ mask, int hw) {
  __shared__ uint32_t sub_s[2];
  __shared__ float rate_s;
  const int lane = blockIdx.y;
  if (threadIdx.x == 0) {
    const uint32_t k1 = (uint32_t)key[2 * lane];
    const uint32_t k2 = (uint32_t)key[2 * lane + 1];
    const uint2 sub = threefry2x32(k1, k2, 0u, 1u);
    sub_s[0] = sub.x;
    sub_s[1] = sub.y;
    rate_s = ber[lane];
    if (blockIdx.x == 0) {
      const uint2 next = threefry2x32(k1, k2, 0u, 0u);
      new_key[2 * lane] = (int64_t)next.x;
      new_key[2 * lane + 1] = (int64_t)next.y;
    }
  }
  __syncthreads();
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const uint32_t s1 = sub_s[0], s2 = sub_s[1];
  const float rate = rate_s;
  const uint64_t n0 = (uint64_t)BITS * (uint64_t)p;
  int32_t m = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const uint64_t n = n0 + (uint64_t)b;
    const uint2 y = threefry2x32(s1, s2, (uint32_t)(n >> 32), (uint32_t)n);
    const float u = __uint2float_rn((y.x ^ y.y) >> 9) * 0x1p-23f;
    m |= (int32_t)(u < rate) << b;
  }
  mask[(size_t)lane * hw + p] = m;
}

}  // namespace

extern "C" int ber_draw_launch(const int64_t* key, const float* ber,
                               int64_t* new_key, int32_t* mask, int B,
                               int HW, cudaStream_t stream) {
  if (B < 1 || B > MAX_LANES || HW < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((HW + THREADS - 1) / THREADS, B);
  ber_draw_kernel<<<grid, THREADS, 0, stream>>>(key, ber, new_key, mask, HW);
  return (int)cudaGetLastError();
}
