// jax.random's streams in one kernel per call (sm_90a).
//
// Not a port of a Pallas kernel: the reference package draws its path
// tracer's uniforms through jax.random (XLA's fused threefry,
// jet_pbrt_tpu/ops/rng.py:49-109). The port's plain version of the same
// function, Threefry-2x32-20 in int64 tensor ops, takes about 165
// elementwise launches per hash (ops/rng.py); here one launch computes
//   (a) lane keys:  key_i = T(T((0, seed), (0, sample_i)), (0, pixel_i))
//   (b) uniforms:   f_i = T(key_i, (0, purpose)),
//                   out[i, j] = bitcast_f32(((x0 ^ x1) >> 9) | 0x3F800000) - 1
//                   with (x0, x1) = T(f_i, (0, j)), j < S
// where T is Threefry-2x32 with 20 rounds (Salmon et al. 2011), exactly as
// jax.random's fold_in and uniform (partitionable threefry) compute it.
//
// One thread per lane: it folds the purpose in once and hashes its S
// slots, writing its row of S floats. Work per lane (b): (1 + S) hashes of
// about 130 integer operations each against 8 bytes in and 4 S bytes out,
// so at the bunny's S = 8 the call is bound by its integer operations, not
// by its bytes. The rotations are funnel shifts, the bitcast an
// __uint_as_float; all arithmetic is uint32 and exact, so the kernel and
// the plain version agree bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)   \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  y0 = x0;
  y1 = x1;
}

#undef TF_ROUND

__global__ void __launch_bounds__(BLOCK)
lane_keys_kernel(uint32_t seed, const long long* __restrict__ sample,
                 const long long* __restrict__ pixel, int n,
                 uint32_t* __restrict__ k0, uint32_t* __restrict__ k1) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t b0, b1, y0, y1;
  threefry2x32(0u, seed, 0u, static_cast<uint32_t>(sample[i]), b0, b1);
  threefry2x32(b0, b1, 0u, static_cast<uint32_t>(pixel[i]), y0, y1);
  k0[i] = y0;
  k1[i] = y1;
}

__global__ void __launch_bounds__(BLOCK)
uniforms_kernel(const uint32_t* __restrict__ k0,
                const uint32_t* __restrict__ k1, int n, uint32_t purpose,
                int s, float* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t f0, f1;
  threefry2x32(k0[i], k1[i], 0u, purpose, f0, f1);
  float* row = out + static_cast<size_t>(i) * s;
  for (int j = 0; j < s; ++j) {
    uint32_t x0, x1;
    threefry2x32(f0, f1, 0u, static_cast<uint32_t>(j), x0, x1);
    row[j] = __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
  }
}

}  // namespace

// Plain C entry points, loaded through ctypes; each launches one kernel on
// `stream` and returns cudaGetLastError().
// sample, pixel: [n] int64; k0, k1: [n] int32 (uint32 bits).
extern "C" int threefry_lane_keys(uint32_t seed, const long long* sample,
                                  const long long* pixel, int n, uint32_t* k0,
                                  uint32_t* k1, void* stream) {
  lane_keys_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(seed, sample, pixel,
                                                          n, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// k0, k1: [n] int32 lane keys; out: [n, s] float32.
extern "C" int threefry_uniforms(const uint32_t* k0, const uint32_t* k1, int n,
                                 uint32_t purpose, int s, float* out,
                                 void* stream) {
  uniforms_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(k0, k1, n, purpose, s,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}
