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
// All arithmetic is uint32 and exact, so the kernel and the plain version
// agree bit for bit.
//
// What bounds it. A hash is 20 rounds of an add, a rotation (a funnel
// shift, SHF) and a xor (LOP3), 10 key injections and the counter's add:
// 40 instructions that only the ALU pipe runs (64 lanes per SM per clock,
// NVIDIA's Nsight Compute Kernel Profiling Guide, "Pipelines") and 31 adds,
// against 4 S + 8 bytes per lane. So at the bunny's S = 8 (9 hashes and 8
// conversions of 3 ALU instructions, 386 ALU-only instructions per lane,
// chip_smoke.threefry_work) the call is bound by the ALU pipe, not by its
// bytes, and each instruction the kernel adds on that pipe is lost. An add
// may issue on the ALU pipe (IADD3) or on the FMA-heavy pipe (IMAD, also 64
// lanes per SM per clock); every add whose other operand is a register is
// written here as x * one + y with `one` a kernel argument (always 1), which
// ptxas cannot fold, so those adds issue as IMADs and leave the ALU pipe to
// the rotations and xors.
//
// uniforms_kernel, the replaced design and this one. The first design ran one
// thread per lane over a runtime slot loop: each thread stored its row of S
// floats with S scalar stores 4 S bytes apart (at S = 8, 32 sectors per
// warp store), and hashed its S slots one after another, one dependent chain
// per thread. Here a block owns a tile of BLOCK lanes. Each thread folds one
// lane's purpose in and keeps the lane's key schedule (f0, f1 and k2 = f0 ^
// f1 ^ parity) in shared memory, computed once per lane. Then the block's
// threads walk the tile's BLOCK x S outputs in flat order: output e is slot e
// mod S of lane e div S, stored at tile[e], so each warp store writes 128
// contiguous bytes into the unchanged [N, S] layout. S is a template argument
// for the widths the paths draw (2: the camera; 6, 8, 10: a vertex with 1-3
// lights), which unrolls the thread's S outputs into S independent hashes; on
// the last tile the keys past its last lane repeat that lane's, and a thread
// past the tile's end hashes one of them and stores nothing, so the code
// stays one straight line. Any other S takes the generic instantiation, a
// loop over the same flat order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // threads of a block, and lanes of a tile
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// x + y as an IMAD on the FMA-heavy pipe (one == 1 at run time)
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y, uint32_t one) {
  return x * one + y;
}

#define TF_ROUND(r)         \
  x0 = add(x0, x1, one);    \
  x1 = rotl(x1, r);         \
  x1 ^= x0;

// Threefry-2x32-20 of the counter (0, c1) under the key (k0, k1), with its
// third schedule word k2 = k0 ^ k1 ^ PARITY given
__device__ __forceinline__ void threefry_scheduled(uint32_t k0, uint32_t k1,
                                                   uint32_t k2, uint32_t c1,
                                                   uint32_t one, uint32_t& y0,
                                                   uint32_t& y1) {
  uint32_t x0 = k0;
  uint32_t x1 = add(c1, k1, one);
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = add(x0, k1, one); x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 = add(x0, k2, one); x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = add(x0, k0, one); x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 = add(x0, k1, one); x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = add(x0, k2, one); x1 += k0 + 5u;
  y0 = x0;
  y1 = x1;
}

#undef TF_ROUND

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c1, uint32_t one,
                                             uint32_t& y0, uint32_t& y1) {
  threefry_scheduled(k0, k1, k0 ^ k1 ^ PARITY, c1, one, y0, y1);
}

// slot j's uniform under the scheduled key (f0, f1, k2, -)
__device__ __forceinline__ float slot_uniform(uint4 f, uint32_t j,
                                              uint32_t one) {
  uint32_t x0, x1;
  threefry_scheduled(f.x, f.y, f.z, j, one, x0, x1);
  return __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
}

__global__ void __launch_bounds__(BLOCK)
lane_keys_kernel(uint32_t seed, const long long* __restrict__ sample,
                 const long long* __restrict__ pixel, int n, uint32_t one,
                 uint32_t* __restrict__ k0, uint32_t* __restrict__ k1) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t b0, b1, y0, y1;
  threefry2x32(0u, seed, static_cast<uint32_t>(sample[i]), one, b0, b1);
  threefry2x32(b0, b1, static_cast<uint32_t>(pixel[i]), one, y0, y1);
  k0[i] = y0;
  k1[i] = y1;
}

// S > 0: the draw's width at compile time; S == 0: `s` at run time
template <int S>
__global__ void __launch_bounds__(BLOCK)
uniforms_kernel(const uint32_t* __restrict__ k0,
                const uint32_t* __restrict__ k1, int n, uint32_t purpose,
                int s, uint32_t one, float* __restrict__ out) {
  __shared__ uint4 key[BLOCK];
  const unsigned t = threadIdx.x;
  const int lane0 = blockIdx.x * BLOCK;
  const unsigned lanes = min(BLOCK, n - lane0);
  {  // past the last lane, a tile's spare keys repeat that lane's
    const int i = lane0 + min(t, lanes - 1);
    uint32_t f0, f1;
    threefry2x32(k0[i], k1[i], purpose, one, f0, f1);
    key[t] = make_uint4(f0, f1, f0 ^ f1 ^ PARITY, 0u);
  }
  __syncthreads();
  const unsigned width = S > 0 ? S : s;
  float* tile = out + static_cast<size_t>(lane0) * width;
  const unsigned total = lanes * width;
  if constexpr (S > 0) {
    float* mine = tile + t;   // the thread's outputs: mine[q * BLOCK]
#pragma unroll
    for (unsigned q = 0; q < S; ++q) {
      const unsigned e = t + q * BLOCK;
      const unsigned l = e / S;
      const float u = slot_uniform(key[l], e - l * S, one);
      if (e < total) mine[q * BLOCK] = u;
    }
  } else {
    for (unsigned e = t; e < total; e += BLOCK) {
      const unsigned l = e / width;
      tile[e] = slot_uniform(key[l], e - l * width, one);
    }
  }
}

template <int S>
void launch_uniforms(const uint32_t* k0, const uint32_t* k1, int n,
                     uint32_t purpose, int s, float* out,
                     cudaStream_t stream) {
  uniforms_kernel<S><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      k0, k1, n, purpose, s, 1u, out);
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
                                                          n, 1u, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// k0, k1: [n] int32 lane keys; out: [n, s] float32.
extern "C" int threefry_uniforms(const uint32_t* k0, const uint32_t* k1, int n,
                                 uint32_t purpose, int s, float* out,
                                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 2: launch_uniforms<2>(k0, k1, n, purpose, s, out, st); break;
    case 6: launch_uniforms<6>(k0, k1, n, purpose, s, out, st); break;
    case 8: launch_uniforms<8>(k0, k1, n, purpose, s, out, st); break;
    case 10: launch_uniforms<10>(k0, k1, n, purpose, s, out, st); break;
    default: launch_uniforms<0>(k0, k1, n, purpose, s, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
