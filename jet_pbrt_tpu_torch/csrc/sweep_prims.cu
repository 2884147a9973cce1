// The cull-sweep's primitives in one small kernel (sm_90a).
//
// Replaces the TPU harness kernel scripts/sweep_prims.py (`kern`), which
// probed the primitives the TPU sweep is built from: a rank-4 contraction
// of two [4, 128] operands over their first axis (the sphere and
// Baldwin-Weber products, on the MXU there), a min over 8 lanes (three lane
// rolls there) and a scalar read back from the keys (an SMEM DMA there,
// shared memory here). It computes what that kernel computes:
//   out = a^T b + s,  s = w[0] + w[8] + w[120],
//   w[j] = min(k[(j-7 .. j) mod 128]),  k = row 0 of a^T b,
// all in float32. `pltpu.roll` follows `jnp.roll` (lane j receives lane
// j - shift), so the rolls by 1, 2 and 4 leave the minimum of the trailing
// window of 8 in lane j, not the minimum of an aligned block. Lane 0's
// window is lanes 121..127 and 0, which lie in another warp than lane 0:
// the keys go through shared memory, not a warp shuffle. The contraction
// is a chain of fused multiply-adds over k = 0..3, as XLA's CPU dot_general
// evaluates it in the reference's interpret mode, pinned with __fmaf_rn.
//
// One block of 128 threads; thread j owns column j. Bound by launch
// latency at this size (64 KiB out): it is a probe, not a workload.
#include <cuda_runtime.h>

namespace {

constexpr int K = 4;
constexpr int L = 128;
constexpr int WINDOW = 8;

__global__ void __launch_bounds__(L)
sweep_prims_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out) {
  __shared__ float s_a[K * L];
  __shared__ float s_key[L];
  const int j = threadIdx.x;
  float bj[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s_a[k * L + j] = a[k * L + j];
    bj[k] = b[k * L + j];
  }
  __syncthreads();
  // row 0 of a^T b, then the trailing-window minima the lane rolls leave
  float key = __fmul_rn(s_a[0], bj[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) key = __fmaf_rn(s_a[k * L], bj[k], key);
  s_key[j] = key;
  __syncthreads();
  float w[3];
  const int lanes[3] = {0, 8, 120};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    w[q] = s_key[lanes[q]];
#pragma unroll
    for (int sh = 1; sh < WINDOW; ++sh)
      w[q] = fminf(w[q], s_key[(lanes[q] - sh) & (L - 1)]);
  }
  const float s = __fadd_rn(__fadd_rn(w[0], w[1]), w[2]);
  for (int i = 0; i < L; ++i) {
    float acc = __fmul_rn(s_a[i], bj[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) acc = __fmaf_rn(s_a[k * L + i], bj[k], acc);
    out[i * L + j] = __fadd_rn(acc, s);
  }
}

}  // namespace

// Plain C entry point, loaded through ctypes: a, b [4, 128] f32, out
// [128, 128] f32, launched on `stream`; returns cudaGetLastError().
extern "C" int sweep_prims_launch(const float* a, const float* b, float* out,
                                  void* stream) {
  sweep_prims_kernel<<<1, L, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out);
  return static_cast<int>(cudaGetLastError());
}
