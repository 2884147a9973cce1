// The cull-sweep's primitives in one small kernel (sm_90a).
//
// Replaces the TPU harness kernel scripts/sweep_prims.py (`kern`), which
// probed the primitives the TPU sweep is built from: a rank-4 contraction
// of two [4, 128] operands over their first axis (the sphere and
// Baldwin-Weber products, on the MXU there), a min over aligned 8-lane
// blocks (lane rolls there, warp shuffles here) and a scalar read back from
// the keys (an SMEM DMA there, shared memory here). It computes
//   out = a^T b + s,  s = min(k[0:8]) + min(k[8:16]) + min(k[120:128]),
// k = row 0 of a^T b, all in float32.
//
// One block of 128 threads; thread j owns column j. Bound by launch
// latency at this size (64 KiB out): it is a probe, not a workload.
#include <cuda_runtime.h>

namespace {

constexpr int K = 4;
constexpr int L = 128;

__global__ void __launch_bounds__(L)
sweep_prims_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out) {
  __shared__ float s_a[K * L];
  __shared__ float s_min[L];
  const int j = threadIdx.x;
  float bj[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s_a[k * L + j] = a[k * L + j];
    bj[k] = b[k * L + j];
  }
  __syncthreads();
  // row 0, then the min over this lane's aligned block of 8
  float key = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) key += s_a[k * L] * bj[k];
#pragma unroll
  for (int sh = 1; sh < 8; sh <<= 1)
    key = fminf(key, __shfl_xor_sync(0xffffffffu, key, sh));
  s_min[j] = key;
  __syncthreads();
  const float s = s_min[0] + s_min[8] + s_min[120];
  for (int i = 0; i < L; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc += s_a[k * L + i] * bj[k];
    out[i * L + j] = acc + s;
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
