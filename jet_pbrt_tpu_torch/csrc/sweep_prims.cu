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
// What bounds it: its 69,632 bytes take 2.1e-5 ms at 3.35 TB/s, far below
// one launch, so launch latency is the floor at this size (it is a probe,
// not a workload). The design spreads the output over the card: the first
// design ran one block of 128 threads, each writing its column of all 128
// rows, so one SM of 132 wrote the 64 KiB in 128 serial steps. Here each of
// L / ROWS blocks owns ROWS rows. Every block recomputes row 0 of a^T b (128
// chains of 4 multiply-adds) and the three window minima in shared memory,
// cheap beside its output, and each thread writes 4 adjacent columns of one
// row with one 16-byte store, a warp 512 contiguous bytes.
#include <cuda_runtime.h>

namespace {

constexpr int K = 4;
constexpr int L = 128;
constexpr int WINDOW = 8;
constexpr int ROWS = 8;                  // rows of the output per block
constexpr int THREADS = ROWS * L / 4;    // 4 columns per thread

// column j of a^T b at row i: the pinned multiply-add chain over k
__device__ __forceinline__ float dot4(const float* sa, const float* sb, int i,
                                      int j) {
  float acc = __fmul_rn(sa[i], sb[j]);
#pragma unroll
  for (int k = 1; k < K; ++k)
    acc = __fmaf_rn(sa[k * L + i], sb[k * L + j], acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS)
sweep_prims_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out) {
  __shared__ float s_a[K * L];
  __shared__ float s_b[K * L];
  __shared__ float s_key[L];
  const int t = threadIdx.x;
  for (int x = t; x < K * L; x += THREADS) {
    s_a[x] = a[x];
    s_b[x] = b[x];
  }
  __syncthreads();
  // row 0 of a^T b, then the trailing-window minima the lane rolls leave
  if (t < L) s_key[t] = dot4(s_a, s_b, 0, t);
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
  const int i = blockIdx.x * ROWS + t / (L / 4);
  const int j = 4 * (t % (L / 4));
  float4 v;
  v.x = __fadd_rn(dot4(s_a, s_b, i, j), s);
  v.y = __fadd_rn(dot4(s_a, s_b, i, j + 1), s);
  v.z = __fadd_rn(dot4(s_a, s_b, i, j + 2), s);
  v.w = __fadd_rn(dot4(s_a, s_b, i, j + 3), s);
  reinterpret_cast<float4*>(out + i * L)[j / 4] = v;
}

}  // namespace

// Plain C entry point, loaded through ctypes: a, b [4, 128] f32, out
// [128, 128] f32 (16-byte aligned), launched on `stream`; returns
// cudaGetLastError().
extern "C" int sweep_prims_launch(const float* a, const float* b, float* out,
                                  void* stream) {
  sweep_prims_kernel<<<L / ROWS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, out);
  return static_cast<int>(cudaGetLastError());
}
