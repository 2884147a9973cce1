// Micro-benchmarks of the wide kernel's primitives on Hopper (sm_90a).
//
// Replaces the TPU harness scripts/prim_micro.py (the eleven kernels built
// in `main`, entered through `run`). Each probe computes what the
// reference's kernel computes: a scalar recurrence `acc` over `reps`
// dependent iterations (a runtime argument, so nvcc cannot fold it), written
// to all of out [8, 8, 128] f32 by a grid of 8 blocks of 128 threads, each
// block computing `acc` and writing its own [8, 128] slab. The TPU ran those
// 8 grid steps one after another on one core; here they run at once on 8
// SMs, so a launch's time over `reps` is the time of one dependent iteration.
//
// What the TPU kernels stood for, and what each probe measures here (the
// function, not the TPU's block layout: a one-hot MXU product that fetched
// a column there is a load here):
//   m1   one node fetch: a global load and a dependent add per iteration
//   m4   four independent loads in flight per iteration
//   b1   four loads summed, then one dependent add
//   r1   the key path's reduces: a block-wide min over the 128 lanes (warp
//        shuffles, then the 4 warps' minima through shared memory), 8 per
//        iteration; the TPU's 8 equal sublanes are one register here
//   x8   scalar extracts: 8 shared-memory reads summed
//   x32  32 shared-memory reads summed
//   r2   the K2 pop: per lane a min over 8 rows of a staged tile + acc, then
//        the block-wide min, 8 per iteration
//   srt  a 19-comparator sorting network in registers and 8 shared-memory
//        stores (volatile, so they are kept)
//   f1   one leaf fetch: a float32 global load and a dependent add
//   f3   three bf16 global loads (a split-plane leaf) and their sum
//   mt   the ALU cost of 16 Moller-Trumbore tests
// Placement follows the tables' sizes. tf32 (2.4 MB) and tb3 (3.6 MB) cannot
// fit in a block's 227 KB of shared memory: they stay in global memory,
// L2-resident after the warm-up as K1's node and leaf tables are (the probes
// touch only rows of them, which L1 then holds). tb_bf16 (110,592 bytes)
// fits: the probes that stand for work on data already on chip (x8, x32,
// r2, srt) stage it in dynamic shared memory once per launch, as K2 keeps
// its keys; the fetch probes (m1, m4, b1) read it from global memory, as K1
// fetches its nodes.
//
// Rounding. nvcc contracts a*b + c into an FMA by default; every float
// operation of a recurrence is pinned here instead, as the plain version
// rounds it. The reference's XLA loop body contracts acc + s * 1e-9 into
// one fused multiply-add (its interpret mode rounds it once), so the update
// is __fmaf_rn; every other sum and product rounds alone (__fadd_rn,
// __fmul_rn, __fsub_rn). mt's rows are all 0.5 + acc: at the first
// iteration d0 r8 - d0 r7 is exactly 0 under either rounding (0.3 * 0.5 is
// exact), every determinant is 0 and acc becomes inf. Each row goes
// through an empty asm statement so that nvcc cannot merge the 16 equal
// tests into one.
//
// What bounds it: latency. Each iteration depends on the last through acc
// (and the loop is not unrolled, as lax.fori_loop is not), so a probe's time
// is its chain's latency; its bytes (the rows it touches, 32 KiB out) and
// operations would take well under a microsecond at the card's rates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the probes' order is PROBES in scripts/prim_micro.py
enum Probe { M1, M4, B1, R1, X8, X32, R2, SRT, F1, F3, MT };

constexpr int GRID = 8, ROWS = 8, LANES = 128, WARPS = LANES / 32;
constexpr int TB_COLS = 1152;             // tb_bf16 [48, 1152]
constexpr int TB_ROWS = 48;
constexpr int WIDE_COLS = 4224;           // tf32 [144, 4224], tb3 [432, 4224]
constexpr int PLANE = 144;                // rows of one tb3 plane
constexpr int STAGE_BYTES = TB_ROWS * TB_COLS * 2;
constexpr float C9 = 1e-9f;

__host__ __device__ constexpr bool staged(int p) {
  return p == X8 || p == X32 || p == R2 || p == SRT;
}

__device__ __forceinline__ float bf(const __nv_bfloat16* t, int row, int col,
                                    int cols) {
  return __bfloat162float(t[row * cols + col]);
}

__device__ __forceinline__ int blk_of(int i) {
  return ((i * 37) % 1100 / 128) * 128;
}

// acc + s * 1e-9, one rounding (see the note above)
__device__ __forceinline__ float update(float acc, float s) {
  return __fmaf_rn(s, C9, acc);
}

// v[k] := the minimum of v[k] over the block's 128 threads, k < 8; red is
// this iteration's half of a double buffer, so one barrier suffices
__device__ __forceinline__ void block_min8(float (&v)[8], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], sh));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[k * WARPS + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* r = red + k * WARPS;
    v[k] = fminf(fminf(r[0], r[1]), fminf(r[2], r[3]));
  }
}

__device__ __forceinline__ float sum8(const float (&v)[8]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = __fadd_rn(s, v[k]);
  return s;
}

// one comparator of the sorting network: (a, b) := (min, max)
__device__ __forceinline__ void cswap(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

template <int P>
__global__ void __launch_bounds__(LANES)
prim_micro_kernel(const void* __restrict__ table, int reps,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char s_stage[];
  __shared__ float s_red[2][8 * WARPS];
  __shared__ volatile int s_sorted[64];
  const int tid = threadIdx.x;
  if constexpr (staged(P)) {
    const uint4* src = static_cast<const uint4*>(table);
    uint4* dst = reinterpret_cast<uint4*>(s_stage);
    for (int e = tid; e < STAGE_BYTES / 16; e += LANES) dst[e] = src[e];
    __syncthreads();
  }
  const __nv_bfloat16* tb =
      staged(P) ? reinterpret_cast<const __nv_bfloat16*>(s_stage)
                : static_cast<const __nv_bfloat16*>(table);
  const float* tf = static_cast<const float*>(table);

  float acc = 0.0f;
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
    if constexpr (P == M1) {
      acc = __fadd_rn(acc, bf(tb, 0, (i * 37) % 1100, TB_COLS));
    } else if constexpr (P == M4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc = __fadd_rn(acc, bf(tb, 0, (i * 37 + j * 263) % 1100, TB_COLS));
    } else if constexpr (P == B1) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s = __fadd_rn(s, bf(tb, 0, (i * 37 + j * 263) % 1100, TB_COLS));
      acc = __fadd_rn(acc, s);
    } else if constexpr (P == R1) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(static_cast<float>(k), acc);
      block_min8(v, s_red[i & 1]);
      acc = update(acc, sum8(v));
    } else if constexpr (P == X8 || P == X32) {
      const int b = blk_of(i);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int l = 0; l < (P == X8 ? 1 : 4); ++l)
          s = __fadd_rn(s, bf(tb, k, b + l, TB_COLS));
      acc = update(acc, s);
    } else if constexpr (P == R2) {
      const int col = blk_of(i) + tid;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // rows 6k .. 6k+7, cut at the table's 48 rows for k = 7
        v[k] = __fadd_rn(bf(tb, 6 * k, col, TB_COLS), acc);
#pragma unroll
        for (int r = 6 * k + 1; r < 6 * k + 8 && r < TB_ROWS; ++r)
          v[k] = fminf(v[k], __fadd_rn(bf(tb, r, col, TB_COLS), acc));
      }
      block_min8(v, s_red[i & 1]);
      acc = update(acc, sum8(v));
    } else if constexpr (P == SRT) {
      const int b = blk_of(i);
      int kv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) kv[k] = __float_as_int(bf(tb, k, b, TB_COLS));
      // the reference's 19-comparator network (Batcher, 8 keys)
      cswap(kv[0], kv[1]); cswap(kv[2], kv[3]); cswap(kv[4], kv[5]);
      cswap(kv[6], kv[7]); cswap(kv[0], kv[2]); cswap(kv[1], kv[3]);
      cswap(kv[4], kv[6]); cswap(kv[5], kv[7]); cswap(kv[1], kv[2]);
      cswap(kv[5], kv[6]); cswap(kv[0], kv[4]); cswap(kv[3], kv[7]);
      cswap(kv[1], kv[5]); cswap(kv[2], kv[6]); cswap(kv[1], kv[4]);
      cswap(kv[3], kv[6]); cswap(kv[2], kv[4]); cswap(kv[3], kv[5]);
      cswap(kv[3], kv[4]);
      uint32_t s = 0;  // the reference's int32 sum wraps; unsigned is defined
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s_sorted[8 * (i % 4) + k] = kv[k];
        s += static_cast<uint32_t>(kv[k]);
      }
      acc = update(acc, __int2float_rn(static_cast<int32_t>(s)));
    } else if constexpr (P == F1) {
      acc = __fadd_rn(acc, tf[(i * 37) % 4200]);
    } else if constexpr (P == F3) {
      const int idx = (i * 37) % 4200;
      float tr = 0.0f;
#pragma unroll
      for (int p = 0; p < 3; ++p)
        tr = __fadd_rn(tr, bf(tb, PLANE * p, idx, WIDE_COLS));
      acc = __fadd_rn(acc, tr);
    } else if constexpr (P == MT) {
      const float d0 = 0.3f;
      const float base = __fadd_rn(0.5f, acc);
      float t_min = INFINITY;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float row[9];
#pragma unroll
        for (int a = 0; a < 9; ++a) row[a] = opaque(base);
        const float px = __fsub_rn(__fmul_rn(d0, row[8]), __fmul_rn(d0, row[7]));
        const float py = __fsub_rn(__fmul_rn(d0, row[6]), __fmul_rn(d0, row[8]));
        const float pz = __fsub_rn(__fmul_rn(d0, row[7]), __fmul_rn(d0, row[6]));
        const float det = __fadd_rn(__fadd_rn(__fmul_rn(row[3], px),
                                              __fmul_rn(row[4], py)),
                                    __fmul_rn(row[5], pz));
        const float rcp = __fdiv_rn(1.0f, det);
        const float invd = fabsf(det) > 1e-12f ? rcp : 0.0f;
        const float tx = __fsub_rn(d0, row[0]);
        const float ty = __fsub_rn(d0, row[1]);
        const float tz = __fsub_rn(d0, row[2]);
        const float uu = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(tx, px),
                                                       __fmul_rn(ty, py)),
                                             __fmul_rn(tz, pz)), invd);
        const float qx = __fsub_rn(__fmul_rn(ty, row[5]), __fmul_rn(tz, row[4]));
        const float qy = __fsub_rn(__fmul_rn(tz, row[3]), __fmul_rn(tx, row[5]));
        const float qz = __fsub_rn(__fmul_rn(tx, row[4]), __fmul_rn(ty, row[3]));
        const float vv = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, qx),
                                                       __fmul_rn(d0, qy)),
                                             __fmul_rn(d0, qz)), invd);
        const float tt = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(row[6], qx),
                                                       __fmul_rn(row[7], qy)),
                                             __fmul_rn(row[8], qz)), invd);
        const bool ok = uu >= 0.0f && vv >= 0.0f && __fadd_rn(uu, vv) <= 1.0f &&
                        tt > 0.0f;
        t_min = fminf(t_min, ok ? tt : INFINITY);
      }
      acc = update(acc, t_min);
    }
  }

  float* slab = out + blockIdx.x * ROWS * LANES;
  for (int e = tid; e < ROWS * LANES; e += LANES) slab[e] = acc;
}

template <int P>
int launch(const void* table, int reps, float* out, cudaStream_t stream) {
  const int shmem = staged(P) ? STAGE_BYTES : 0;
  if (staged(P)) {  // above 48 KB only after this opt-in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        prim_micro_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  prim_micro_kernel<P><<<GRID, LANES, shmem, stream>>>(table, reps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded through ctypes: probe is an index into PROBES
// of scripts/prim_micro.py, table the probe's table (16-byte aligned), out
// [8, 8, 128] f32; launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch.
extern "C" int prim_micro_launch(int probe, const void* table, int reps,
                                 float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case M1: return launch<M1>(table, reps, out, s);
    case M4: return launch<M4>(table, reps, out, s);
    case B1: return launch<B1>(table, reps, out, s);
    case R1: return launch<R1>(table, reps, out, s);
    case X8: return launch<X8>(table, reps, out, s);
    case X32: return launch<X32>(table, reps, out, s);
    case R2: return launch<R2>(table, reps, out, s);
    case SRT: return launch<SRT>(table, reps, out, s);
    case F1: return launch<F1>(table, reps, out, s);
    case F3: return launch<F3>(table, reps, out, s);
    case MT: return launch<MT>(table, reps, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
