// Cull-sweep triangle intersection on Hopper (sm_90a): closest hit or any
// hit over groups of 128 triangles.
//
// Replaces the TPU kernel jet_pbrt_tpu/ops/sweep_bvh.py (_sweep_kernel /
// _sweep_step, entered through intersect_sweep), the reference's traversal
// for meshes beyond the wide kernel's budget. It computes the same thing:
// per ray, the closest accepted triangle (world t and index
// inst * n_tris + row) or an any-hit bit, over the tables of
// ops/sweep_bvh.py (group spheres, (p0, e1, e2) rows, instance rows, the
// mesh's root sphere). Unlike the TPU kernel it tests a triangle by the
// wide kernel's Moller-Trumbore (csrc/tri_mt.cuh), not by precomputed
// Baldwin-Weber rows, so that a mesh's hits do not depend on the route its
// triangle count sends it to (ops/sweep_bvh.py).
//
// Design. One thread block per 128-ray packet. Per instance, in table
// order:
//   1. root pre-test: the rays whose segment can touch the mesh sphere are
//      compacted into shared memory (ray k of the instance = column k);
//      none -> the instance is skipped. Each compacted ray's best hit so
//      far sits in shared memory as a 64-bit key (t bits << 32 | index);
//   2. cull: thread j owns groups j, j+128, ... (two per pass); for each
//      it runs the sphere test against every compacted ray and keeps the
//      packet's packed key (entry-distance bits & ~8191) | group, the
//      minimum over the rays that pass (FAR when none does). Keys sit in
//      shared memory and each thread holds the minimum of its own keys;
//   3. scan: a block-wide min pops the nearest group, and thread j at once
//      requests triangle j's 9 values (p0, e1, e2) into registers (one
//      coalesced row per value), so the loads run while the want test and
//      its barrier do. The packet stops when no compacted ray's bound
//      min(tmax, best) reaches the group's entry. Otherwise thread k
//      re-runs compacted ray k's own sphere test of the group (the cull's
//      arithmetic on the cull's inputs), and the rays that both want the
//      group and pass it form a 128-bit mask. A pop that no ray wants only
//      retires the group. Else thread j tests its triangle against each
//      ray of the mask, read from shared memory as a broadcast; a closest
//      hit is a 64-bit atomicMin on the ray's key, an any hit a store that
//      marks it occluded (its bound drops to 0: it wants no later group).
// The TPU kernel tested whole packets, since its MXU makes a 128 x 128
// contraction nearly free; here each ray-triangle test is ~55 float
// operations and an IEEE division, so only the (ray, group) pairs whose
// own sphere test passes are tested. Its packets-per-step, VMEM residency
// and streamed DMA mode are TPU constraints with no counterpart: the row
// table is read from global memory (L2-resident for a mesh of a million
// rows: 36 MB).
//
// What bounds it on this card: the cull, Gp sphere tests (33 float
// operations each) per compacted ray per instance; not the triangle tests
// (a ray tests a few groups, about 1.2x the pairs a near-to-far traversal
// needs) and not bytes (rays are read once, a tested group's rows are 9
// coalesced 512-byte loads). The cull reads each ray as three broadcast
// float4 loads for two groups, so the FP32 pipe, not shared-memory issue,
// sets its pace. The scan costs two barriers per pop, three when the group
// is tested. On an H100 the cull took about half of thread 0's cycles on
// a 2^20-ray wave of the 600k-triangle bunny, the scan the other half
// (PERF.md).
//
// Resources: dynamic shared memory 4 * Gp + 6,144 bytes (22,528 at
// Gp = 4,096, 38,912 at Gp = 8,192) and 1,088 static, under the 48 KB
// default, so no opt-in is needed; ptxas (sm_90a, CUDA 12.8): 72 registers
// and 8 bytes of spill stores without the counters, 92 and none with them;
// so 7 resident blocks per SM at Gp = 4,096 (registers bind) and 5 at
// Gp = 8,192 (shared memory binds). chip_smoke.py prints both (phases 2
// and 6).
//
// Semantics kept from the reference kernel: rays are mapped into instance
// space as o' = (o - off) * (1 / scale), d unchanged, tmin' = tmin / scale;
// a hit is accepted when t > tmin' in local space and t * scale < min(tmax,
// best) in world space; the group-sphere slack 1e-6 (relative) and the root
// slack 1.0001, +1e-5 (rounding may over-cull, never under-cull). The
// triangle test is not the reference kernel's: Moller-Trumbore with
// 1 / det where |det| > 1e-12 (else 0), u, v >= 0, (1 - u) - v >= 0, every
// product and sum rounded alone (__fmul_rn / __fsub_rn / __fadd_rn, IEEE
// division, no --use_fast_math), in ops/wide_bvh.py::mt_test's order; a
// row with a zero edge never hits (t = 0 is not above tmin >= 0), and the
// spheres bound every other row, slivers the reference drops included
// (ops/sweep_bvh.py::build_sweep_tables); dead
// lanes (tmin = inf, tmax < 0) never hit and an all-dead packet exits
// after one test; an any-hit reports t = 0. Every product and sum of the
// root and sphere tests is pinned too (ops/sweep_bvh.py::sweep_work_plain
// repeats them). Index ties: the reference packs (t bits & ~127) |
// sublane; this kernel keeps the exact minimum t and, among exact minima,
// the lowest index (so it visits a group whose entry equals the bound in
// closest-hit mode).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tri_mt.cuh"

namespace {

constexpr int GROUP = 128;
constexpr int RAYS = 128;
constexpr int WARPS = RAYS / 32;
constexpr int GMASK = 8191;
constexpr float FAR = 3.0e37f;
constexpr int MT_ROWS = 9;
// a compacted ray: (o', tmin' clamped), (d, cap' clamped), (o'.d, o'.o,
// tmin', world tmax)
constexpr int RAY_VEC = 3;

__device__ __forceinline__ int fbits(float x) { return __float_as_int(x); }

// a * x + b * y + c * z as a chain of fused multiply-adds in this order:
// the root and sphere tests' contraction, which the reference evaluated on
// the TPU's MXU; its CPU interpret mode, the plain PyTorch version and this
// kernel all round this chain, so they agree bit for bit.
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fmaf_rn(c, z, __fmaf_rn(b, y, __fmul_rn(a, x)));
}

// order-preserving 64-bit hit key: t's bits (flipped so that unsigned order
// is float order) above the index; the minimum is the exact minimum t, then
// the lowest index
__device__ __forceinline__ unsigned long long hit_key(float t, int idx) {
  unsigned u = __float_as_uint(t);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(idx);
}

__device__ __forceinline__ float key_to_t(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

struct Sphere {
  float cx, cy, cz, cc, r2, rad;
};

__device__ __forceinline__ Sphere load_sphere(const float* __restrict__ sph,
                                              int gp, int g) {
  return {__ldg(sph + g), __ldg(sph + gp + g), __ldg(sph + 2 * gp + g),
          __ldg(sph + 3 * gp + g), __ldg(sph + 4 * gp + g),
          __ldg(sph + 5 * gp + g)};
}

// The cull's sphere test of one compacted ray (a = o', tmin'; b = d, cap';
// od = o'.d, oo = o'.o): true when the segment can touch the sphere, with
// the entry distance tc - r in instance units.
__device__ __forceinline__ bool sphere_test(const Sphere& s, float4 a,
                                            float4 b, float od, float oo,
                                            float& entry) {
  const float cd = dot3(b.x, b.y, b.z, s.cx, s.cy, s.cz);
  const float co = dot3(a.x, a.y, a.z, s.cx, s.cy, s.cz);
  const float tc = __fsub_rn(cd, od);
  const float m2 = __fmaf_rn(-tc, tc, __fadd_rn(__fmaf_rn(-2.0f, co, s.cc), oo));
  const float slack = __fmul_rn(
      __fmaf_rn(tc, tc, __fadd_rn(__fmaf_rn(2.0f, fabsf(co), s.cc), oo)),
      1e-6f);
  entry = __fsub_rn(tc, s.rad);
  return m2 <= __fadd_rn(s.r2, slack) && __fadd_rn(tc, s.rad) >= a.w &&
         entry <= b.w && b.w >= a.w;
}

// minimum of this thread's keys (groups tid, tid + RAYS, ...)
__device__ __forceinline__ int own_min(const int* s_key, int gp, int tid) {
  int m = INT_MAX;
  for (int g = tid; g < gp; g += RAYS) m = min(m, s_key[g]);
  return m;
}

template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(RAYS)
sweep_bvh_kernel(const float* __restrict__ sph, int gp,
                 const float* __restrict__ mt, const float* __restrict__ inst,
                 int n_inst, const float* __restrict__ root, int n_groups,
                 int n_tris, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tmin_in,
                 const float* __restrict__ tmax_in, int n,
                 float* __restrict__ t_out, int* __restrict__ idx_out,
                 uint8_t* __restrict__ valid_out,
                 long long* __restrict__ stats_out) {
  extern __shared__ float4 smem[];
  float4* s_ray = smem;                                        // [RAYS][3]
  int* s_key = reinterpret_cast<int*>(smem + RAY_VEC * RAYS);  // [gp]
  __shared__ unsigned long long s_best[RAYS];
  __shared__ int s_red[WARPS];
  __shared__ unsigned s_mask[WARPS], s_live[WARPS];
  __shared__ int s_nlive;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int i_ray = blockIdx.x * RAYS + tid;
  const size_t tp = static_cast<size_t>(n_groups) * GROUP;
  const int far_key = fbits(FAR) & ~GMASK;

  // lanes past the end of the batch are dead padding
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 0.f, dz = 0.f;
  float tmin = INFINITY, tmax = -1.f;
  if (i_ray < n) {
    ox = o[3 * i_ray]; oy = o[3 * i_ray + 1]; oz = o[3 * i_ray + 2];
    dx = d[3 * i_ray]; dy = d[3 * i_ray + 1]; dz = d[3 * i_ray + 2];
    tmin = tmin_in[i_ray]; tmax = tmax_in[i_ray];
  }
  float best = INFINITY;
  int best_idx = 0;
  // STATS: instances culled, groups tested, the rays that did that work
  // (past the root test in each cull, testing in each tested group), and
  // thread 0's clock64() cycles in the culls and in the scans
  long long n_cull = 0, n_test = 0, n_ray_cull = 0, n_ray_test = 0;
  long long cyc_cull = 0, cyc_scan = 0;

  // whole-packet exit: an all-dead packet costs this one test
  if (__syncthreads_or(tmax > 0.0f)) {
    const float rcx = root[0], rcy = root[1], rcz = root[2], rr = root[5];
    const float rlim = __fadd_rn(__fmul_rn(__fmul_rn(rr, rr), 1.0001f), 1e-5f);
    for (int i = 0; i < max(n_inst, 1); ++i) {
      const float* row = inst + (n_inst ? 4 * (i + 1) : 0);
      const float scl = row[3];
      const float inv = __fdiv_rn(1.0f, scl);
      const float oxl = __fmul_rn(__fsub_rn(ox, row[0]), inv);
      const float oyl = __fmul_rn(__fsub_rn(oy, row[1]), inv);
      const float ozl = __fmul_rn(__fsub_rn(oz, row[2]), inv);
      const float tminl = __fmul_rn(tmin, inv);
      const float capl = __fmul_rn(fminf(tmax, best), inv);

      // ---- 1. root pre-test, and compaction of the rays that pass it
      const float ex = __fsub_rn(rcx, oxl), ey = __fsub_rn(rcy, oyl);
      const float ez = __fsub_rn(rcz, ozl);
      const float rtc = dot3(ex, ey, ez, dx, dy, dz);
      const float rm2 = __fmaf_rn(-rtc, rtc, dot3(ex, ey, ez, ex, ey, ez));
      const bool rhit = rm2 <= rlim && __fadd_rn(rtc, rr) >= tminl &&
                        __fsub_rn(rtc, rr) <= capl && capl >= tminl;
      const unsigned ballot = __ballot_sync(0xffffffffu, rhit);
      if (lane == 0) s_red[warp] = __popc(ballot);
      __syncthreads();
      int pos = __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += s_red[w];
      if (tid == 0) {
        int total = 0;
        for (int w = 0; w < WARPS; ++w) total += s_red[w];
        s_nlive = total;
      }
      if (rhit) {
        s_ray[RAY_VEC * pos] = make_float4(oxl, oyl, ozl, fminf(tminl, FAR));
        s_ray[RAY_VEC * pos + 1] = make_float4(dx, dy, dz, fminf(capl, FAR));
        s_ray[RAY_VEC * pos + 2] =
            make_float4(dot3(oxl, oyl, ozl, dx, dy, dz),
                        dot3(oxl, oyl, ozl, oxl, oyl, ozl), tminl, tmax);
        s_best[pos] = hit_key(best, best_idx);
      }
      __syncthreads();
      const int n_live = s_nlive;
      if (n_live == 0) continue;  // uniform: no ray can touch this instance
      long long clk = 0;
      if (STATS && tid == 0) {
        ++n_cull;
        n_ray_cull += n_live;
        clk = clock64();
      }

      // ---- 2. cull: the packet's packed key of every group this thread
      // owns, two groups per pass over the rays
      int lmin = INT_MAX;
      for (int g0 = tid; g0 < gp; g0 += 2 * RAYS) {
        const int g1 = g0 + RAYS;
        const bool ok0 = g0 < n_groups, ok1 = g1 < n_groups;
        const Sphere s0 = load_sphere(sph, gp, ok0 ? g0 : 0);
        const Sphere s1 = load_sphere(sph, gp, ok1 ? g1 : 0);
        int key0 = far_key, key1 = far_key;
        if (ok0) {
          for (int k = 0; k < n_live; ++k) {
            const float4 a = s_ray[RAY_VEC * k], b = s_ray[RAY_VEC * k + 1];
            const float4 c = s_ray[RAY_VEC * k + 2];
            float e0, e1;
            if (sphere_test(s0, a, b, c.x, c.y, e0))
              key0 = min(key0, fbits(__fmul_rn(fmaxf(e0, 0.0f), scl)) & ~GMASK);
            if (ok1 && sphere_test(s1, a, b, c.x, c.y, e1))
              key1 = min(key1, fbits(__fmul_rn(fmaxf(e1, 0.0f), scl)) & ~GMASK);
          }
        }
        s_key[g0] = key0 | g0;
        lmin = min(lmin, key0 | g0);
        if (g1 < gp) {
          s_key[g1] = key1 | g1;
          lmin = min(lmin, key1 | g1);
        }
      }
      __syncthreads();
      if (STATS && tid == 0) {
        const long long now = clock64();
        cyc_cull += now - clk;
        clk = now;
      }

      // ---- 3. near-to-far scan
      while (true) {
        const int wmin = __reduce_min_sync(0xffffffffu, lmin);
        if (lane == 0) s_red[warp] = wmin;
        __syncthreads();
        int kmin = s_red[0];
        for (int w = 1; w < WARPS; ++w) kmin = min(kmin, s_red[w]);
        const int g = kmin & GMASK;
        const int dist = kmin & ~GMASK;

        // rows requested before the want test (speculative)
        const float* src = mt + static_cast<size_t>(g) * GROUP + tid;
        float wr[MT_ROWS];
        if (dist < far_key) {
#pragma unroll
          for (int r = 0; r < MT_ROWS; ++r) wr[r] = __ldg(src + r * tp);
        }
        // compacted ray tid: does its bound reach the group, and does its
        // own sphere test keep it?
        bool live = false, mine = false;
        if (tid < n_live) {
          const float4 c = s_ray[RAY_VEC * tid + 2];
          const int bound = fbits(fminf(c.w, key_to_t(s_best[tid])));
          live = dist < far_key && (ANY_HIT ? dist < bound : dist <= bound);
          if (live) {
            float e;
            mine = sphere_test(load_sphere(sph, gp, g), s_ray[RAY_VEC * tid],
                               s_ray[RAY_VEC * tid + 1], c.x, c.y, e);
          }
        }
        const unsigned bm = __ballot_sync(0xffffffffu, mine);
        const unsigned bl = __ballot_sync(0xffffffffu, live);
        if (lane == 0) {
          s_mask[warp] = bm;
          s_live[warp] = bl;
        }
        __syncthreads();
        unsigned any_live = 0, any_mine = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          any_live |= s_live[w];
          any_mine |= s_mask[w];
        }
        if (!any_live) break;  // uniform: the packet stops
        if ((g & (RAYS - 1)) == tid) {  // retire the group
          s_key[g] = far_key | g;
          lmin = own_min(s_key, gp, tid);
        }
        if (!any_mine) continue;  // uniform: no load, no test

        // ---- thread tid tests triangle tid of g against each wanting ray
        const int idx = i * n_tris + g * GROUP + tid;
        if (STATS && tid == 0) {
          ++n_test;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) n_ray_test += __popc(s_mask[w]);
        }
        // s_mask is rewritten only after the barrier that ends this pop
        for (int w = 0; w < WARPS; ++w) {
          unsigned m = s_mask[w];
          while (m) {
            const int k = 32 * w + __ffs(m) - 1;
            m &= m - 1;
            const float4 a = s_ray[RAY_VEC * k], b = s_ray[RAY_VEC * k + 1];
            const float4 c = s_ray[RAY_VEC * k + 2];
            float t_w;
            if (!mt_test([&](int j) { return wr[j]; }, a.x, a.y, a.z, b.x,
                         b.y, b.z, c.z, c.w, scl, t_w))
              continue;
            if (ANY_HIT)
              s_best[k] = hit_key(0.0f, 0);  // occluded: the bound drops to 0
            else
              atomicMin(&s_best[k], hit_key(t_w, idx));
          }
        }
        __syncthreads();  // s_best is read by the next pop
      }
      if (STATS && tid == 0) cyc_scan += clock64() - clk;
      if (rhit) {
        const unsigned long long key = s_best[pos];
        best = key_to_t(key);
        best_idx = static_cast<int>(key & 0xffffffffu);
      }
      // the next instance rewrites s_ray and s_best only after its first
      // barrier, which every thread reaches after this read
    }
  }
  if (i_ray < n) {
    t_out[i_ray] = best;
    idx_out[i_ray] = ANY_HIT ? 0 : best_idx;
    if (valid_out) valid_out[i_ray] = isfinite(best);
  }
  if (STATS && tid == 0) {
    long long* row = stats_out + 6 * blockIdx.x;
    row[0] = n_cull;
    row[1] = n_test;
    row[2] = n_ray_cull;
    row[3] = n_ray_test;
    row[4] = cyc_cull;
    row[5] = cyc_scan;
  }
}

size_t shmem_bytes(int gp) {
  return sizeof(float4) * RAY_VEC * RAYS + sizeof(int) * gp;
}

template <bool ANY_HIT, bool STATS>
int launch(const float* sph, int gp, const float* mt, const float* inst,
           int n_inst, const float* root, int n_groups, int n_tris,
           const float* o, const float* d, const float* tmin,
           const float* tmax, int n, float* t_out, int* idx_out,
           uint8_t* valid_out, long long* stats, cudaStream_t stream) {
  const int grid = (n + RAYS - 1) / RAYS;
  sweep_bvh_kernel<ANY_HIT, STATS><<<grid, RAYS, shmem_bytes(gp), stream>>>(
      sph, gp, mt, inst, n_inst, root, n_groups, n_tris, o, d, tmin, tmax, n,
      t_out, idx_out, valid_out, stats);
  return static_cast<int>(cudaGetLastError());
}

template <bool ANY_HIT, bool STATS>
int blocks_per_sm(int gp) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sweep_bvh_kernel<ANY_HIT, STATS>, RAYS, shmem_bytes(gp));
  return blocks;
}

}  // namespace

// Plain C entry point, loaded through ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch. stats is
// [ceil(n/128), 6] int64 or null; valid_out is null or [n] bool,
// isfinite(t_out) (the last argument, so a build of the entry without it
// takes the same call and leaves it).
extern "C" int sweep_bvh_launch(const float* sph, int gp, const float* mt,
                                const float* inst, int n_inst,
                                const float* root, int n_groups, int n_tris,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                int any_hit, float* t_out, int* idx_out,
                                long long* stats, void* stream,
                                uint8_t* valid_out) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    return stats ? launch<true, true>(sph, gp, mt, inst, n_inst, root, n_groups,
                                      n_tris, o, d, tmin, tmax, n, t_out,
                                      idx_out, valid_out, stats, s)
                 : launch<true, false>(sph, gp, mt, inst, n_inst, root,
                                       n_groups, n_tris, o, d, tmin, tmax, n,
                                       t_out, idx_out, valid_out, stats, s);
  return stats ? launch<false, true>(sph, gp, mt, inst, n_inst, root, n_groups,
                                     n_tris, o, d, tmin, tmax, n, t_out,
                                     idx_out, valid_out, stats, s)
               : launch<false, false>(sph, gp, mt, inst, n_inst, root,
                                      n_groups, n_tris, o, d, tmin, tmax, n,
                                      t_out, idx_out, valid_out, stats, s);
}

// Resident blocks per SM of the closest-hit kernel without counters at
// this Gp (the launch's block size and shared memory).
extern "C" int sweep_bvh_blocks_per_sm(int gp) {
  return blocks_per_sm<false, false>(gp);
}
