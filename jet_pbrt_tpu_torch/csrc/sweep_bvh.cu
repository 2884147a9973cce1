// Cull-sweep triangle intersection on Hopper (sm_90a): closest hit or any
// hit over groups of 128 triangles.
//
// Replaces the TPU kernel jet_pbrt_tpu/ops/sweep_bvh.py (_sweep_kernel /
// _sweep_step, entered through intersect_sweep), the reference's traversal
// for meshes beyond the wide kernel's budget. It computes the same thing:
// per ray, the closest accepted triangle (world t and index
// inst * n_tris + row) or an any-hit bit, over the tables of
// ops/sweep_bvh.py (group spheres, Baldwin-Weber rows, instance rows, the
// mesh's root sphere).
//
// Design. One thread block per 128-ray packet, one thread per ray. Per
// instance, in table order:
//   1. root pre-test: the rays whose segment can touch the mesh sphere are
//      compacted into shared memory; none -> the instance is skipped;
//   2. cull: thread j owns groups j, j+128, ...; for each it runs the
//      sphere test against every compacted ray and keeps the packet's
//      packed key (entry-distance bits & ~8191) | group, the minimum over
//      the rays that pass (FAR when none does). Keys sit in shared memory
//      (Gp <= 8192 keys, 32 KiB) and each thread holds the minimum of its
//      own keys in a register;
//   3. scan: a block-wide min over those registers pops the nearest group;
//      the packet stops when that group's entry distance is at or beyond
//      every live ray's bound min(tmax, best). Otherwise the group's 12x128
//      Baldwin-Weber rows are staged in shared memory, every thread tests
//      its ray against the 128 triangles, and the group is retired.
// The TPU kernel's packets-per-step, VMEM residency and streamed DMA mode
// are TPU constraints and have no counterpart: the BW table is read from
// global memory (L2-resident for a mesh of a million rows: 48 MB).
//
// What bounds it on this card: the cull, Gp sphere tests per thread per
// instance for every packet that passes the root test (4,096 groups for a
// 524,288-row mesh), and the scan's barriers (four per popped group); not
// bytes. Rays are read once; a popped group's rows are one coalesced
// 6 KiB load.
//
// Semantics kept from the reference kernel: rays are mapped into instance
// space as o' = (o - off) * (1 / scale), d unchanged, tmin' = tmin / scale;
// a hit is accepted when t > tmin' in local space and t * scale < min(tmax,
// best) in world space; the group-sphere slack 1e-6 (relative) and the root
// slack 1.0001, +1e-5 (rounding may over-cull, never under-cull); the
// |n.d| > 1e-20 guard, u, v >= 0, u + v <= 1, t = -(n.o - d0) * (1 / n.d)
// in exact IEEE division (no --use_fast_math), every product and sum of
// the test rounded as written (dot3); zero rows never hit; dead
// lanes (tmin = inf, tmax < 0) never hit and an all-dead packet exits
// after one test; an any-hit reports t = 0. Index ties: the reference
// packs (t bits & ~127) | sublane; this kernel keeps the exact minimum t
// and, among exact minima, the lowest index (so it visits a group whose
// entry equals the bound in closest-hit mode).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 128;
constexpr int RAYS = 128;
constexpr int GMASK = 8191;
constexpr float FAR = 3.0e37f;
constexpr int BW_ROWS = 12;
constexpr int RAY_ROWS = 10;  // compacted rays: o', d, tmin', cap', o'.d, o'.o

__device__ __forceinline__ int fbits(float x) { return __float_as_int(x); }

// Baldwin-Weber row r0..r0+2 of the staged triangle at w, dotted with
// (x, y, z) as a chain of fused multiply-adds in this order. The reference
// contracted on the TPU's MXU; its CPU interpret mode, the plain PyTorch
// version and this kernel all round this chain, so they agree bit for bit.
__device__ __forceinline__ float dot3(const float* w, int r0, float x, float y,
                                      float z) {
  return __fmaf_rn(w[(r0 + 2) * GROUP], z,
                   __fmaf_rn(w[(r0 + 1) * GROUP], y,
                             __fmul_rn(w[r0 * GROUP], x)));
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
                 const float* __restrict__ bw, const float* __restrict__ inst,
                 int n_inst, const float* __restrict__ root, int n_groups,
                 int n_tris, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tmin_in,
                 const float* __restrict__ tmax_in, int n,
                 float* __restrict__ t_out, int* __restrict__ idx_out,
                 int* __restrict__ stats_out) {
  extern __shared__ int smem[];
  int* s_key = smem;                                   // [gp]
  float* s_bw = reinterpret_cast<float*>(smem + gp);   // [BW_ROWS][GROUP]
  float* s_ray = s_bw + BW_ROWS * GROUP;               // [RAY_ROWS][RAYS]
  __shared__ int s_red[RAYS / 32];
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
  // STATS: instances culled, groups popped, and the rays that did that
  // work (past the root test in each cull, testing in each pop)
  int n_cull = 0, n_test = 0, n_ray_cull = 0, n_ray_test = 0;

  // whole-packet exit: an all-dead packet costs this one test
  if (__syncthreads_or(tmax > 0.0f)) {
    const float rcx = root[0], rcy = root[1], rcz = root[2], rr = root[5];
    for (int i = 0; i < max(n_inst, 1); ++i) {
      const float* row = inst + (n_inst ? 4 * (i + 1) : 0);
      const float scl = row[3];
      const float inv = 1.0f / scl;
      const float oxl = (ox - row[0]) * inv;
      const float oyl = (oy - row[1]) * inv;
      const float ozl = (oz - row[2]) * inv;
      const float tminl = tmin * inv;
      const float capl = fminf(tmax, best) * inv;

      // ---- 1. root pre-test, and compaction of the rays that pass it
      const float ex = rcx - oxl, ey = rcy - oyl, ez = rcz - ozl;
      const float rtc = ex * dx + ey * dy + ez * dz;
      const float rm2 = ex * ex + ey * ey + ez * ez - rtc * rtc;
      const bool rhit = rm2 <= rr * rr * 1.0001f + 1e-5f &&
                        rtc + rr >= tminl && rtc - rr <= capl && capl >= tminl;
      const unsigned ballot = __ballot_sync(0xffffffffu, rhit);
      if (lane == 0) s_red[warp] = __popc(ballot);
      __syncthreads();
      int pos = __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += s_red[w];
      if (tid == 0) {
        int total = 0;
        for (int w = 0; w < RAYS / 32; ++w) total += s_red[w];
        s_nlive = total;
      }
      if (rhit) {
        s_ray[0 * RAYS + pos] = oxl;
        s_ray[1 * RAYS + pos] = oyl;
        s_ray[2 * RAYS + pos] = ozl;
        s_ray[3 * RAYS + pos] = dx;
        s_ray[4 * RAYS + pos] = dy;
        s_ray[5 * RAYS + pos] = dz;
        s_ray[6 * RAYS + pos] = fminf(tminl, FAR);
        s_ray[7 * RAYS + pos] = fminf(capl, FAR);
        s_ray[8 * RAYS + pos] = oxl * dx + oyl * dy + ozl * dz;
        s_ray[9 * RAYS + pos] = oxl * oxl + oyl * oyl + ozl * ozl;
      }
      __syncthreads();
      const int n_live = s_nlive;
      if (n_live == 0) continue;  // uniform: no ray can touch this instance
      if (STATS && tid == 0) {
        ++n_cull;
        n_ray_cull += n_live;
      }

      // ---- 2. cull: the packet's packed key of every group this thread owns
      int lmin = INT_MAX;
      for (int g = tid; g < gp; g += RAYS) {
        int key = far_key;
        if (g < n_groups) {
          const float cx = sph[g], cy = sph[gp + g], cz = sph[2 * gp + g];
          const float cc = sph[3 * gp + g], r2 = sph[4 * gp + g];
          const float rad = sph[5 * gp + g];
          for (int k = 0; k < n_live; ++k) {
            const float lx = s_ray[0 * RAYS + k], ly = s_ray[1 * RAYS + k];
            const float lz = s_ray[2 * RAYS + k];
            const float ddx = s_ray[3 * RAYS + k], ddy = s_ray[4 * RAYS + k];
            const float ddz = s_ray[5 * RAYS + k];
            const float tminc = s_ray[6 * RAYS + k];
            const float capc = s_ray[7 * RAYS + k];
            const float od = s_ray[8 * RAYS + k], oo = s_ray[9 * RAYS + k];
            const float cd = ddx * cx + ddy * cy + ddz * cz;
            const float co = lx * cx + ly * cy + lz * cz;
            const float tc = cd - od;
            const float m2 = cc - 2.0f * co + oo - tc * tc;
            const float slack = (cc + 2.0f * fabsf(co) + oo + tc * tc) * 1e-6f;
            if (m2 <= r2 + slack && tc + rad >= tminc && tc - rad <= capc &&
                capc >= tminc)
              key = min(key, fbits(fmaxf(tc - rad, 0.0f) * scl) & ~GMASK);
          }
        }
        key |= g;
        s_key[g] = key;
        lmin = min(lmin, key);
      }
      __syncthreads();

      // ---- 3. near-to-far scan
      while (true) {
        const int wmin = __reduce_min_sync(0xffffffffu, lmin);
        if (lane == 0) s_red[warp] = wmin;
        __syncthreads();
        int kmin = s_red[0];
        for (int w = 1; w < RAYS / 32; ++w) kmin = min(kmin, s_red[w]);
        const int g = kmin & GMASK;
        const int dist = kmin & ~GMASK;
        const int bound = fbits(fminf(tmax, best));
        const bool wants = ANY_HIT ? dist < bound : dist <= bound;
        if (!__syncthreads_or(dist < far_key && wants)) break;

        const float* src = bw + static_cast<size_t>(g) * GROUP + tid;
#pragma unroll
        for (int r = 0; r < BW_ROWS; ++r) s_bw[r * GROUP + tid] = src[r * tp];
        if ((g & (RAYS - 1)) == tid) {  // retire the group
          s_key[g] = far_key | g;
          lmin = own_min(s_key, gp, tid);
        }
        if constexpr (STATS) {
          const int n_want = __syncthreads_count(wants);
          if (tid == 0) {
            ++n_test;
            n_ray_test += n_want;
          }
        } else {
          __syncthreads();
        }

        if (wants) {
          const int base = i * n_tris + g * GROUP;
          for (int k = 0; k < GROUP; ++k) {
            const float* w = s_bw + k;
            const float nd = dot3(w, 0, dx, dy, dz);
            if (!(fabsf(nd) > 1e-20f)) continue;
            const float no = __fadd_rn(dot3(w, 0, oxl, oyl, ozl), w[3 * GROUP]);
            const float t = __fmul_rn(-no, 1.0f / nd);
            const float u = __fmaf_rn(t, dot3(w, 4, dx, dy, dz),
                                      __fadd_rn(dot3(w, 4, oxl, oyl, ozl),
                                                w[7 * GROUP]));
            const float v = __fmaf_rn(t, dot3(w, 8, dx, dy, dz),
                                      __fadd_rn(dot3(w, 8, oxl, oyl, ozl),
                                                w[11 * GROUP]));
            const float t_w = __fmul_rn(t, scl);
            if (!(u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f &&
                  t > tminl && t_w < tmax))
              continue;
            if (ANY_HIT) {
              if (t_w < best) {
                best = 0.0f;
                break;
              }
            } else if (t_w < best || (t_w == best && base + k < best_idx)) {
              best = t_w;
              best_idx = base + k;
            }
          }
        }
        __syncthreads();  // s_bw and s_red are rewritten by the next pop
      }
    }
  }
  if (i_ray < n) {
    t_out[i_ray] = best;
    idx_out[i_ray] = ANY_HIT ? 0 : best_idx;
  }
  if (STATS && tid == 0) {
    int* row = stats_out + 4 * blockIdx.x;
    row[0] = n_cull;
    row[1] = n_test;
    row[2] = n_ray_cull;
    row[3] = n_ray_test;
  }
}

template <bool ANY_HIT, bool STATS>
int launch(const float* sph, int gp, const float* bw, const float* inst,
           int n_inst, const float* root, int n_groups, int n_tris,
           const float* o, const float* d, const float* tmin,
           const float* tmax, int n, float* t_out, int* idx_out, int* stats,
           cudaStream_t stream) {
  const int grid = (n + RAYS - 1) / RAYS;
  const size_t shmem = sizeof(int) * gp +
                       sizeof(float) * (BW_ROWS * GROUP + RAY_ROWS * RAYS);
  sweep_bvh_kernel<ANY_HIT, STATS><<<grid, RAYS, shmem, stream>>>(
      sph, gp, bw, inst, n_inst, root, n_groups, n_tris, o, d, tmin, tmax, n,
      t_out, idx_out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded through ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch. stats is
// [ceil(n/128), 4] int32 or null.
extern "C" int sweep_bvh_launch(const float* sph, int gp, const float* bw,
                                const float* inst, int n_inst,
                                const float* root, int n_groups, int n_tris,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                int any_hit, float* t_out, int* idx_out,
                                int* stats, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    return stats ? launch<true, true>(sph, gp, bw, inst, n_inst, root, n_groups,
                                      n_tris, o, d, tmin, tmax, n, t_out,
                                      idx_out, stats, s)
                 : launch<true, false>(sph, gp, bw, inst, n_inst, root,
                                       n_groups, n_tris, o, d, tmin, tmax, n,
                                       t_out, idx_out, stats, s);
  return stats ? launch<false, true>(sph, gp, bw, inst, n_inst, root, n_groups,
                                     n_tris, o, d, tmin, tmax, n, t_out,
                                     idx_out, stats, s)
               : launch<false, false>(sph, gp, bw, inst, n_inst, root,
                                      n_groups, n_tris, o, d, tmin, tmax, n,
                                      t_out, idx_out, stats, s);
}
