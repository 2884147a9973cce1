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
//   2. cull, in two levels, each ended by a barrier. (a) Thread j tests
//      super-sphere j (and j + 128), the sphere of the run of 32 groups
//      32j..32j+31, against every compacted ray (broadcast reads), and
//      keeps the 128-bit mask of the rays that pass it in shared memory.
//      (b) Warp w takes the supers s = w mod 4; for each word of 32 rays
//      of a super's mask that holds a ray, lane l takes group 32s + l and
//      runs its sphere test for each ray of the word in lockstep
//      (broadcast reads again). A group's packed key is (entry-distance
//      bits & ~8191) | group, the minimum over the rays that pass, merged
//      over the words by a shared-memory atomicMin (FAR when none does, as
//      every group of a super that no ray passes keeps). The supers
//      are wide enough that a ray failing one fails each member group's
//      own test (ops/sweep_bvh.py::super_spheres), so every key is the one
//      a flat cull of every group by every ray gives;
//   3. order: the groups whose key is below FAR are listed and the list is
//      sorted once by key (`sort_keys`, a bitonic sort in shared memory),
//      so popping it in order is popping the minimum key each time. The
//      list takes the super masks' space, dead after (b), where it fits
//      (Gp / 8 entries); a longer one is compacted to the front of the key
//      array in place (`compact_keys`);
//   4. scan: pop p is list entry p. Its sphere was copied into shared
//      memory two pops ahead (cp.async, `copy_sphere`), and thread j at
//      once requests triangle j's 9 values (p0, e1, e2) into registers
//      (one coalesced row per value), so the loads run while the want test
//      and its barrier do. The packet stops when no compacted ray's bound
//      min(tmax, best) reaches the entry's distance, or the list ends.
//      Otherwise thread k re-runs compacted ray k's own sphere test of the
//      group (the cull's arithmetic on the cull's inputs), and the rays
//      that both want the group and pass it form a 128-bit mask. A pop that
//      no ray wants ends there, after one barrier. Else thread j tests its
//      triangle against each ray of the mask, read from shared memory as a
//      broadcast; a closest hit is a 64-bit atomicMin on the ray's key, an
//      any hit a store that marks it occluded (its bound drops to 0: it
//      wants no later group); a second barrier publishes the keys. The
//      pops are the ones a block-wide minimum over the keys would make, in
//      the same order.
// The TPU kernel tested whole packets, since its MXU makes a 128 x 128
// contraction nearly free; here each ray-triangle test is ~55 float
// operations and an IEEE division, so only the (ray, group) pairs whose
// own sphere test passes are tested. Its packets-per-step, VMEM residency
// and streamed DMA mode are TPU constraints with no counterpart: the row
// table is read from global memory (L2-resident for a mesh of a million
// rows: 36 MB).
//
// What bounds it on this card: the culls and the scan's pops, not the
// triangle tests (a ray tests a few groups, about 1.2x the pairs a
// near-to-far traversal needs) and not bytes (rays are read once, a tested
// group's rows are 9 coalesced 512-byte loads). A flat cull ran Gp sphere
// tests (33 float operations) per compacted ray per instance and took
// about half of thread 0's cycles on a 2^20-ray wave of the 600k-triangle
// bunny; the two-level cull runs Gp / 32 super tests and 32 group tests
// per super a ray passes (a few), each still three broadcast float4 loads
// of the ray from shared memory. Listing and sorting add about a fifth to a
// cull. A pop costs one barrier, two when its group is tested; about
// three pops in five test nothing on the 600k garden's casts (PERF.md).
//
// Resources: dynamic shared memory 4 * Gp + 6,144 + 16 * Gp / 32 bytes
// (24,576 at Gp = 4,096, 43,008 at Gp = 8,192) and 1,216 static (1,232
// with the counters), under the 48 KB default, so no opt-in is needed;
// ptxas (sm_90a, CUDA 12.8): 62 registers and no spills without the
// counters (at most 64, by the launch bounds), 94 and 93 with them
// (closest, any hit); so 8 resident blocks per SM at Gp = 4,096
// (registers bind) and 5 at Gp = 8,192 (shared memory binds).
// chip_smoke.py prints both (phases 2 and 6).
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
#include <math.h>
#include <stdint.h>

#include "tri_mt.cuh"

namespace {

constexpr int GROUP = 128;
constexpr int RAYS = 128;
constexpr int WARPS = RAYS / 32;
constexpr int SUPER = 32;  // groups per super-sphere: one per lane of a warp
constexpr unsigned FULL = 0xffffffffu;
// ops/sweep_bvh.py's E_MAX and KT: a ray further than E_MAX from unit length
// (|1 - |d|^2|) passes every super; the intervals' margin per sqrt(S)
constexpr float E_MAX = 0.0078125f;
constexpr float KT = 1.52587890625e-05f;
constexpr int GMASK = 8191;
constexpr float FAR = 3.0e37f;
constexpr int MT_ROWS = 9;
// a compacted ray: (o', tmin' clamped), (d, cap' clamped), (o'.d, o'.o,
// tmin', world tmax)
constexpr int RAY_VEC = 3;
// the counters a packet (STATS): ops/sweep_bvh.py's STATS_COLS
constexpr int STATS_COLS = 10;

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

// a super-sphere: centre, |c|^2, the test's r^2 and r, its slack k1 and the
// factor F of ops/sweep_bvh.py::super_spheres
struct Super {
  float cx, cy, cz, cc, r2, rad, k1, f;
};

__device__ __forceinline__ Super load_super(const float* __restrict__ sup,
                                            int sp, int s) {
  return {__ldg(sup + s),          __ldg(sup + sp + s),
          __ldg(sup + 2 * sp + s), __ldg(sup + 3 * sp + s),
          __ldg(sup + 4 * sp + s), __ldg(sup + 5 * sp + s),
          __ldg(sup + 6 * sp + s), __ldg(sup + 7 * sp + s)};
}

// The super test of one compacted ray: sphere_test's expansion with the
// margins that make it pass wherever a member group's sphere_test passes,
// this rounding and that one's included (ops/sweep_bvh.py::super_spheres
// derives them; its super_test repeats this arithmetic). S is the slack's
// sum, e = |1 - |d|^2|.
__device__ __forceinline__ bool super_test(const Super& s, float4 a, float4 b,
                                           float od, float oo) {
  const float cd = dot3(b.x, b.y, b.z, s.cx, s.cy, s.cz);
  const float co = dot3(a.x, a.y, a.z, s.cx, s.cy, s.cz);
  const float tc = __fsub_rn(cd, od);
  const float m2 =
      __fmaf_rn(-tc, tc, __fadd_rn(__fmaf_rn(-2.0f, co, s.cc), oo));
  const float ss =
      __fmaf_rn(tc, tc, __fadd_rn(__fmaf_rn(2.0f, fabsf(co), s.cc), oo));
  const float e = fabsf(__fsub_rn(1.0f, dot3(b.x, b.y, b.z, b.x, b.y, b.z)));
  const float slack =
      __fmaf_rn(ss, __fmaf_rn(__fmaf_rn(2.6f, s.f, 2.1f), e, s.k1),
                __fmul_rn(__fmul_rn(s.r2, __fmul_rn(31.0f, s.f)), e));
  const float rt =
      __fmaf_rn(__fsqrt_rn(ss), KT, __fmul_rn(s.rad, __fadd_rn(1.0f, e)));
  return e > E_MAX ||
         (m2 <= __fadd_rn(s.r2, slack) && __fadd_rn(tc, rt) >= a.w &&
          __fsub_rn(tc, rt) <= b.w && b.w >= a.w);
}

// Moves the keys below far_key of a[0, n) to its front, in place, 128 at a
// time: a chunk is read before its barrier and its keys land below its
// end, where every key was read already. cnt: scratch of 2 x WARPS words
// (alternating by chunk). Ends with a barrier.
__device__ void compact_keys(int* a, int n, int far_key,
                             unsigned (*cnt)[WARPS], int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  int base = 0;
  for (int c = 0; c * RAYS < n; ++c) {
    const int g = c * RAYS + tid;
    const int k = g < n ? a[g] : far_key;
    const unsigned b = __ballot_sync(FULL, k < far_key);
    if (lane == 0) cnt[c & 1][warp] = __popc(b);
    __syncthreads();
    int pos = base + __popc(b & ((1u << lane) - 1));
    for (int w = 0; w < WARPS; ++w) {
      const int m = cnt[c & 1][w];
      if (w < warp) pos += m;
      base += m;
    }
    if (k < far_key) a[pos] = k;
  }
  __syncthreads();
}

// Sorts a[0, n) ascending in place, the block's threads together, by a
// bitonic network over the next power of two whose merges compare mirrored
// pairs first: every comparison puts the smaller key at the lower index,
// so the virtual keys past n (+inf) never move and a pair that reaches
// past n is skipped. Thread tid takes pairs tid, tid + RAYS, ...; a step
// whose pairs lie j <= 32 apart stays inside each warp's own spans of 64
// keys, so only the steps around a wider one take a block barrier. Ends
// with a barrier.
__device__ void sort_keys(int* a, int n, int tid) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < p >> 1; q += RAYS) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int h = j == k >> 1 ? i ^ (k - 1) : i + j;
        if (h < n) {
          const int x = a[i], y = a[h];
          if (y < x) {
            a[i] = y;
            a[h] = x;
          }
        }
      }
      // the next step: (k, j / 2), or (2k, k) once j is 1
      const int next = j > 1 ? j >> 1 : (k < p ? k : 0);
      if (j > 32 || next > 32)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  __syncthreads();
}

// Where on: threads 0-5 copy group g's sphere (cx, cy, cz, |c|^2, r^2, r)
// into dst[0, 6) by cp.async, which holds no register while the copy is in
// flight. Every thread then closes a commit group, one a call, so that
// wait_older() counts alike on every thread.
__device__ __forceinline__ void copy_sphere(float* dst, const float* sph,
                                            int gp, int g, int tid, bool on) {
  if (on && tid < 6) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + tid));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(sph + static_cast<size_t>(tid) * gp + g));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until every copy_sphere of this thread but its latest has landed.
__device__ __forceinline__ void wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Without the counters, 8 resident blocks an SM at Gp = 4,096: at most 64
// registers a thread.
template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(RAYS, STATS ? 1 : 8)
sweep_bvh_kernel(const float* __restrict__ sph, int gp,
                 const float* __restrict__ mt, const float* __restrict__ inst,
                 int n_inst, const float* __restrict__ root, int n_groups,
                 int n_tris, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tmin_in,
                 const float* __restrict__ tmax_in, int n,
                 float* __restrict__ t_out, int* __restrict__ idx_out,
                 uint8_t* __restrict__ valid_out,
                 long long* __restrict__ stats_out,
                 const float* __restrict__ sup) {
  extern __shared__ float4 smem[];
  float4* s_ray = smem;                                        // [RAYS][3]
  int* s_key = reinterpret_cast<int*>(smem + RAY_VEC * RAYS);  // [gp]
  // per super, the mask of the compacted rays that pass it: word w (rays
  // 32w..32w+31) of super s at s_smask[w * sp + s]
  unsigned* s_smask = reinterpret_cast<unsigned*>(s_key + gp);
  __shared__ unsigned long long s_best[RAYS];
  __shared__ unsigned long long s_count[2];
  __shared__ int s_red[WARPS];
  __shared__ unsigned s_mask[2][WARPS], s_live[2][WARPS];
  __shared__ int s_nlive;
  // the spheres of list entries p, p + 1, p + 2 at pop p: entry e in e % 3
  __shared__ float s_sph[3][8];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int i_ray = blockIdx.x * RAYS + tid;
  const size_t tp = static_cast<size_t>(n_groups) * GROUP;
  const int far_key = fbits(FAR) & ~GMASK;
  const int sp = gp / SUPER;
  const int n_sup = (n_groups + SUPER - 1) / SUPER;

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
  // (past the root test in each cull, testing in each tested group),
  // thread 0's clock64() cycles in the culls (the sort included) and in
  // the scans, this thread's (ray, super) passes and group sphere tests in
  // the culls, and the groups the culls listed and the scans popped
  long long n_cull = 0, n_test = 0, n_ray_cull = 0, n_ray_test = 0;
  long long cyc_cull = 0, cyc_scan = 0, n_sup_pass = 0, n_grp_test = 0;
  long long n_listed = 0, n_pop = 0;
  if (STATS && tid == 0) s_count[0] = s_count[1] = 0;

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

      // ---- 2a. super cull: thread tid tests supers tid (and tid + RAYS)
      // against every compacted ray; every key starts culled out
      for (int g = tid; g < gp; g += RAYS) s_key[g] = far_key | g;
      for (int s = tid; s < sp; s += RAYS) {
        const bool ok = s < n_sup;
        const Super su = load_super(sup, sp, ok ? s : 0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          unsigned bits = 0;
          const int end = ok ? min(n_live - 32 * w, 32) : 0;
          for (int j = 0; j < end; ++j) {
            const int k = 32 * w + j;
            const float4 c = s_ray[RAY_VEC * k + 2];
            if (super_test(su, s_ray[RAY_VEC * k], s_ray[RAY_VEC * k + 1],
                           c.x, c.y))
              bits |= 1u << j;
          }
          s_smask[w * sp + s] = bits;
          if (STATS) n_sup_pass += __popc(bits);
        }
      }
      __syncthreads();

      // ---- 2b. group cull: a warp takes each super of its share (s = warp
      // mod WARPS) that a word of rays passes, lane l group SUPER * s + l,
      // and tests the word's rays in lockstep; a group's key is the minimum
      // over every word, by atomicMin
      for (int w = 0; 32 * w < n_live; ++w) {
        for (int s0 = 0; s0 < sp; s0 += RAYS) {
          const int sl = s0 + WARPS * lane + warp;
          const unsigned word = sl < sp ? s_smask[w * sp + sl] : 0u;
          unsigned todo = __ballot_sync(FULL, word != 0u);
          while (todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            unsigned m = __shfl_sync(FULL, word, src);
            const int g = SUPER * (s0 + WARPS * src + warp) + lane;
            const bool ok = g < n_groups;
            const Sphere sg = load_sphere(sph, gp, ok ? g : 0);
            if (STATS && ok) n_grp_test += __popc(m);
            int key = far_key;
            while (m) {
              const int k = 32 * w + __ffs(m) - 1;
              m &= m - 1;
              const float4 c = s_ray[RAY_VEC * k + 2];
              float e;
              if (sphere_test(sg, s_ray[RAY_VEC * k], s_ray[RAY_VEC * k + 1],
                              c.x, c.y, e))
                key = min(key, fbits(__fmul_rn(fmaxf(e, 0.0f), scl)) & ~GMASK);
            }
            if (ok && key < far_key) atomicMin(&s_key[g], key | g);
          }
        }
      }
      __syncthreads();

      // ---- 3. the pop order: the listed groups (key below far_key) in a
      // list sorted once. Thread tid counts its own (groups tid, tid +
      // RAYS, ...; bit m of `own` for group tid + RAYS * m, gp <= 8,192);
      // a block scan places them. The list goes into the super masks,
      // dead after 2b, where it fits; else it is compacted to the front of
      // the key array, in place.
      int n_own = 0;
      unsigned long long own = 0;
      for (int g = tid, m = 0; g < n_groups; g += RAYS, ++m) {
        if (s_key[g] < far_key) {
          ++n_own;
          own |= 1ull << m;
        }
      }
      int off = n_own;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(FULL, off, s);
        if (lane >= s) off += v;
      }
      if (lane == 31) s_red[warp] = off;
      __syncthreads();
      off -= n_own;
      int n_list = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (w < warp) off += s_red[w];
        n_list += s_red[w];
      }
      const bool fits = n_list <= WARPS * sp;  // uniform
      int* s_list = fits ? reinterpret_cast<int*>(s_smask) : s_key;
      if (fits) {
        while (own) {
          const int m = __ffsll(static_cast<long long>(own)) - 1;
          own &= own - 1;
          s_list[off++] = s_key[tid + RAYS * m];
        }
      }
      __syncthreads();  // s_red is free again: the next instance writes it
      if (!fits) compact_keys(s_key, n_groups, far_key, s_mask, tid);
      sort_keys(s_list, n_list, tid);
      if (STATS && tid == 0) {
        const long long now = clock64();
        cyc_cull += now - clk;
        n_listed += n_list;
        clk = now;
      }

      // ---- 4. near-to-far scan: pop p is list entry p. Its sphere was
      // copied into s_sph two pops ahead: pop p asks for entry p + 2's and
      // waits, before its barrier, for entry p + 1's, which that barrier
      // then shows to every thread.
      int entry = n_list > 0 ? s_list[0] : 0;
      copy_sphere(s_sph[0], sph, gp, entry & GMASK, tid, n_list > 0);
      copy_sphere(s_sph[1], sph, gp, n_list > 1 ? s_list[1] & GMASK : 0, tid,
                  n_list > 1);
      wait_older();
      __syncthreads();
      for (int p = 0, ring = 0; p < n_list;
           ++p, ring = ring == 2 ? 0 : ring + 1) {
        const int g = entry & GMASK;
        const int dist = entry & ~GMASK;
        copy_sphere(s_sph[ring == 0 ? 2 : ring - 1], sph, gp,
                    p + 2 < n_list ? s_list[p + 2] & GMASK : 0, tid,
                    p + 2 < n_list);
        // rows requested before the want test (speculative): thread tid's
        // triangle, 9 values (p0, e1, e2), one coalesced row each
        const float* src = mt + static_cast<size_t>(g) * GROUP + tid;
        float wr[MT_ROWS];
#pragma unroll
        for (int r = 0; r < MT_ROWS; ++r) wr[r] = __ldg(src + r * tp);
        if (p + 1 < n_list) entry = s_list[p + 1];
        // compacted ray tid: does its bound reach the group, and does its
        // own sphere test keep it?
        bool live = false, mine = false;
        if (tid < n_live) {
          const float4 c = s_ray[RAY_VEC * tid + 2];
          const int bound = fbits(fminf(c.w, key_to_t(s_best[tid])));
          live = ANY_HIT ? dist < bound : dist <= bound;
          if (live) {
            float e;
            const float* q = s_sph[ring];
            const Sphere sg = {q[0], q[1], q[2], q[3], q[4], q[5]};
            mine = sphere_test(sg, s_ray[RAY_VEC * tid],
                               s_ray[RAY_VEC * tid + 1], c.x, c.y, e);
          }
        }
        // the masks alternate by pop: an idle pop has no barrier after its
        // reads, and pop p + 2 writes only after pop p + 1's barrier
        const int buf = p & 1;
        const unsigned bm = __ballot_sync(FULL, mine);
        const unsigned bl = __ballot_sync(FULL, live);
        if (lane == 0) {
          s_mask[buf][warp] = bm;
          s_live[buf][warp] = bl;
        }
        wait_older();  // the next entry's sphere has landed
        __syncthreads();
        unsigned any_live = 0, any_mine = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          any_live |= s_live[buf][w];
          any_mine |= s_mask[buf][w];
        }
        if (!any_live) break;  // uniform: the packet stops
        if (STATS && tid == 0) ++n_pop;

        // ---- thread tid tests triangle tid of g against each wanting ray
        if (any_mine) {  // uniform
          const int idx = i * n_tris + g * GROUP + tid;
          if (STATS && tid == 0) {
            ++n_test;
#pragma unroll
            for (int w = 0; w < WARPS; ++w)
              n_ray_test += __popc(s_mask[buf][w]);
          }
          for (int w = 0; w < WARPS; ++w) {
            unsigned m = s_mask[buf][w];
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
                s_best[k] = hit_key(0.0f, 0);  // occluded: the bound drops
              else
                atomicMin(&s_best[k], hit_key(t_w, idx));
            }
          }
          __syncthreads();  // s_best is read by the next pop
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left over
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
  if (STATS) {
    atomicAdd(&s_count[0], static_cast<unsigned long long>(n_sup_pass));
    atomicAdd(&s_count[1], static_cast<unsigned long long>(n_grp_test));
    __syncthreads();
    if (tid == 0) {
      long long* row = stats_out + STATS_COLS * blockIdx.x;
      row[0] = n_cull;
      row[1] = n_test;
      row[2] = n_ray_cull;
      row[3] = n_ray_test;
      row[4] = cyc_cull;
      row[5] = cyc_scan;
      row[6] = static_cast<long long>(s_count[0]);
      row[7] = static_cast<long long>(s_count[1]);
      row[8] = n_listed;
      row[9] = n_pop;
    }
  }
}

size_t shmem_bytes(int gp) {
  return sizeof(float4) * RAY_VEC * RAYS + sizeof(int) * gp +
         sizeof(unsigned) * WARPS * (gp / SUPER);
}

template <bool ANY_HIT, bool STATS>
int launch(const float* sph, int gp, const float* mt, const float* inst,
           int n_inst, const float* root, int n_groups, int n_tris,
           const float* o, const float* d, const float* tmin,
           const float* tmax, int n, float* t_out, int* idx_out,
           uint8_t* valid_out, long long* stats, const float* sup,
           cudaStream_t stream) {
  const int grid = (n + RAYS - 1) / RAYS;
  sweep_bvh_kernel<ANY_HIT, STATS><<<grid, RAYS, shmem_bytes(gp), stream>>>(
      sph, gp, mt, inst, n_inst, root, n_groups, n_tris, o, d, tmin, tmax, n,
      t_out, idx_out, valid_out, stats, sup);
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
// [ceil(n/128), 10] int64 or null; valid_out is null or [n] bool,
// isfinite(t_out); sup is the [8, gp/32] super-sphere table (each the last
// argument it added, so a build of the entry without it takes the same
// call and leaves it).
extern "C" int sweep_bvh_launch(const float* sph, int gp, const float* mt,
                                const float* inst, int n_inst,
                                const float* root, int n_groups, int n_tris,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                int any_hit, float* t_out, int* idx_out,
                                long long* stats, void* stream,
                                uint8_t* valid_out, const float* sup) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    return stats ? launch<true, true>(sph, gp, mt, inst, n_inst, root, n_groups,
                                      n_tris, o, d, tmin, tmax, n, t_out,
                                      idx_out, valid_out, stats, sup, s)
                 : launch<true, false>(sph, gp, mt, inst, n_inst, root,
                                       n_groups, n_tris, o, d, tmin, tmax, n,
                                       t_out, idx_out, valid_out, stats, sup,
                                       s);
  return stats ? launch<false, true>(sph, gp, mt, inst, n_inst, root, n_groups,
                                     n_tris, o, d, tmin, tmax, n, t_out,
                                     idx_out, valid_out, stats, sup, s)
               : launch<false, false>(sph, gp, mt, inst, n_inst, root,
                                      n_groups, n_tris, o, d, tmin, tmax, n,
                                      t_out, idx_out, valid_out, stats, sup,
                                      s);
}

// Resident blocks per SM of the closest-hit kernel without counters at
// this Gp (the launch's block size and shared memory).
extern "C" int sweep_bvh_blocks_per_sm(int gp) {
  return blocks_per_sm<false, false>(gp);
}
