// 8-wide BVH traversal on Hopper (sm_90a): closest hit or any hit.
//
// Replaces the TPU packet kernel jet_pbrt_tpu/ops/wide_bvh.py
// (_wide_kernel / _wide_tile, entered through intersect_wide). It computes
// the same thing: per ray, the closest accepted triangle (world t and index
// inst * n_tris + triangle row) or an any-hit bit, over an 8-wide BVH with
// two-level instancing (uniform scale + translation; the ray is re-derived
// in instance space, t stays in world units).
//
// What bounds it on this card. Not bytes: the bunny's tables (about 1 MB of
// bounds, 2.4 MB of triangles) sit in the 50 MB L2, and a cast moves 40 B
// per ray. Not float operations at the card's peak either. A node step is
// hundreds of instructions (8 slab tests, the ranking, the pushes) for one
// lane, so the walk is bound by instruction issue at low SIMD efficiency
// (lanes of a warp walk different subtrees; about a third of the lanes
// work in a node step) and, where few rays survive, by the latency of the
// longest walk.
// The frame's casts are mostly of the second kind: of 2^20 lanes, 1.6k to
// 140k survive the root test (PERF.md).
//
// Design. A cast is two passes on one stream, and the host reads nothing
// back between them:
//   1. cull (one thread per lane): a dead lane, which reads only tmin and
//      tmax, or a lane whose root visit pushes no child, writes its miss
//      and stops; the others append their index to a survivor list, one
//      atomicAdd per warp (ballot and popc, so lane order within a warp is
//      kept);
//   2. walk (persistent warps, Aila & Laine 2009): a grid of the resident
//      blocks per SM times the SMs; each warp claims survivors with
//      atomicAdd on a device-side cursor until the list is spent, so no SM
//      waits on a block held by one long ray. A claim is twice the even
//      share of the list, at least 1 and at most 32: a short list spreads
//      over many warps, so that a long walk shares its warp with few
//      divergent lanes, and a long one fills every warp. Each lane walks
//      its ray behind a private stack (local memory) of 8-byte entries
//      (code, entry t): an instance entry (INST_FLAG | i) stays a TLAS
//      entry until it is popped, which loads instance i and records the
//      stack depth below which entries are world-space again (a BLAS walk
//      ends before the TLAS resumes). A node pop reads the node's
//      child-planar float32 bounds as twelve aligned float4 loads and its
//      8 child codes as two int4 loads, ranks the hit children by (entry t,
//      slot) with 28 comparisons when more than one is hit, and stores
//      each at its rank (nearest on top); a leaf pop runs Moller-Trumbore
//      (csrc/tri_mt.cuh, shared with the sweep) over its leaf_size rows in
//      slot order.
// Tried on the card and not kept (PERF.md, `sweep_ab.py --wide`): one
// launch whose persistent warps scan the lanes themselves and queue the
// survivors in shared memory (no list, no memset, but more registers, fewer
// resident blocks and a slower scan: 13-17% slower on the 2^20 wave), the
// while-while loop (lower SIMD efficiency, slower), one ray per 8 lanes
// (lane k tests child k; higher SIMD efficiency, slower), claims of 32 or
// of the even share, a walk capped at 40 or 32 registers (spills), and a
// smaller grid.
//
// One walk with the plain version (ops/wide_bvh.py::intersect_wide_plain):
// every product, sum and quotient of the slab test, the instance transform
// and Moller-Trumbore is pinned (__fmul_rn / __fsub_rn / __fadd_rn /
// __fdiv_rn) in the order the plain version's torch ops round them, and
// both pop a node's children in the total order (entry t, slot) in both
// modes. So the two visit the same nodes in the same order and agree bit
// for bit on t, index and valid; the STATS build counts the same node and
// leaf visits as intersect_wide_plain(with_stats=True).
//
// Semantics kept from the reference kernel: the clamp-form slab test
// (lo = max(t_enter, tmin), hi = min(t_exit, cap), hit iff lo <= hi) with
// the 1e-12 inverse-direction guard; the triangle accept rule
// min(u, v, 1-u-v) >= 0, tt > tmin_local, t_world < min(tmax, best) (so a
// shadow ray is never occluded beyond its finite tmax); dead lanes
// (tmin = +inf or NaN, tmax < 0, or a NaN in the ray) miss at once. Division
// is exact IEEE. Row 0 of the instance table is the identity (ops/
// wide_bvh.py::_inst_table), so TLAS nodes are tested on the world ray.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri_mt.cuh"

namespace {

constexpr int WIDTH = 8;
constexpr int LEAF_FLAG = 1 << 30;
constexpr int INST_FLAG = 1 << 29;
constexpr int STACK = 128;  // ops/wide_bvh.py STACK; the wrapper checks depth
constexpr int CULL_BLOCK = 256;
constexpr int WALK_BLOCK = 128;
constexpr int WARPS = WALK_BLOCK / 32;
constexpr int STATS_COLS = 10;  // ops/wide_bvh.py STATS_COLS
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float inv_guard(float c) {
  const float eps = 1e-12f;
  return __fdiv_rn(1.0f, fabsf(c) < eps ? (c < 0.0f ? -eps : eps) : c);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax,
                                        int i) {
  return {__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
          __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2),
          __ldg(tmin + i), __ldg(tmax + i)};
}

__device__ __forceinline__ bool dead(const Ray& r) {
  return !(r.tmax >= 0.0f) || isinf(r.tmin) || isnan(r.tmin) ||
         isnan(r.ox) || isnan(r.oy) || isnan(r.oz) || isnan(r.dx) ||
         isnan(r.dy) || isnan(r.dz);
}

// component c (a constant after unrolling) of a float4
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ int comp(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The ray in the space of the node being visited: origin, tmin, and the
// instance's scale and its reciprocal (1 and 1 in world space).
struct Space {
  float ox, oy, oz, tmin, scl, inv;
};

// Slab test of node `node`'s 8 children: code[k] gets child k's code,
// key[k] its entry distance in world units (lo * scl), and bit k of the
// result says that child k is not empty and is entered within
// [tmin, capl]. planar is [N8, 6, 8] float32 (lo.x, lo.y, lo.z, hi.x, hi.y,
// hi.z rows of 8 children), 12 float4 per node; child is [N8, 8] int32.
__device__ __forceinline__ unsigned visit_node(
    const float4* __restrict__ planar, const int4* __restrict__ child,
    int node, const Space& s, float ix, float iy, float iz, float capl,
    float key[WIDTH], int code[WIDTH]) {
  float4 b[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) b[q] = __ldg(planar + 12 * (size_t)node + q);
  const int4 c0 = __ldg(child + 2 * (size_t)node);
  const int4 c1 = __ldg(child + 2 * (size_t)node + 1);
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) {
    // row r, child k sits in b[2 * r + k / 4], component k % 4
    const int q = k >> 2, c = k & 3;
    const float t0x = __fmul_rn(__fsub_rn(comp(b[0 + q], c), s.ox), ix);
    const float t0y = __fmul_rn(__fsub_rn(comp(b[2 + q], c), s.oy), iy);
    const float t0z = __fmul_rn(__fsub_rn(comp(b[4 + q], c), s.oz), iz);
    const float t1x = __fmul_rn(__fsub_rn(comp(b[6 + q], c), s.ox), ix);
    const float t1y = __fmul_rn(__fsub_rn(comp(b[8 + q], c), s.oy), iy);
    const float t1z = __fmul_rn(__fsub_rn(comp(b[10 + q], c), s.oz), iz);
    const float t_en = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
    const float t_ex = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
    const float lo = fmaxf(t_en, s.tmin);
    const float hi = fminf(t_ex, capl);
    code[k] = comp(k < 4 ? c0 : c1, c);
    key[k] = __fmul_rn(lo, s.scl);
    if (lo <= hi && code[k] != -1) mask |= 1u << k;
  }
  return mask;
}

// Adds to rank[k] (zeroed by the caller) the rank of each hit child among
// the hits in the order (key, slot): for slots j < k, j comes first unless
// its key is larger.
__device__ __forceinline__ void rank_hits(unsigned mask, const float key[WIDTH],
                                          int rank[WIDTH]) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
#pragma unroll
    for (int k = j + 1; k < WIDTH; ++k) {
      const bool first = key[j] <= key[k];
      rank[k] += ((mask >> j) & 1u) & first;
      rank[j] += ((mask >> k) & 1u) & !first;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: the root visit of every lane, and the survivor list
// ---------------------------------------------------------------------------

template <bool STATS>
__global__ void __launch_bounds__(CULL_BLOCK)
wide_cull_kernel(const float4* __restrict__ planar,
                 const int4* __restrict__ child, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n,
                 float* __restrict__ t_out, int* __restrict__ idx_out,
                 uint8_t* __restrict__ valid_out,
                 int* __restrict__ survivors, int* __restrict__ counter,
                 unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * CULL_BLOCK + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool live = false, keep = false;
  if (i < n) {
    // a dead lane reads 8 bytes, not 32
    const float tn = __ldg(tmin + i), tx = __ldg(tmax + i);
    const Ray r = tx >= 0.0f && !isinf(tn) && !isnan(tn)
                      ? load_ray(o, d, tmin, tmax, i)
                      : Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, tn, tx};
    live = !dead(r);
    if (live) {
      const Space s{r.ox, r.oy, r.oz, r.tmin, 1.0f, 1.0f};
      float key[WIDTH];
      int code[WIDTH];
      keep = visit_node(planar, child, 0, s, inv_guard(r.dx), inv_guard(r.dy),
                        inv_guard(r.dz), r.tmax, key, code) != 0;
    }
    if (!keep) {
      t_out[i] = INFINITY;
      idx_out[i] = 0;
      if (valid_out) valid_out[i] = 0;
    }
  }
  const unsigned m = __ballot_sync(FULL, keep);
  if (m) {
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counter, __popc(m));
    base = __shfl_sync(FULL, base, leader);
    if (keep) survivors[base + __popc(m & ((1u << lane) - 1u))] = i;
  }
  if (STATS) {
    // row 0: root visits of the live lanes this pass retires, live lanes
    const unsigned lv = __ballot_sync(FULL, live);
    if (lane == 0 && lv) {
      atomicAdd(stats + 0, static_cast<unsigned long long>(__popc(lv & ~m)));
      atomicAdd(stats + 4, static_cast<unsigned long long>(__popc(lv)));
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: persistent warps walk the survivors
// ---------------------------------------------------------------------------

// Lane-0 clock of a stats segment: adds the cycles since `clk` to `acc`.
template <bool STATS>
__device__ __forceinline__ void lap(long long& clk, long long& acc) {
  if (STATS) {
    const long long now = clock64();
    acc += now - clk;
    clk = now;
  }
}

template <bool ANY_HIT, bool HAS_INST, bool STATS>
__global__ void __launch_bounds__(WALK_BLOCK)
wide_walk_kernel(const float4* __restrict__ planar,
                 const int4* __restrict__ child, const float* __restrict__ tris,
                 const float4* __restrict__ inst, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tmin_in,
                 const float* __restrict__ tmax_in, int blas_root,
                 int leaf_size, int n_tris, const int* __restrict__ survivors,
                 int* __restrict__ counter, float* __restrict__ t_out,
                 int* __restrict__ idx_out, uint8_t* __restrict__ valid_out,
                 long long* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * WALK_BLOCK + threadIdx.x) >> 5;
  const int count = counter[0];  // written by the cull pass on this stream
  // survivors a warp claims at a time: twice the even share, 1 to 32 (a
  // short list spreads over the warps, a mid-size one fills half of them
  // twice as full, which issues fewer warp instructions for the same lanes)
  const int warps = gridDim.x * WARPS;
  const int take = min(32, max(1, (2 * count + warps - 1) / warps));
  // STATS: per lane, node and leaf visits, and rays walked; per warp (its
  // first active lane), node and leaf steps and the lanes at work in them;
  // lane 0's cycles in node work, leaf work and stack work (pops, pushes,
  // instance switches)
  unsigned n_node = 0, n_leaf = 0, n_rays = 0, node_steps = 0, leaf_steps = 0;
  unsigned node_lanes = 0, leaf_lanes = 0;
  long long cyc_node = 0, cyc_leaf = 0, cyc_stack = 0, clk = 0;
  int2 stack[STACK];

  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter + 1, take);
    base = __shfl_sync(FULL, base, 0);
    if (base >= count) break;
    const int j = base + lane;
    if (lane < take && j < count) {
      const int i = survivors[j];
      const Ray r = load_ray(o, d, tmin_in, tmax_in, i);
      const float ix = inv_guard(r.dx), iy = inv_guard(r.dy),
                  iz = inv_guard(r.dz);
      const Space world{r.ox, r.oy, r.oz, r.tmin, 1.0f, 1.0f};
      Space s = world;
      float best = INFINITY;
      int best_idx = 0;
      bool occluded = false;
      int cur = -1;      // instance loaded into s, -1 in world space
      int world_sp = 0;  // entries below this depth are world-space
      int code = 0;      // the popped entry
      stack[0] = make_int2(0, __float_as_int(0.0f));
      int sp = 1;
      if (STATS) {
        ++n_rays;
        clk = clock64();
      }

      // next entry within min(tmax, best) into `code`, the ray moved into
      // its space; false when the stack is spent
      auto pop = [&]() -> bool {
        while (sp > 0) {
          --sp;
          const int2 e = stack[sp];
          if (!(__int_as_float(e.y) <= fminf(r.tmax, best))) continue;
          code = e.x;
          if (HAS_INST) {
            if (code & INST_FLAG) {  // enter instance i at the BLAS root
              cur = code & ~INST_FLAG;
              world_sp = sp;
              const float4 row = __ldg(inst + cur + 1);
              const float inv = __fdiv_rn(1.0f, row.w);
              s = Space{__fmul_rn(__fsub_rn(r.ox, row.x), inv),
                        __fmul_rn(__fsub_rn(r.oy, row.y), inv),
                        __fmul_rn(__fsub_rn(r.oz, row.z), inv),
                        __fmul_rn(r.tmin, inv), row.w, inv};
              code = blas_root;
            } else if (cur >= 0 && sp < world_sp) {  // back in the TLAS
              cur = -1;
              s = world;
            }
          }
          lap<STATS>(clk, cyc_stack);
          return true;
        }
        lap<STATS>(clk, cyc_stack);
        return false;
      };

      // slab-test the popped node's children, push the hits far to near
      auto node = [&]() {
        if (STATS) {
          ++n_node;
          const unsigned am = __activemask();
          if (lane == __ffs(am) - 1) {
            ++node_steps;
            node_lanes += __popc(am);
          }
        }
        const float cap = fminf(r.tmax, best);
        float key[WIDTH];
        int cc[WIDTH], rank[WIDTH];
        const unsigned mask =
            visit_node(planar, child, code, s, ix, iy, iz,
                       HAS_INST ? __fmul_rn(cap, s.inv) : cap, key, cc);
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) rank[k] = 0;
        if (mask & (mask - 1)) rank_hits(mask, key, rank);  // 2+ hits
        lap<STATS>(clk, cyc_node);
        const int top = sp + __popc(mask) - 1;  // the nearest hit on top
#pragma unroll
        for (int k = 0; k < WIDTH; ++k)
          if (mask & (1u << k))
            stack[top - rank[k]] = make_int2(cc[k], __float_as_int(key[k]));
        sp = top + 1;
        lap<STATS>(clk, cyc_stack);
      };

      // Moller-Trumbore over the popped leaf's rows in slot order
      auto leaf = [&]() {
        if (STATS) {
          ++n_leaf;
          const unsigned am = __activemask();
          if (lane == __ffs(am) - 1) {
            ++leaf_steps;
            leaf_lanes += __popc(am);
          }
        }
        const int l = code & ~LEAF_FLAG;
        const float* tr = tris + (size_t)l * leaf_size * 9;
        for (int k = 0; k < leaf_size; ++k, tr += 9) {
          float t_w;
          if (!mt_test([&](int j) { return __ldg(tr + j); }, s.ox, s.oy,
                       s.oz, r.dx, r.dy, r.dz, s.tmin, fminf(r.tmax, best),
                       s.scl, t_w))
            continue;
          if (ANY_HIT) {
            occluded = true;
            break;
          }
          best = t_w;
          best_idx = (HAS_INST ? cur * n_tris : 0) + l * leaf_size + k;
        }
        lap<STATS>(clk, cyc_leaf);
      };

      bool have = pop();
      while (have) {
        if (code & LEAF_FLAG) {
          leaf();
          if (ANY_HIT && occluded) break;
        } else {
          node();
        }
        have = pop();
      }
      if (ANY_HIT) {
        t_out[i] = occluded ? 0.0f : INFINITY;
        idx_out[i] = 0;
        if (valid_out) valid_out[i] = occluded;
      } else {
        t_out[i] = best;
        idx_out[i] = best_idx;
        if (valid_out) valid_out[i] = isfinite(best);
      }
    }
    __syncwarp();
  }
  if (STATS) {
    const unsigned v_node = __reduce_add_sync(FULL, n_node);
    const unsigned v_leaf = __reduce_add_sync(FULL, n_leaf);
    const unsigned v_nstep = __reduce_add_sync(FULL, node_steps);
    const unsigned v_lstep = __reduce_add_sync(FULL, leaf_steps);
    const unsigned v_rays = __reduce_add_sync(FULL, n_rays);
    const unsigned v_nlanes = __reduce_add_sync(FULL, node_lanes);
    const unsigned v_llanes = __reduce_add_sync(FULL, leaf_lanes);
    if (lane == 0) {
      long long* row = stats + STATS_COLS * (1 + (size_t)warp);
      row[0] = v_node;
      row[1] = v_leaf;
      row[2] = v_nstep;
      row[3] = v_lstep;
      row[4] = v_rays;
      row[5] = v_nlanes;
      row[6] = v_llanes;
      row[7] = cyc_node;
      row[8] = cyc_leaf;
      row[9] = cyc_stack;
    }
  }
}

template <bool ANY_HIT, bool HAS_INST, bool STATS>
int walk_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wide_walk_kernel<ANY_HIT, HAS_INST, STATS>, WALK_BLOCK, 0);
    grid = blocks * sms;
  }
  return grid;
}

struct Args {
  const float4* planar;
  const int4* child;
  const float* tris;
  const float4* inst;
  const float *o, *d, *tmin, *tmax;
  int n, blas_root, leaf_size, n_tris;
  float* t_out;
  int *idx_out, *survivors, *counter;
  long long* stats;
  uint8_t* valid_out;
};

template <bool ANY_HIT, bool HAS_INST, bool STATS>
int cast(const Args& a, cudaStream_t s) {
  cudaMemsetAsync(a.counter, 0, 2 * sizeof(int), s);
  if (STATS) cudaMemsetAsync(a.stats, 0, STATS_COLS * sizeof(long long), s);
  wide_cull_kernel<STATS><<<(a.n + CULL_BLOCK - 1) / CULL_BLOCK, CULL_BLOCK, 0,
                            s>>>(
      a.planar, a.child, a.o, a.d, a.tmin, a.tmax, a.n, a.t_out, a.idx_out,
      a.valid_out, a.survivors, a.counter,
      reinterpret_cast<unsigned long long*>(a.stats));
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  wide_walk_kernel<ANY_HIT, HAS_INST, STATS>
      <<<walk_grid<ANY_HIT, HAS_INST, STATS>(), WALK_BLOCK, 0, s>>>(
          a.planar, a.child, a.tris, a.inst, a.o, a.d, a.tmin, a.tmax,
          a.blas_root, a.leaf_size, a.n_tris, a.survivors, a.counter,
          a.t_out, a.idx_out, a.valid_out, a.stats);
  return static_cast<int>(cudaGetLastError());
}

template <bool ANY_HIT, bool HAS_INST>
int grid_of(int stats) {
  return stats ? walk_grid<ANY_HIT, HAS_INST, true>()
               : walk_grid<ANY_HIT, HAS_INST, false>();
}

template <bool ANY_HIT, bool HAS_INST>
int cast_stats(const Args& a, cudaStream_t s) {
  return a.stats ? cast<ANY_HIT, HAS_INST, true>(a, s)
                 : cast<ANY_HIT, HAS_INST, false>(a, s);
}

}  // namespace

// Plain C entry point, loaded through ctypes: one cast, the cull pass then
// the walk, on `stream` without synchronising; returns the first
// cudaGetLastError() that is not 0. survivors is [n] int32 and counter
// [2] int32 scratch (zeroed here); stats is null or
// [1 + wide_bvh_walk_warps(...), STATS_COLS] int64, row 0 the cull's;
// valid_out is null or [n] bool, isfinite(t_out) (the last argument, so a
// build of the entry without it takes the same call and leaves it).
extern "C" int wide_bvh_cast(const float* planar, const int* child,
                             const float* tris, const float* inst,
                             const float* o, const float* d,
                             const float* tmin, const float* tmax, int n,
                             int blas_root, int leaf_size, int n_tris,
                             int any_hit, int has_inst, float* t_out,
                             int* idx_out, int* survivors, int* counter,
                             long long* stats, void* stream,
                             uint8_t* valid_out) {
  if (n <= 0) return 0;
  const Args a{reinterpret_cast<const float4*>(planar),
               reinterpret_cast<const int4*>(child), tris,
               reinterpret_cast<const float4*>(inst), o, d, tmin, tmax, n,
               blas_root, leaf_size, n_tris, t_out, idx_out, survivors,
               counter, stats, valid_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    return has_inst ? cast_stats<true, true>(a, s)
                    : cast_stats<true, false>(a, s);
  return has_inst ? cast_stats<false, true>(a, s)
                  : cast_stats<false, false>(a, s);
}

// Warps of the walk's persistent grid (resident blocks per SM x SMs x
// WARPS) for one variant: the rows of its stats after row 0.
extern "C" int wide_bvh_walk_warps(int any_hit, int has_inst, int stats) {
  const int g =
      any_hit ? (has_inst ? grid_of<true, true>(stats)
                          : grid_of<true, false>(stats))
              : (has_inst ? grid_of<false, true>(stats)
                          : grid_of<false, false>(stats));
  return g * WARPS;
}

// Resident blocks per SM of the closest-hit instanced walk without
// counters (the launch's block size, no shared memory).
extern "C" int wide_bvh_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wide_walk_kernel<false, true, false>, WALK_BLOCK, 0);
  return blocks;
}
