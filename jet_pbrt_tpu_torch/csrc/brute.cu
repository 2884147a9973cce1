// Brute-force ray / shape intersection of one cast as one CUDA kernel for
// sm_90a.
//
// Replaces the [M, N] shape-major broadcasts of
// jet_pbrt_tpu_torch/ops/intersect.py (intersect_triangles,
// intersect_spheres, intersect_rects, intersect_disks with _closest_mn, the
// counterparts of jet_pbrt_tpu/ops/intersect.py:72-215, which XLA fuses into
// one loop per kind under jax.jit(wave); the reference has no Pallas kernel
// for them), as ops/intersect.py::brute_hits_plain computes them for every
// brute-force kind of a scene in one call:
//
//   brute_hits_kernel<ANY, SPAN>  a block of BLOCK threads owns SPAN lanes
//       (256 or 1024, by the cast's size: see MIN_BLOCKS). It writes
//       its dead lanes' outputs at once and lists its live lanes in order
//       (a warp ballot per BLOCK lanes, a prefix over the ballots' counts
//       in warp 0). The threads then work through the list in rounds of
//       BLOCK rays, one a thread, so every warp that tests holds live
//       rays, and only a block's last round can hold fewer. Each round
//       tests the kinds present in _kind_hits order (triangles, spheres,
//       rects, disks), each kind's shapes in index order, staged through
//       shared memory in tiles of TILE shapes as rows of float4. Closest
//       mode keeps a running (t, index) per ray and kind with a strict <,
//       which is _closest_mn's rule: the lowest index among equal t, and
//       index 0 with t = inf where nothing hits; it writes t, index and
//       valid per kind ([K, N] each) at each lane's own index. Any-hit
//       mode stops a ray at its first valid shape and writes one flag per
//       lane; in its last round a block stops once all its rays are done.
//
// What binds it, and what the design does (measured in turns with the
// one-thread-per-ray kernel before it, sweep_ab.py --lib brute):
//   - Dead lanes took warp slots: a shadow cast has about 44% of them,
//     scattered, so nearly every warp ran every test. The list packs the
//     live rays; a larger span packs a sparse cast into fewer rounds, a
//     smaller one keeps a small cast on every SM.
//   - Scalar shared-memory reads: a shape's row is 1 to 5 LDS.128
//     broadcasts (triangle: p0, e1, e2; sphere: center and r * r; rect:
//     four corners and n; disk: center and r * r, n), not 4 to 15 LDS.32.
//   - Dependent chains: the shape loop is unrolled by 4, so a thread holds
//     four shapes' det -> 1 / det -> u -> v -> t chains against its ray.
//     Two to four rays a thread cost registers and blocks and were slower
//     on every cast measured, so a thread holds one.
//   - Divergent exits: the triangle test computes its whole chain and
//     combines its comparisons without a branch (its lanes leave at
//     different places, and the branches were slower); the sphere test
//     rejects before its square root (det < 0: most pairs of a scene of
//     small spheres, where the branch is uniform), the rect and disk
//     tests before their division.
//   - Staging: the tiles of all kinds form one stream. While a tile is
//     tested, each staging thread's cp.async copies bring its shape of the
//     next tile into its own slot of `raw`; after the tests the thread
//     waits for its own copies and builds the shape's float4 row in the
//     other row buffer (e1 = p1 - p0, e2 = p2 - p0 and r * r pinned as the
//     plain version rounds them), and one barrier per tile publishes it.
//     A one-tile stream (the Cornell box's 32 triangles) is staged once per
//     block and kept for every round.
//
// Bit for bit with the plain version: every float operation is the one a
// separate torch kernel rounds (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn, never contracted to an FMA), in the plain
// version's order (a*b + c*d + e*f is (ab + cd) + ef); `1.0 / det` is
// torch's reciprocal, a correctly rounded 1 / x (__frcp_rn, the same bits
// as __fdiv_rn(1, x) on every input); the constants are the float32
// roundings of the Python doubles the plain version compares with;
// clamp_min passes NaN, as torch's does. Every comparison of the valid
// predicate is kept as the plain version writes it (a NaN fails each); a
// test that rejects early does so only on a comparison of that predicate.
// A lane with !(tmin < tmax), a dead lane (tmin = inf, tmax = -1) among
// them, can satisfy no t > tmin && t < tmax and tests nothing: index 0,
// t = inf, not valid. Where two valid pairs of a kind have t = +0 and -0
// (only with tmin < 0) the plain version's amin may keep either zero; the
// main path's tmin is positive.
//
// Bound: on the Cornell box (32 triangles) a closest cast at 2^20 lanes
// reads 32 B and writes 9 B a lane (about 43 MB, 0.013 ms at 3.35 TB/s)
// and needs 53 float operations per (lane, triangle) pair. None of them can
// be contracted into an FMA, so each is at least one issued instruction,
// and an SM issues 128 a clock: about 1.8 G instructions, 0.053 ms on 132
// SMs at 1,980 MHz. Operations bind. The compiled test issues about 75
// instructions a pair (the 53, the correctly rounded reciprocal's range
// check and Newton step, the comparisons and the running minimum).
// Tensor cores do not apply: each test is a chain of separately rounded
// float32 operations that must match the plain version bit for bit, and a
// wgmma or mma.sync product rounds its sums differently and reads TF32 or
// narrower inputs, so neither det nor t could match.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The kernel's arguments, by value (outside the unnamed namespace: the C
// entry point takes them).
struct BruteArgs {
  int n;                       // rays
  int n_tri, n_sph, n_rect, n_disk;  // shapes per kind, 0 where absent
  const float* o;              // [n,3]
  const float* d;              // [n,3]
  const float* tmin;           // [n]
  const float* tmax;           // [n]
  const float* tri_p0;         // [T,3]
  const float* tri_p1;
  const float* tri_p2;
  const float* sph_c;          // [S,3]
  const float* sph_r;          // [S]
  const float* rect_q;         // [R,4,3]
  const float* rect_n;         // [R,3]
  const float* disk_c;         // [D,3]
  const float* disk_n;         // [D,3]
  const float* disk_r;         // [D]
  float* t;                    // closest: [*,n]
  int32_t* index;              // closest: [*,n]
  uint8_t* valid;              // closest: [*,n]; any hit: [n]
  int row[4];                  // closest: the output row of the k-th kind
                               // present (the caller's slab order)
};

namespace {

constexpr int BLOCK = 256;       // threads a block, rays a round
constexpr int WARPS = BLOCK / 32;
constexpr int TILE = 128;        // shapes a staged tile
static_assert(BLOCK % 32 == 0, "whole warps");
static_assert(TILE <= BLOCK, "a thread stages at most one shape a tile");
// A block's span of lanes, by the cast's size: SPAN_LARGE where that
// still gives MIN_BLOCKS blocks (about two waves of four resident blocks
// on each of an H100's 132 SMs), else BLOCK. The larger span packs a
// sparse cast's live lanes into fewer rounds; the smaller one keeps a
// small cast on every SM.
constexpr int SPAN_LARGE = 1024;
constexpr int MIN_BLOCKS = 1024;

struct F { float v; };

#define K(x) (F{(float)(x)})

__device__ __forceinline__ F operator+(F a, F b) { return {__fadd_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator-(F a, F b) { return {__fsub_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator*(F a, F b) { return {__fmul_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator/(F a, F b) { return {__fdiv_rn(a.v, b.v)}; }
__device__ __forceinline__ bool operator<(F a, F b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(F a, F b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(F a, F b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(F a, F b) { return a.v >= b.v; }
__device__ __forceinline__ F fabs_(F a) { return {fabsf(a.v)}; }
__device__ __forceinline__ F sqrt_(F a) { return {__fsqrt_rn(a.v)}; }
// torch.reciprocal, which `1.0 / x` calls
__device__ __forceinline__ F rcp(F a) { return {__frcp_rn(a.v)}; }
// torch.clamp_min: NaN passes through
__device__ __forceinline__ F cmin(F a, F lo) { return isnan(a.v) ? a : F{fmaxf(a.v, lo.v)}; }

struct F3 { F x, y, z; };

__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
// a.x * b.x + a.y * b.y + a.z * b.z as separate torch ops: (xx + yy) + zz
__device__ __forceinline__ F dot3(F3 a, F3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ F3 xyz(float4 q) { return {{q.x}, {q.y}, {q.z}}; }

enum Kind { TRI = 0, SPH = 1, RECT = 2, DISK = 3 };

// A shape's row: row4(kind) float4s in shared memory. Triangles: p0, e1 =
// p1 - p0, e2 = p2 - p0 (3). Spheres: center and r * r (1). Rects: the
// four corners, the normal (5). Disks: center and r * r, normal (2). A
// shape's raw inputs, as `raw` holds them before its row is built: 9, 4, 15
// and 7 floats.
__host__ __device__ constexpr int row4(int kind) {
  return kind == TRI ? 3 : kind == SPH ? 1 : kind == RECT ? 5 : 2;
}
constexpr int ROW4_MAX = 5;
constexpr int RAW_MAX = 15;

struct Ray { F3 o, d; F tmin, tmax; };

__device__ __forceinline__ bool in_range(F t, const Ray& r) { return t > r.tmin && t < r.tmax; }

// Each test returns whether the pair is valid, with its t in `t` (read only
// where valid).

// intersect_triangles (Moller-Trumbore), the whole chain, no branch
__device__ __forceinline__ bool tri_test(const Ray& r, const float4* s, F& t) {
  const F3 p0 = xyz(s[0]), e1 = xyz(s[1]), e2 = xyz(s[2]);
  const F px = r.d.y * e2.z - r.d.z * e2.y;
  const F py = r.d.z * e2.x - r.d.x * e2.z;
  const F pz = r.d.x * e2.y - r.d.y * e2.x;
  const F det = (e1.x * px + e1.y * py) + e1.z * pz;
  const F inv_det = rcp(det);
  const F3 tv = r.o - p0;
  const F u = ((tv.x * px + tv.y * py) + tv.z * pz) * inv_det;
  const F qx = tv.y * e1.z - tv.z * e1.y;
  const F qy = tv.z * e1.x - tv.x * e1.z;
  const F qz = tv.x * e1.y - tv.y * e1.x;
  const F v = ((r.d.x * qx + r.d.y * qy) + r.d.z * qz) * inv_det;
  t = ((e2.x * qx + e2.y * qy) + e2.z * qz) * inv_det;
  return (fabs_(det) > K(1e-12)) & (u >= K(0.0)) & (v >= K(0.0)) & (u + v <= K(1.0))
         & (t > r.tmin) & (t < r.tmax);
}

// intersect_spheres; the square root only where det >= 0
__device__ __forceinline__ bool sph_test(const Ray& r, const float4* s, F& t) {
  const F3 oc = xyz(s[0]) - r.o;
  const F b = dot3(oc, r.d);
  const F det = (b * b - dot3(oc, oc)) + F{s[0].w};
  if (!(det >= K(0.0))) return false;
  const F sq = sqrt_(cmin(det, K(0.0)));
  const F t_near = b - sq, t_far = b + sq;
  const bool in_near = (t_near > r.tmin) & (t_near < r.tmax);
  t = in_near ? t_near : t_far;
  return in_near | ((t_far > r.tmin) & (t_far < r.tmax));
}

// cross(u, v) . d as intersect_rects' cross_dot_d rounds it
__device__ __forceinline__ F cross_dot_d(F3 u, F3 v, F3 d) {
  return ((u.y * v.z - u.z * v.y) * d.x + (u.z * v.x - u.x * v.z) * d.y)
         + (u.x * v.y - u.y * v.x) * d.z;
}

// intersect_rects (the convex-quad sign test); the division only where the
// quad test and |denom| pass (else t = inf, never < tmax)
__device__ __forceinline__ bool rect_test(const Ray& r, const float4* s, F& t) {
  const F3 n = xyz(s[4]);
  const F denom = dot3(n, r.d);
  const F3 qa = xyz(s[0]) - r.o, qb = xyz(s[1]) - r.o;
  const F3 qc = xyz(s[2]) - r.o, qe = xyz(s[3]) - r.o;
  const F v0 = cross_dot_d(qc, qb, r.d), v1 = cross_dot_d(qb, qa, r.d);
  const F v2 = cross_dot_d(qa, qe, r.d), v3 = cross_dot_d(qe, qc, r.d);
  const F z = K(0.0);
  const bool neg = (v0 < z) & (v1 < z) & (v2 < z) & (v3 < z);
  const bool pos = (v0 >= z) & (v1 >= z) & (v2 >= z) & (v3 >= z);
  if (!((fabs_(denom) > K(1e-12)) & (neg | pos))) return false;
  t = dot3(n, qa) / denom;
  return in_range(t, r);
}

// intersect_disks; the division only where |denom| passes
__device__ __forceinline__ bool disk_test(const Ray& r, const float4* s, F& t) {
  const F3 c = xyz(s[0]), n = xyz(s[1]);
  const F denom = dot3(n, r.d);
  if (!(fabs_(denom) > K(1e-9))) return false;
  t = dot3(n, c - r.o) / denom;
  const F hx = (r.o.x + t * r.d.x) - c.x;
  const F hy = (r.o.y + t * r.d.y) - c.y;
  const F hz = (r.o.z + t * r.d.z) - c.z;
  return in_range(t, r) & (((hx * hx + hy * hy) + hz * hz) <= F{s[0].w});
}

template <int KIND>
__device__ __forceinline__ bool test(const Ray& r, const float4* s, F& t) {
  if (KIND == TRI) return tri_test(r, s, t);
  if (KIND == SPH) return sph_test(r, s, t);
  if (KIND == RECT) return rect_test(r, s, t);
  return disk_test(r, s, t);
}

// cp.async of one float into shared memory, and the wait for all of this
// thread's copies (sm_80 and later)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shape `m` of `kind` into this thread's slot of raw, by cp.async.
__device__ __forceinline__ void fetch(const BruteArgs& a, int kind, int m, float* raw) {
  const float* src[5];
  int len[5], k = 0;
  if (kind == TRI) {
    src[0] = a.tri_p0 + 3 * m, src[1] = a.tri_p1 + 3 * m, src[2] = a.tri_p2 + 3 * m;
    len[0] = len[1] = len[2] = 3, k = 3;
  } else if (kind == SPH) {
    src[0] = a.sph_c + 3 * m, src[1] = a.sph_r + m, len[0] = 3, len[1] = 1, k = 2;
  } else if (kind == RECT) {
    src[0] = a.rect_q + 12 * m, src[1] = a.rect_n + 3 * m, len[0] = 12, len[1] = 3, k = 2;
  } else {
    src[0] = a.disk_c + 3 * m, src[1] = a.disk_n + 3 * m, src[2] = a.disk_r + m;
    len[0] = len[1] = 3, len[2] = 1, k = 3;
  }
  int f = 0;
  for (int p = 0; p < k; ++p)
    for (int c = 0; c < len[p]; ++c) copy_async(raw + f++, src[p] + c);
}

// The output row of the k-th kind present, by selects (no dynamic index
// into the kernel's parameters, which would copy them to local memory).
__device__ __forceinline__ int out_row(const BruteArgs& a, int k) {
  return k == 0 ? a.row[0] : k == 1 ? a.row[1] : k == 2 ? a.row[2] : a.row[3];
}

// The float4 row of a shape from its raw floats (this thread's own copies).
__device__ __forceinline__ void build(int kind, const float* x, float4* row) {
  if (kind == TRI) {
    row[0] = make_float4(x[0], x[1], x[2], 0.0f);
    row[1] = make_float4(__fsub_rn(x[3], x[0]), __fsub_rn(x[4], x[1]), __fsub_rn(x[5], x[2]), 0.0f);
    row[2] = make_float4(__fsub_rn(x[6], x[0]), __fsub_rn(x[7], x[1]), __fsub_rn(x[8], x[2]), 0.0f);
  } else if (kind == SPH) {
    row[0] = make_float4(x[0], x[1], x[2], __fmul_rn(x[3], x[3]));
  } else if (kind == RECT) {
    for (int c = 0; c < 5; ++c) row[c] = make_float4(x[3 * c], x[3 * c + 1], x[3 * c + 2], 0.0f);
  } else {
    row[0] = make_float4(x[0], x[1], x[2], __fmul_rn(x[6], x[6]));
    row[1] = make_float4(x[3], x[4], x[5], 0.0f);
  }
}

// The tile stream: tiles of TILE shapes, the kinds present in order.
struct Tile { int kind, first; };

__device__ __forceinline__ Tile first_tile(const int (&m)[4]) {
  Tile t{0, 0};
  while (t.kind < 4 && m[t.kind] == 0) ++t.kind;
  return t;
}

// The tile after t; the first tile again after the last one (the next
// round's).
__device__ __forceinline__ Tile next_tile(const int (&m)[4], Tile t) {
  t.first += TILE;
  if (t.first >= m[t.kind]) {
    t.first = 0;
    do ++t.kind; while (t.kind < 4 && m[t.kind] == 0);
  }
  return t.kind < 4 ? t : first_tile(m);
}

// Tile t's shape for staging thread j (j < TILE), copied into raw.
__device__ __forceinline__ void fetch_tile(const BruteArgs& a, const int (&m)[4], Tile t,
                                           float* raw) {
  const int j = threadIdx.x;
  if (j < TILE && t.first + j < m[t.kind]) fetch(a, t.kind, t.first + j, raw + j * RAW_MAX);
}

// Tile t's rows from this thread's raw copies, into rows.
__device__ __forceinline__ void build_tile(const int (&m)[4], Tile t, const float* raw,
                                           float4* rows) {
  const int j = threadIdx.x;
  wait_copies();
  if (j < TILE && t.first + j < m[t.kind])
    build(t.kind, raw + j * RAW_MAX, rows + j * row4(t.kind));
}

// The cnt shapes of one tile of KIND against this thread's ray.
template <int KIND, bool ANY>
__device__ __forceinline__ void test_tile(const float4* rows, int first, int cnt, const Ray& r,
                                          F& best, int& best_j, bool& done) {
#pragma unroll 4
  for (int j = 0; j < cnt; ++j) {
    constexpr int W = row4(KIND);
    float4 s[W];
#pragma unroll
    for (int c = 0; c < W; ++c) s[c] = rows[j * W + c];
    F t;
    const bool v = test<KIND>(r, s, t);
    if (ANY && v) {
      done = true;
      break;
    }
    if (!ANY && v && t < best) {
      best = t;
      best_j = first + j;
    }
  }
}

template <bool ANY, int SPAN>
__global__ void __launch_bounds__(BLOCK) brute_hits_kernel(const BruteArgs a) {
  constexpr int PER = SPAN / BLOCK;              // lanes a thread lists
  constexpr int COUNTS = PER * WARPS;            // ballots a block
  constexpr int PER_LANE = (COUNTS + 31) / 32;   // of them a lane of warp 0
  static_assert(SPAN % BLOCK == 0, "whole rows of lanes");
  __shared__ float4 rows[2][TILE * ROW4_MAX];
  __shared__ float raw[TILE * RAW_MAX];
  __shared__ int list[SPAN];
  __shared__ int offs[COUNTS];
  __shared__ int live_n;
  const int m[4] = {a.n_tri, a.n_sph, a.n_rect, a.n_disk};
  const int kinds = (m[0] > 0) + (m[1] > 0) + (m[2] > 0) + (m[3] > 0);
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const long long base = (long long)blockIdx.x * SPAN;

  // The span's lanes: dead ones written now, live ones listed in order.
  unsigned ballot[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const long long i = base + q * BLOCK + tid;
    bool live = false;
    if (i < a.n) {
      live = kinds > 0 && a.tmin[i] < a.tmax[i];
      if (!live && ANY) a.valid[i] = 0;
      if (!live && !ANY)
        for (int k = 0; k < kinds; ++k) {
          const long long o = (long long)out_row(a, k) * a.n + i;
          a.t[o] = INFINITY;
          a.index[o] = 0;
          a.valid[o] = 0;
        }
    }
    ballot[q] = __ballot_sync(0xffffffffu, live);
    if (lid == 0) offs[q * WARPS + warp] = __popc(ballot[q]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the (q, warp) counts, and the total
    int c[PER_LANE], sum = 0;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int k = lid * PER_LANE + e;
      c[e] = k < COUNTS ? offs[k] : 0;
      sum += c[e];
    }
    int s = sum;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, k);
      if (lid >= k) s += y;
    }
    int run = s - sum;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int k = lid * PER_LANE + e;
      if (k < COUNTS) offs[k] = run;
      run += c[e];
    }
    if (lid == 31) live_n = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if ((ballot[q] >> lid) & 1u)
      list[offs[q * WARPS + warp] + __popc(ballot[q] & ((1u << lid) - 1u))] =
          (int)(base + q * BLOCK + tid);
  const int live = live_n;
  if (live == 0) return;  // the whole block: no barrier follows

  // The live rays in rounds of BLOCK, thread k taking the round's list
  // entry k; each round runs through the tile stream. The stream's first
  // tile is staged now and the next one's copies are issued; a one-tile
  // stream stays in rows[0] for every round.
  int tiles = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) tiles += (m[k] + TILE - 1) / TILE;
  const int rounds = (live + BLOCK - 1) / BLOCK;
  const int steps = rounds * tiles;
  Tile cur = first_tile(m);
  fetch_tile(a, m, cur, raw);
  build_tile(m, cur, raw, rows[0]);
  Tile nxt = next_tile(m, cur);
  if (steps > 1 && tiles > 1) fetch_tile(a, m, nxt, raw);
  __syncthreads();
  int p = 0;
  for (int round = 0; round < rounds; ++round) {
    const int s = round * BLOCK + tid;
    const bool busy = s < live;  // else this thread has no ray this round
    const int lane = busy ? list[s] : 0;
    Ray r;
    if (busy) {
      r.o = {{a.o[3 * lane]}, {a.o[3 * lane + 1]}, {a.o[3 * lane + 2]}};
      r.d = {{a.d[3 * lane]}, {a.d[3 * lane + 1]}, {a.d[3 * lane + 2]}};
      r.tmin = F{a.tmin[lane]};
      r.tmax = F{a.tmax[lane]};
    }
    bool done = !busy;  // any hit: this ray needs no more tests
    F best = K(INFINITY);
    int best_j = 0;
    int slot = 0;  // closest: the kind's place among those present
    for (int t = 0; t < tiles; ++t) {
      if (!done) {
        const int cnt = min(TILE, m[cur.kind] - cur.first);
        const float4* tile = rows[p];
        if (cur.kind == TRI) test_tile<TRI, ANY>(tile, cur.first, cnt, r, best, best_j, done);
        else if (cur.kind == SPH) test_tile<SPH, ANY>(tile, cur.first, cnt, r, best, best_j, done);
        else if (cur.kind == RECT) test_tile<RECT, ANY>(tile, cur.first, cnt, r, best, best_j, done);
        else test_tile<DISK, ANY>(tile, cur.first, cnt, r, best, best_j, done);
      }
      if (!ANY && (t == tiles - 1 || nxt.kind != cur.kind)) {  // the kind's outputs
        if (busy) {
          const long long o = (long long)out_row(a, slot) * a.n + lane;
          a.t[o] = best.v;
          a.index[o] = best_j;
          a.valid[o] = isfinite(best.v);
        }
        best = K(INFINITY);
        best_j = 0;
        ++slot;
      }
      const int step = round * tiles + t;
      if (tiles == 1 || step + 1 == steps) continue;
      build_tile(m, nxt, raw, rows[p ^ 1]);
      p ^= 1;
      cur = nxt;
      nxt = next_tile(m, cur);
      if (step + 2 < steps) fetch_tile(a, m, nxt, raw);
      // any hit, last round: the block stops once all its rays are done
      if (ANY && round == rounds - 1 ? __syncthreads_and(done) : (__syncthreads(), false)) break;
    }
    if (ANY && busy) a.valid[lane] = done;
  }
  wait_copies();
}

}  // namespace

extern "C" {

int brute_args_size() { return (int)sizeof(BruteArgs); }

// One cast: closest (any_hit 0) or any hit (1) of a->n rays against every
// kind with a non-zero count, on `stream`; returns cudaGetLastError().
int brute_hits(const BruteArgs* a, int any_hit, cudaStream_t stream) {
  if (a->n > 0) {
    const long long n = a->n;
    const int span = n >= (long long)SPAN_LARGE * MIN_BLOCKS ? SPAN_LARGE : BLOCK;
    const int blocks = (int)((n + span - 1) / span);
    if (span == SPAN_LARGE) {
      if (any_hit) brute_hits_kernel<true, SPAN_LARGE><<<blocks, BLOCK, 0, stream>>>(*a);
      else brute_hits_kernel<false, SPAN_LARGE><<<blocks, BLOCK, 0, stream>>>(*a);
    } else {
      if (any_hit) brute_hits_kernel<true, BLOCK><<<blocks, BLOCK, 0, stream>>>(*a);
      else brute_hits_kernel<false, BLOCK><<<blocks, BLOCK, 0, stream>>>(*a);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
