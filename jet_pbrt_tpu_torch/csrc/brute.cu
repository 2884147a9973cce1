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
//   brute_hits_kernel<ANY>  one thread per ray. The kinds present are tested
//                           in _kind_hits order (triangles, spheres, rects,
//                           disks), each kind's shapes in index order,
//                           staged through shared memory in tiles of TILE
//                           shapes, so any shape count works. Closest mode
//                           keeps a running (t, index) per kind with a
//                           strict <, which is _closest_mn's rule: the
//                           lowest index among equal t, and index 0 with t =
//                           inf where nothing hits; it writes t, index and
//                           valid per kind ([K, N] each). Any-hit mode stops
//                           at the lane's first valid shape and writes one
//                           flag per lane; a block stops loading tiles once
//                           all its lanes are done.
//
// Bit for bit with the plain version: every float operation is the one a
// separate torch kernel rounds (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn, never contracted to an FMA), in the plain
// version's order (a*b + c*d + e*f is (ab + cd) + ef); `1.0 / det` is
// torch's reciprocal, a rounded division; the constants are the float32
// roundings of the Python doubles the plain version compares with;
// clamp_min passes NaN, as torch's does. Only the valid predicate and the t
// of valid pairs reach an output, so a failed test leaves the pair early,
// every comparison of the predicate kept as the plain version writes it
// (a NaN fails each). A lane with !(tmin < tmax), a dead lane (tmin = inf,
// tmax = -1) among them, can satisfy no t > tmin && t < tmax and tests
// nothing: index 0, t = inf, not valid. Where two valid pairs of a kind
// have t = +0 and -0 (only with tmin < 0) the plain version's amin may
// keep either zero; the main path's tmin is positive.
//
// Bound: on the Cornell box (32 triangles) a closest cast at 2^20 lanes
// reads 32 B and writes 9 B a lane (about 43 MB, 0.013 ms at 3.35 TB/s)
// and needs 53 float operations per (lane, triangle) pair (about 1.8
// GFLOP, 0.027 ms at 67 TFLOP/s): operations bind. Every lane of a warp
// reads the same shape from shared memory (a broadcast), and the shapes
// are read from device memory once per block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE 256
#define BLOCK 256

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
  float* t;                    // closest: [K,n]
  int32_t* index;              // closest: [K,n]
  uint8_t* valid;              // closest: [K,n]; any hit: [n]
};

namespace {

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
__device__ __forceinline__ F rcp(F a) { return {__fdiv_rn(1.0f, a.v)}; }
// torch.clamp_min: NaN passes through
__device__ __forceinline__ F cmin(F a, F lo) { return isnan(a.v) ? a : F{fmaxf(a.v, lo.v)}; }

struct F3 { F x, y, z; };

__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
// a.x * b.x + a.y * b.y + a.z * b.z as separate torch ops: (xx + yy) + zz
__device__ __forceinline__ F dot3(F3 a, F3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// The shapes of one kind: rows of W floats in SoA order in shared memory.
// Triangles: p0, e1 = p1 - p0, e2 = p2 - p0 (W 9). Spheres: center, r * r
// (W 4). Rects: the four corners, the normal (W 15). Disks: center, normal,
// r * r (W 7).
constexpr int W_MAX = 15;


enum Kind { TRI = 0, SPH = 1, RECT = 2, DISK = 3 };

// Row j of the tile that starts at shape `first` of `kind`, into s[f * TILE + j].
__device__ __forceinline__ void stage(const BruteArgs& a, int kind, int first, int j,
                                      float* s) {
  const int m = first + j;
  if (kind == TRI) {
    for (int c = 0; c < 3; ++c) {
      const float p0 = a.tri_p0[3 * m + c];
      s[c * TILE + j] = p0;
      s[(3 + c) * TILE + j] = __fsub_rn(a.tri_p1[3 * m + c], p0);
      s[(6 + c) * TILE + j] = __fsub_rn(a.tri_p2[3 * m + c], p0);
    }
  } else if (kind == SPH) {
    for (int c = 0; c < 3; ++c) s[c * TILE + j] = a.sph_c[3 * m + c];
    s[3 * TILE + j] = __fmul_rn(a.sph_r[m], a.sph_r[m]);
  } else if (kind == RECT) {
    for (int c = 0; c < 12; ++c) s[c * TILE + j] = a.rect_q[12 * m + c];
    for (int c = 0; c < 3; ++c) s[(12 + c) * TILE + j] = a.rect_n[3 * m + c];
  } else {
    for (int c = 0; c < 3; ++c) {
      s[c * TILE + j] = a.disk_c[3 * m + c];
      s[(3 + c) * TILE + j] = a.disk_n[3 * m + c];
    }
    s[6 * TILE + j] = __fmul_rn(a.disk_r[m], a.disk_r[m]);
  }
}

__device__ __forceinline__ F3 ld3s(const float* s, int f, int j) {
  return {{s[f * TILE + j]}, {s[(f + 1) * TILE + j]}, {s[(f + 2) * TILE + j]}};
}

struct Ray { F3 o, d; F tmin, tmax; };

__device__ __forceinline__ bool in_range(F t, const Ray& r) { return t > r.tmin && t < r.tmax; }

// Each test returns whether the pair is valid, with its t in `t`.

// intersect_triangles (Moller-Trumbore)
__device__ __forceinline__ bool tri_test(const Ray& r, const float* s, int j, F& t) {
  const F3 p0 = ld3s(s, 0, j), e1 = ld3s(s, 3, j), e2 = ld3s(s, 6, j);
  const F px = r.d.y * e2.z - r.d.z * e2.y;
  const F py = r.d.z * e2.x - r.d.x * e2.z;
  const F pz = r.d.x * e2.y - r.d.y * e2.x;
  const F det = (e1.x * px + e1.y * py) + e1.z * pz;
  if (!(fabs_(det) > K(1e-12))) return false;
  const F inv_det = rcp(det);
  const F3 tv = r.o - p0;
  const F u = ((tv.x * px + tv.y * py) + tv.z * pz) * inv_det;
  if (!(u >= K(0.0))) return false;
  const F qx = tv.y * e1.z - tv.z * e1.y;
  const F qy = tv.z * e1.x - tv.x * e1.z;
  const F qz = tv.x * e1.y - tv.y * e1.x;
  const F v = ((r.d.x * qx + r.d.y * qy) + r.d.z * qz) * inv_det;
  if (!(v >= K(0.0)) || !(u + v <= K(1.0))) return false;
  t = ((e2.x * qx + e2.y * qy) + e2.z * qz) * inv_det;
  return in_range(t, r);
}

// intersect_spheres
__device__ __forceinline__ bool sph_test(const Ray& r, const float* s, int j, F& t) {
  const F3 oc = ld3s(s, 0, j) - r.o;
  const F b = dot3(oc, r.d);
  const F det = (b * b - dot3(oc, oc)) + F{s[3 * TILE + j]};
  if (!(det >= K(0.0))) return false;
  const F sq = sqrt_(cmin(det, K(0.0)));
  const F t_near = b - sq;
  if (in_range(t_near, r)) {
    t = t_near;
    return true;
  }
  t = b + sq;
  return in_range(t, r);
}

// cross(u, v) . d as intersect_rects' cross_dot_d rounds it
__device__ __forceinline__ F cross_dot_d(F3 u, F3 v, F3 d) {
  return ((u.y * v.z - u.z * v.y) * d.x + (u.z * v.x - u.x * v.z) * d.y)
         + (u.x * v.y - u.y * v.x) * d.z;
}

// intersect_rects (the convex-quad sign test)
__device__ __forceinline__ bool rect_test(const Ray& r, const float* s, int j, F& t) {
  const F3 n = ld3s(s, 12, j);
  const F denom = dot3(n, r.d);
  if (!(fabs_(denom) > K(1e-12))) return false;  // t = inf: never < tmax
  const F3 qa = ld3s(s, 0, j) - r.o, qb = ld3s(s, 3, j) - r.o;
  const F3 qc = ld3s(s, 6, j) - r.o, qe = ld3s(s, 9, j) - r.o;
  const F v0 = cross_dot_d(qc, qb, r.d), v1 = cross_dot_d(qb, qa, r.d);
  const F v2 = cross_dot_d(qa, qe, r.d), v3 = cross_dot_d(qe, qc, r.d);
  const F z = K(0.0);
  const bool neg = v0 < z && v1 < z && v2 < z && v3 < z;
  const bool pos = v0 >= z && v1 >= z && v2 >= z && v3 >= z;
  if (!(neg || pos)) return false;
  t = dot3(n, qa) / denom;
  return in_range(t, r);
}

// intersect_disks
__device__ __forceinline__ bool disk_test(const Ray& r, const float* s, int j, F& t) {
  const F3 c = ld3s(s, 0, j), n = ld3s(s, 3, j);
  const F denom = dot3(n, r.d);
  if (!(fabs_(denom) > K(1e-9))) return false;
  t = dot3(n, c - r.o) / denom;
  if (!in_range(t, r)) return false;
  const F hx = (r.o.x + t * r.d.x) - c.x;
  const F hy = (r.o.y + t * r.d.y) - c.y;
  const F hz = (r.o.z + t * r.d.z) - c.z;
  return ((hx * hx + hy * hy) + hz * hz) <= F{s[6 * TILE + j]};
}

template <int KIND>
__device__ __forceinline__ bool test(const Ray& r, const float* s, int j, F& t) {
  if (KIND == TRI) return tri_test(r, s, j, t);
  if (KIND == SPH) return sph_test(r, s, j, t);
  if (KIND == RECT) return rect_test(r, s, j, t);
  return disk_test(r, s, j, t);
}

// The m shapes of one kind against the block's rays, TILE at a time.
// Closest mode writes the kind's row `slot` of the outputs; any-hit mode
// sets `done` at the lane's first valid shape. Every thread of the block
// calls it (the barriers), lanes past n and dead lanes included.
template <int KIND, bool ANY>
__device__ __forceinline__ void scan_kind(const BruteArgs& a, int m, int slot, int i,
                                          const Ray& r, bool live, bool& done,
                                          float* s) {
  F best = K(INFINITY);
  int best_j = 0;
  for (int first = 0; first < m; first += TILE) {
    if (ANY && __syncthreads_and(done)) break;
    __syncthreads();  // the last tile's readers are done with s
    const int cnt = min(TILE, m - first);
    for (int j = threadIdx.x; j < cnt; j += BLOCK) stage(a, KIND, first, j, s);
    __syncthreads();
    if (ANY ? done : !live) continue;
    for (int j = 0; j < cnt; ++j) {
      F t;
      if (test<KIND>(r, s, j, t)) {
        if (ANY) {
          done = true;
          break;
        }
        if (t < best) {
          best = t;
          best_j = first + j;
        }
      }
    }
  }
  if (!ANY && i < a.n) {
    const long long o = (long long)slot * a.n + i;
    a.t[o] = best.v;
    a.index[o] = best_j;
    a.valid[o] = isfinite(best.v);
  }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) brute_hits_kernel(const BruteArgs a) {
  __shared__ float s[W_MAX * TILE];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  Ray r;
  bool live = false;
  if (i < a.n) {
    r.tmin = F{a.tmin[i]};
    r.tmax = F{a.tmax[i]};
    live = r.tmin < r.tmax;
  }
  if (live) {
    r.o = {{a.o[3 * i]}, {a.o[3 * i + 1]}, {a.o[3 * i + 2]}};
    r.d = {{a.d[3 * i]}, {a.d[3 * i + 1]}, {a.d[3 * i + 2]}};
  }
  bool done = !live;  // any hit: this lane needs no more tests
  int slot = 0;       // closest: the kind's row in the outputs
  if (a.n_tri) scan_kind<TRI, ANY>(a, a.n_tri, slot++, i, r, live, done, s);
  if (a.n_sph) scan_kind<SPH, ANY>(a, a.n_sph, slot++, i, r, live, done, s);
  if (a.n_rect) scan_kind<RECT, ANY>(a, a.n_rect, slot++, i, r, live, done, s);
  if (a.n_disk) scan_kind<DISK, ANY>(a, a.n_disk, slot++, i, r, live, done, s);
  if (ANY && i < a.n) a.valid[i] = live && done;
}

}  // namespace

extern "C" {

int brute_args_size() { return (int)sizeof(BruteArgs); }

// One cast: closest (any_hit 0) or any hit (1) of a->n rays against every
// kind with a non-zero count, on `stream`; returns cudaGetLastError().
int brute_hits(const BruteArgs* a, int any_hit, cudaStream_t stream) {
  if (a->n > 0) {
    const int blocks = (a->n + BLOCK - 1) / BLOCK;
    if (any_hit) {
      brute_hits_kernel<true><<<blocks, BLOCK, 0, stream>>>(*a);
    } else {
      brute_hits_kernel<false><<<blocks, BLOCK, 0, stream>>>(*a);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
