// The casts' set-up and the closest hit's reconstruction as four CUDA
// kernels for sm_90a.
//
// Replaces the per-lane torch work around the casts of li_path (the
// counterparts of the elementwise and gather work that XLA fuses around the
// casts under jax.jit(wave), jet_pbrt_tpu/models/render.py:54; the
// reference has no Pallas kernel for it), as ops/rays.py's plain versions
// compute it op by op:
//
//   shadow_key_kernel<BOUNCE>  one thread per lane: occluded's segment
//       (delta, dist, d, tmin, tmax with the mask's dead interval), the
//       root-sphere test of ops/sort.py::bvh_needed against every row of
//       the root table, and the sort key of ops/sort.py::shadow_sort_key,
//       (morton | octant << 21 | !need << 24), 1 << 30 where dead
//       (scene/pack.py:416-430, ops/sort.py:44-91). BOUNCE = true is
//       ray_sort_key's layout for li_path's sort between bounces, (morton
//       << 3 | octant | !need << 25), 1 << 26 where inactive, on the rays
//       (o, d) with tmin = eps or inf and tmax = inf or -1
//       (models/integrators.py:147-161).
//   shadow_segments_kernel     output row j takes lane i = perm[j] (i = j
//       for an unsorted cast), recomputes its d, tmin and tmax with
//       shadow_key_kernel's arithmetic and writes o, d, tmin and tmax as
//       contiguous rows (scene/pack.py:416-424 and :432: the segment, then
//       four gathers). Per-lane arithmetic is the same before and after a
//       permutation, so this equals computing, then gathering, bit for bit.
//   occlusion_merge_kernel     the OR of a cast's flags, then out[perm[j]] =
//       occ[j] (scene/pack.py:437-441: the OR, then occ[argsort(perm)]). A
//       scatter through a permutation writes each lane once, so it equals
//       argsort-then-gather and saves a sort of the cast's keys.
//   hit_reconstruct_kernel     intersect's merge_hits over the kinds' [K,
//       N] t and index in _kind_hits order (strict <: an earlier kind keeps
//       a tie), t_safe, p = o + t_safe * d, and the winning kind's normal,
//       material, light and, with textures, uv, its rows found through
//       the int64 table of the kinds' tables (scene/pack.py:317-401: a
//       gather, normal and torch.where per kind), then the valid masks.
//
// Bound: bytes. Per lane at 2^20 lanes and 3.35 TB/s: the key reads 25 B
// and writes 4 (about 0.009 ms); the segments read 33 B (perm, both ends,
// the mask) and write 32 (about 0.020 ms); the merge reads one byte a flag
// and the perm and writes one (about 0.004 ms with two flags); the
// reconstruction reads o, d, each kind's t and index and its rows, and
// writes every field of Hit, about 110 B (about 0.034 ms). Each is one
// pass in which a thread owns a lane; there is no reuse to stage.
//
// Bit for bit with the plain version on the card: every float operation is
// the one a separate torch kernel rounds (__fmul_rn / __fadd_rn / __fsub_rn
// / __fdiv_rn / __fsqrt_rn through the F type, never contracted to an
// FMA), with torch's CUDA rules as csrc/shade.cu records them: a sum over a
// last dimension of 3 (dot) adds ((0 + p0) + p2) + (0 + p1), while
// bvh_needed writes (x + y) + z out and is copied as written;
// torch.linalg.cross rounds each component as fmaf(a1, b2, -(a2 * b1));
// `1.0 / x` is a reciprocal; a tensor divided by a Python number is a
// multiplication by the float32 reciprocal of that number, computed on the
// host (ATen's div_true_kernel_cuda); clamp and clamp_min pass NaN; a float
// to int32 cast is a truncating cvt (NaN gives 0, as torch's CUDA cast);
// atan2f and asinf are libdevice's, as torch calls them. Constants are the
// float32 roundings of the Python doubles (K()).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// hit_reconstruct's table (ops/rays.py::hit_table): an int64 row of
//   [2 * s, 2 * s + 1]        pointer and rows of shape table s, for s below
//                             N_SHAPE_TABLES (ops/rays.py HIT_TABLES)
//   TABLE_KINDS + k           the kind id of the slab's row k, k < n_kinds
//   TABLE_KINDS + n_kinds + FAMILY_W * f
//                             instanced family f: its triangles per
//                             instance, then pointer and rows of each of its
//                             N_FAMILY_TABLES tables (ops/rays.py
//                             FAMILY_TABLES)
// so that any number of kinds and families fits one launch.
enum {
  TRI_P0, TRI_P1, TRI_P2, TRI_N, TRI_UV, TRI_MAT, TRI_LIGHT,
  SPH_C, SPH_MAT, SPH_LIGHT,
  RECT_Q, RECT_N, RECT_MAT, RECT_LIGHT,
  DISK_C, DISK_N, DISK_R, DISK_MAT, DISK_LIGHT,
  N_SHAPE_TABLES
};
// per instanced family (ops/rays.py _FAMILY_TABLES)
enum {
  F_MAT, F_LIGHT, F_N, F_TRIS, F_UV, F_OFF, F_SCALE, N_FAMILY_TABLES
};
enum { TABLE_KINDS = 2 * N_SHAPE_TABLES, FAMILY_W = 1 + 2 * N_FAMILY_TABLES };
// scene/pack.py's kind ids
enum { KIND_TRI = 0, KIND_SPHERE = 1, KIND_RECT = 2, KIND_DISK = 3, KIND_INST = 4 };

// The kernels' arguments, by value (outside the unnamed namespace: the C
// entry points take them).
struct KeyArgs {
  int n;                  // lanes
  int n_roots;            // rows of roots
  const float* a;         // [n,3] p_from (shadow) or o (bounce)
  const float* b;         // [n,3] p_to (shadow) or d (bounce)
  const uint8_t* live;    // [n] mask (shadow; null: every lane) or active
  const float* ray_eps;   // []
  const float* center;    // [3] world_center
  const float* radius;    // [] world_radius
  const float* roots;     // [n_roots,4] center, radius
  int32_t* key;           // [n]
};

struct SegArgs {
  int n;
  const float* p_from;    // [n,3]
  const float* p_to;      // [n,3]
  const uint8_t* mask;    // [n] or null
  const int64_t* perm;    // [n] or null (unsorted)
  const float* ray_eps;   // []
  float* o;               // [n,3]
  float* d;               // [n,3]
  float* tmin;            // [n]
  float* tmax;            // [n]
};

struct MergeArgs {
  int n;
  int n_flags;
  const uint8_t* flags;   // [n_flags,n]
  const int64_t* perm;    // [n] or null
  uint8_t* out;           // [n]
};

struct HitArgs {
  int n;
  int n_kinds;
  int want_uv;
  const float* o;         // [n,3]
  const float* d;         // [n,3]
  const float* kt;        // [n_kinds,n] t, the kinds in _kind_hits order
  const int32_t* ki;      // [n_kinds,n] index
  const long long* table; // the kinds' ids and tables (see above)
  uint8_t* valid;         // [n]
  float* t;               // [n]
  float* pos;             // [n,3]
  float* nrm;             // [n,3]
  float* wo;              // [n,3]
  float* uv;              // [n,2]
  int32_t* mat_id;        // [n]
  int32_t* light_id;      // [n]
};

namespace {

constexpr int BLOCK = 256;
const double PI = 3.14159265358979323846;

// ---------------------------------------------------------------- floats

struct F { float v; };

#define K(x) (F{(float)(x)})

__device__ __forceinline__ F operator+(F a, F b) { return {__fadd_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator-(F a, F b) { return {__fsub_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator*(F a, F b) { return {__fmul_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator/(F a, F b) { return {__fdiv_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator-(F a) { return {-a.v}; }
__device__ __forceinline__ bool operator<(F a, F b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(F a, F b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(F a, F b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(F a, F b) { return a.v >= b.v; }

__device__ __forceinline__ F sqrt_(F a) { return {__fsqrt_rn(a.v)}; }
// torch.reciprocal and `1.0 / x` (reciprocal times 1)
__device__ __forceinline__ F rcp(F a) { return {__fdiv_rn(1.0f, a.v)}; }
// x / c for a Python number c: x * (1 / float(c)), the reciprocal rounded
// once (on the host in ATen)
__device__ __forceinline__ F div_const(F a, double c) { return a * rcp(K(c)); }
__device__ __forceinline__ F fma_(F a, F b, F c) { return {__fmaf_rn(a.v, b.v, c.v)}; }
// torch.clamp_min / torch.clamp: NaN passes through
__device__ __forceinline__ F cmin(F a, F lo) {
  return isnan(a.v) ? a : F{fmaxf(a.v, lo.v)};
}
__device__ __forceinline__ F clamp_(F a, F lo, F hi) {
  return isnan(a.v) ? a : F{fminf(fmaxf(a.v, lo.v), hi.v)};
}

struct F3 { F x, y, z; };

__device__ __forceinline__ F3 v3(F x, F y, F z) { return {x, y, z}; }
__device__ __forceinline__ F3 ld3(const float* p) { return {{p[0]}, {p[1]}, {p[2]}}; }
__device__ __forceinline__ void st3(float* p, F3 a) { p[0] = a.x.v; p[1] = a.y.v; p[2] = a.z.v; }
__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, F s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ F3 operator/(F3 a, F s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ F3 operator-(F3 a) { return {-a.x, -a.y, -a.z}; }

// torch.sum(a * b, -1) on the card: the products, then ((0 + p0) + p2) + (0 + p1)
__device__ __forceinline__ F dot(F3 a, F3 b) {
  F p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return ((K(0.0) + p0) + p2) + (K(0.0) + p1);
}
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {fma_(a.y, b.z, -(a.z * b.y)), fma_(a.z, b.x, -(a.x * b.z)),
          fma_(a.x, b.y, -(a.y * b.x))};
}
__device__ __forceinline__ F3 normalize(F3 a) {
  return a * rcp(cmin(sqrt_(dot(a, a)), K(1e-20)));
}

// ------------------------------------------------------------ the segment

struct Seg { F3 d; F tmin, tmax; };

// occluded's segment from p_from to p_to, the mask's dead interval where
// has_mask and !m (ops/rays.py::segment_plain)
__device__ __forceinline__ Seg segment(F3 from, F3 to, bool dead, F eps) {
  F3 delta = to - from;
  F dist = sqrt_(cmin(dot(delta, delta), K(1e-20)));
  Seg s;
  s.d = delta / dist;
  s.tmin = eps;
  s.tmax = dist - eps;
  if (dead) {
    s.tmin = K(INFINITY);
    s.tmax = K(-1.0);
  }
  return s;
}

// ------------------------------------------------------------ the sort key

__device__ __forceinline__ int part1by2(int x) {
  x &= 0x7F;
  x = (x | (x << 8)) & 0x0700F;
  x = (x | (x << 4)) & 0x430C3;
  x = (x | (x << 2)) & 0x49249;
  return x;
}

// _cells: clamp(((o - lo) * inv) * 128, 0, 127) cast to int32
__device__ __forceinline__ int cell(F o, F lo, F inv) {
  F x = clamp_((o - lo) * inv * K(128.0), K(0.0), K(127.0));
  return (int)x.v;
}

template <bool BOUNCE>
__global__ void __launch_bounds__(BLOCK) shadow_key_kernel(KeyArgs a) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  F eps = {*a.ray_eps};
  F3 o = ld3(a.a + 3 * (size_t)i);
  F3 d;
  F tmin, tmax;
  bool alive;
  if (BOUNCE) {
    d = ld3(a.b + 3 * (size_t)i);
    alive = a.live[i] != 0;
    tmin = alive ? eps : K(INFINITY);
    tmax = alive ? K(INFINITY) : K(-1.0);
  } else {
    Seg s = segment(o, ld3(a.b + 3 * (size_t)i),
                    a.live != nullptr && a.live[i] == 0, eps);
    d = s.d;
    tmin = s.tmin;
    tmax = s.tmax;
    alive = tmax > K(0.0);
  }
  // bvh_needed: (x + y) + z as ops/sort.py writes it
  bool need = false;
  for (int r = 0; r < a.n_roots; ++r) {
    const float* row = a.roots + 4 * r;
    F3 c = ld3(row);
    F rad = {row[3]};
    F3 oc = c - o;
    F tc = (oc.x * d.x + oc.y * d.y) + oc.z * d.z;
    F m2 = ((oc.x * oc.x + oc.y * oc.y) + oc.z * oc.z) - tc * tc;
    F rr = rad * rad * K(1.0001) + K(1e-5);
    need |= (m2 <= rr) & (tc + rad >= tmin) & (tc - rad <= tmax) & (tmax >= tmin);
  }
  F radius = {*a.radius};
  F inv = rcp(cmin(K(2.0) * radius, K(1e-12)));
  int code = part1by2(cell(o.x, F{a.center[0]} - radius, inv))
             | (part1by2(cell(o.y, F{a.center[1]} - radius, inv)) << 1)
             | (part1by2(cell(o.z, F{a.center[2]} - radius, inv)) << 2);
  int octant = (int)(d.x > K(0.0)) | ((int)(d.y > K(0.0)) << 1)
               | ((int)(d.z > K(0.0)) << 2);
  int key;
  if (BOUNCE) {
    key = (code << 3) | octant | (need ? 0 : 1 << 25);
    key = alive ? key : 1 << 26;
  } else {
    key = code | (octant << 21) | (need ? 0 : 1 << 24);
    key = alive ? key : 1 << 30;
  }
  a.key[i] = key;
}

// ------------------------------------------------------- the segments

__global__ void __launch_bounds__(BLOCK) shadow_segments_kernel(SegArgs a) {
  int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= a.n) return;
  long long i = a.perm ? a.perm[j] : j;
  F3 from, d;
  F tmin, tmax;
  if (i < 0 || i >= a.n) {
    // not a permutation of the lanes: the row traces nothing
    from = v3(K(NAN), K(NAN), K(NAN));
    d = from;
    tmin = K(INFINITY);
    tmax = K(-1.0);
  } else {
    from = ld3(a.p_from + 3 * i);
    Seg s = segment(from, ld3(a.p_to + 3 * i),
                    a.mask != nullptr && a.mask[i] == 0, F{*a.ray_eps});
    d = s.d;
    tmin = s.tmin;
    tmax = s.tmax;
  }
  st3(a.o + 3 * (size_t)j, from);
  st3(a.d + 3 * (size_t)j, d);
  a.tmin[j] = tmin.v;
  a.tmax[j] = tmax.v;
}

// ---------------------------------------------------------- the merge

__global__ void __launch_bounds__(BLOCK) occlusion_merge_kernel(MergeArgs a) {
  int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= a.n) return;
  uint8_t v = 0;
  for (int k = 0; k < a.n_flags; ++k) v |= a.flags[(size_t)k * a.n + j];
  long long i = a.perm ? a.perm[j] : j;
  if (i >= 0 && i < a.n) a.out[i] = v != 0;
}

// ----------------------------------------------------- the reconstruction

// _rows' clamp of an index into a table of `rows` rows
__device__ __forceinline__ long long clamp_row(long long i, long long rows) {
  return i < 0 ? 0 : (i > rows - 1 ? rows - 1 : i);
}

// row i (clamped) of the table whose pointer and rows stand at p[0], p[1]
template <typename T>
__device__ __forceinline__ const T* table_row(const long long* p, long long i, int w) {
  return (const T*)(uintptr_t)__ldg(p) + clamp_row(i, __ldg(p + 1)) * w;
}

template <typename T>
__device__ __forceinline__ const T* row_of(const HitArgs& a, int t, long long i, int w) {
  return table_row<T>(a.table + 2 * t, i, w);
}

// family f's table t
template <typename T>
__device__ __forceinline__ const T* frow_of(const HitArgs& a, int f, int t, long long i, int w) {
  return table_row<T>(a.table + TABLE_KINDS + a.n_kinds + (size_t)FAMILY_W * f + 1 + 2 * t,
                      i, w);
}

struct UV { F u, v; };

// pack.py::_bary_uv: the vertex uvs [3,2] at p by its barycentrics on the
// triangle (a, a + e1, a + e2)
__device__ __forceinline__ UV bary_uv(F3 a, F3 e1, F3 e2, F3 p, const float* uvs) {
  F3 v2 = p - a;
  F d00 = dot(e1, e1), d01 = dot(e1, e2), d11 = dot(e2, e2);
  F d20 = dot(v2, e1), d21 = dot(v2, e2);
  F denom = cmin(d00 * d11 - d01 * d01, K(1e-18));
  F wb = (d11 * d20 - d01 * d21) / denom;
  F wc = (d00 * d21 - d01 * d20) / denom;
  F wa = K(1.0) - wb - wc;
  UV r;
  r.u = F{uvs[0]} * wa + F{uvs[2]} * wb + F{uvs[4]} * wc;
  r.v = F{uvs[1]} * wa + F{uvs[3]} * wb + F{uvs[5]} * wc;
  return r;
}

// Python's floor division and modulo of an int64 index by n > 0
__device__ __forceinline__ long long floor_div(long long x, long long n) {
  long long q = x / n;
  return (x % n != 0 && x < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(BLOCK) hit_reconstruct_kernel(HitArgs a) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  // merge_hits: an earlier kind keeps a tie
  const long long* kinds = a.table + TABLE_KINDS;
  F t = {a.kt[i]};
  int kind = (int)__ldg(kinds);
  long long index = a.ki[i];
  for (int k = 1; k < a.n_kinds; ++k) {
    F tk = {a.kt[(size_t)k * a.n + i]};
    if (tk < t) {
      t = tk;
      kind = (int)__ldg(kinds + k);
      index = a.ki[(size_t)k * a.n + i];
    }
  }
  bool valid = isfinite(t.v);
  F t_safe = valid ? t : K(1.0);
  F3 o = ld3(a.o + 3 * (size_t)i), d = ld3(a.d + 3 * (size_t)i);
  F3 p = o + d * t_safe;
  F3 nk;
  int mk, lk;
  UV uv = {K(0.0), K(0.0)};
  if (kind == KIND_TRI) {
    nk = ld3(row_of<float>(a, TRI_N, index, 3));
    mk = *row_of<int32_t>(a, TRI_MAT, index, 1);
    lk = *row_of<int32_t>(a, TRI_LIGHT, index, 1);
    if (a.want_uv) {
      F3 p0 = ld3(row_of<float>(a, TRI_P0, index, 3));
      uv = bary_uv(p0, ld3(row_of<float>(a, TRI_P1, index, 3)) - p0,
                   ld3(row_of<float>(a, TRI_P2, index, 3)) - p0, p,
                   row_of<float>(a, TRI_UV, index, 6));
    }
  } else if (kind == KIND_SPHERE) {
    nk = normalize(p - ld3(row_of<float>(a, SPH_C, index, 3)));
    mk = *row_of<int32_t>(a, SPH_MAT, index, 1);
    lk = *row_of<int32_t>(a, SPH_LIGHT, index, 1);
    if (a.want_uv) {
      F phi = {atan2f(nk.z.v, nk.x.v)};
      F theta = {asinf(clamp_(nk.y, K(-1.0), K(1.0)).v)};
      uv.u = K(1.0) - div_const(phi + K(PI), 2.0 * PI);
      uv.v = div_const(theta + K(PI / 2.0), PI);
    }
  } else if (kind == KIND_RECT) {
    F3 n = ld3(row_of<float>(a, RECT_N, index, 3));
    nk = dot(n, d) <= K(0.0) ? n : -n;
    mk = *row_of<int32_t>(a, RECT_MAT, index, 1);
    lk = *row_of<int32_t>(a, RECT_LIGHT, index, 1);
    if (a.want_uv) {
      const float* q = row_of<float>(a, RECT_Q, index, 12);
      F3 q0 = ld3(q);
      F3 v01 = ld3(q + 3) - q0, v03 = ld3(q + 9) - q0, v0p = p - q0;
      uv.u = dot(v01, v0p) / cmin(dot(v01, v01), K(1e-12));
      uv.v = dot(v03, v0p) / cmin(dot(v03, v03), K(1e-12));
    }
  } else if (kind == KIND_DISK) {
    nk = ld3(row_of<float>(a, DISK_N, index, 3));
    mk = *row_of<int32_t>(a, DISK_MAT, index, 1);
    lk = *row_of<int32_t>(a, DISK_LIGHT, index, 1);
    if (a.want_uv) {
      F3 pc = p - ld3(row_of<float>(a, DISK_C, index, 3));
      // to_local(frame_from_z(nk), pc): its first two components
      F3 helper = fabsf(nk.x.v) > 0.99f ? v3(K(0.0), K(1.0), K(0.0))
                                         : v3(K(1.0), K(0.0), K(0.0));
      F3 ft = normalize(cross(nk, helper));
      F3 fs = normalize(cross(ft, nk));
      F phi = {atan2f(dot(pc, ft).v, dot(pc, fs).v)};
      phi = phi < K(0.0) ? phi + K(2.0 * PI) : phi;
      F r = sqrt_(cmin(dot(pc, pc), K(0.0)));
      uv.u = div_const(phi, 2.0 * PI);
      uv.v = r / cmin(F{*row_of<float>(a, DISK_R, index, 1)}, K(1e-12));
    }
  } else {
    int f = kind - KIND_INST;
    long long nb = __ldg(a.table + TABLE_KINDS + a.n_kinds + (size_t)FAMILY_W * f);
    long long inst = floor_div(index, nb);
    long long ti = index - inst * nb;
    mk = *frow_of<int32_t>(a, f, F_MAT, inst, 1);
    lk = *frow_of<int32_t>(a, f, F_LIGHT, inst, 1);
    nk = ld3(frow_of<float>(a, f, F_N, ti, 3));
    if (a.want_uv) {
      // barycentrics in instance space (a uniform scale and a shift)
      const float* rows = frow_of<float>(a, f, F_TRIS, ti, 9);
      F scale = cmin(F{*frow_of<float>(a, f, F_SCALE, inst, 1)}, K(1e-12));
      F3 p_l = (p - ld3(frow_of<float>(a, f, F_OFF, inst, 3))) / scale;
      uv = bary_uv(ld3(rows), ld3(rows + 3), ld3(rows + 6), p_l,
                   frow_of<float>(a, f, F_UV, ti, 6));
    }
  }
  a.valid[i] = valid;
  a.t[i] = t.v;
  st3(a.pos + 3 * (size_t)i, p);
  st3(a.nrm + 3 * (size_t)i, nk);
  st3(a.wo + 3 * (size_t)i, -d);
  a.uv[2 * (size_t)i] = uv.u.v;
  a.uv[2 * (size_t)i + 1] = uv.v.v;
  a.mat_id[i] = valid ? mk : 0;
  a.light_id[i] = valid ? lk : -1;
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" {

int rays_key_args_size() { return (int)sizeof(KeyArgs); }
int rays_segments_args_size() { return (int)sizeof(SegArgs); }
int rays_merge_args_size() { return (int)sizeof(MergeArgs); }
int rays_hit_args_size() { return (int)sizeof(HitArgs); }

// Each launches on `stream` and returns cudaGetLastError(); an empty batch
// launches nothing.
int shadow_key(const KeyArgs* a, int bounce, void* stream) {
  if (a->n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bounce)
    shadow_key_kernel<true><<<blocks(a->n), BLOCK, 0, s>>>(*a);
  else
    shadow_key_kernel<false><<<blocks(a->n), BLOCK, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

int shadow_segments(const SegArgs* a, void* stream) {
  if (a->n == 0) return 0;
  shadow_segments_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int occlusion_merge(const MergeArgs* a, void* stream) {
  if (a->n == 0) return 0;
  occlusion_merge_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int hit_reconstruct(const HitArgs* a, void* stream) {
  if (a->n == 0) return 0;
  hit_reconstruct_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
