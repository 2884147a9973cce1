// The wave's glue between the casts, the vertices and the sorts, as three
// CUDA kernels for sm_90a, and the backward of two of them.
//
// Replaces the per-lane torch work of models/render.py::wave_fn and
// models/integrators.py::li_path that is neither a cast, a vertex nor a
// sort (the counterparts of the elementwise and gather work that XLA fuses
// under jax.jit(wave), jet_pbrt_tpu/models/render.py:34-54 and
// models/integrators.py:251-292; the reference has no Pallas kernel for
// it), as ops/wave.py's plain versions compute it op by op:
//
//   camera_rays_kernel     one thread per lane: the film position of pixel
//       id p, (p % width + jitter x, p // width + jitter y), the camera ray
//       through it (models/camera.py::generate_rays: sx = 2 (x / w - 0.5),
//       sy = 2 (0.5 - y / h), d = normalize((front + right sx) + up sy),
//       o = position), and li_path's initial state: L = 0, beta = 1,
//       active, prev_specular and prev_pdf, the lane index and the first
//       cast's bounds (ray_eps, inf). Block 0 also zeroes the wave's four
//       int64 ray counters (primary, bounce, shadow, all), which
//       csrc/shade.cu's vertices add to.
//   permute_state_kernel   row j of every state row takes lane perm[j]: L,
//       beta, ray_o, ray_d, active, prev_specular, prev_pdf, the lane
//       index, the next cast's bounds, the stream keys (k0, k1, sample) or
//       the debug sampler's pregenerated uniforms (u_width floats a lane).
//       The reference's one gather of the state packed as [N, 19]
//       (jet_pbrt_tpu/models/integrators.py:259-285); the port's plain
//       version is eleven x[perm] gathers, and a gather copies bits.
//   unsort_guard_kernel    out[lane[i]] = isfinite(L[i]) ? L[i] : 0 per
//       channel (integrators.py:288-292: L[argsort(lane)], then the
//       invalid-sample guard). A permutation writes each row once, so the
//       scatter equals the inverse permutation's gather and needs no sort;
//       without a sort (lane null) it is the guard alone, in place.
//
// Two more are the backward of the permute and the un-sort, where the
// state's colours and throughputs carry a gradient (models/render.py::
// render_fn differentiated, diff/, the train step; ops/wave.py's Functions):
//
//   permute_state_backward_kernel   g_in[perm[j]] = g_out[j] for L and beta
//       (the transpose of the gather x[perm]); a permutation writes each
//       row once, so no atomics. A null g_out row is a zero gradient.
//   unsort_guard_backward_kernel    gL[i] = isfinite(L[i]) ? g[lane[i]] : 0
//       per channel (the transpose of the scatter and the guard; lane null:
//       the guard alone).
//
// Bound: bytes. Per lane at 2^20 lanes and 3.35 TB/s: the camera reads 16
// B (pixel id, jitter) and writes 70 (o, d, L, beta, the flags, pdf, lane,
// bounds), about 0.027 ms; the permute reads the perm and every state row
// once and writes each once, 2 x 86 + 8 B with the stream keys (about 0.056
// ms); the un-sort reads 20 B and writes 12 (about 0.010 ms). Each is one
// pass in which a thread owns a lane (the un-sort a source row); there is
// no reuse to stage. The permute's backward reads the perm and two [N, 3]
// gradients and writes two (56 B a lane, about 0.018 ms), the un-sort's
// reads L, lane and the gradient and writes one (44 B, about 0.014 ms).
//
// Bit for bit with the plain version on the card: every float operation is
// the one a separate torch kernel rounds (__fmul_rn / __fadd_rn / __fsub_rn
// / __fdiv_rn / __fsqrt_rn through the F type, never contracted to an
// FMA), with torch's CUDA rules as csrc/rays.cu records them: x / w divides
// by a 0-d tensor on the card, an IEEE division; subtracting or adding a
// Python number rounds once; normalize is a * reciprocal(clamp_min(sqrt(sum
// of squares), 1e-20)), the sum over 3 adding ((0 + p0) + p2) + (0 + p1);
// the int64 pixel id's % and // are Python's (floor) and its float32 cast
// rounds to nearest (cvt.rn.f32.s64). Constants are the float32 roundings
// of the Python doubles (K()).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The kernels' arguments, by value (outside the unnamed namespace: the C
// entry points take them).
struct CameraArgs {
  int n;                   // lanes
  long long width;         // film width in pixels
  const int64_t* pixel;    // [n] pixel ids
  const float* jitter;     // [n,2]
  const float* position;   // [3] the camera's rows (models/camera.py)
  const float* front;      // [3]
  const float* right;      // [3]
  const float* up;         // [3]
  const float* resolution; // [2] (width, height)
  const float* ray_eps;    // []
  float* o;                // [n,3]
  float* d;                // [n,3]
  float* L;                // [n,3]
  float* beta;             // [n,3]
  uint8_t* active;         // [n]
  uint8_t* spec;           // [n] prev_specular
  float* pdf;              // [n] prev_pdf
  int64_t* lane;           // [n]
  float* tmin;             // [n]
  float* tmax;             // [n]
  long long* counts;       // [4]
};

// A state's rows; a null pointer is a row the state lacks.
struct StateRows {
  float* L;                // [n,3]
  float* beta;             // [n,3]
  float* o;                // [n,3]
  float* d;                // [n,3]
  uint8_t* active;         // [n]
  uint8_t* spec;           // [n]
  float* pdf;              // [n]
  int64_t* lane;           // [n]
  float* tmin;             // [n]
  float* tmax;             // [n]
  int32_t* k0;             // [n] stream key words
  int32_t* k1;             // [n]
  int64_t* sample;         // [n] global sample index
  float* u;                // [n,u_width] pregenerated uniforms
};

struct PermuteArgs {
  int n;
  int u_width;             // floats a lane of u (0: no u)
  const int64_t* perm;     // [n]
  StateRows in;            // read only
  StateRows out;           // the rows `in` has
};

struct UnsortArgs {
  int n;
  const float* L;          // [n,3]
  const int64_t* lane;     // [n] or null (no sort)
  float* out;              // [n,3], L itself where lane is null
};

struct PermuteGradArgs {
  int n;
  const int64_t* perm;     // [n] a permutation of the lanes
  const float* gL;         // [n,3] d loss / d the permuted L, or null (0)
  const float* gbeta;      // [n,3] d loss / d the permuted beta, or null (0)
  float* gL_in;            // [n,3]
  float* gbeta_in;         // [n,3]
};

struct UnsortGradArgs {
  int n;
  const float* L;          // [n,3] the un-sort's input
  const int64_t* lane;     // [n] or null (no sort)
  const float* g;          // [n,3] d loss / d its output
  float* gL;               // [n,3]
};

namespace {

constexpr int BLOCK = 256;

struct F { float v; };

#define K(x) (F{(float)(x)})

__device__ __forceinline__ F operator+(F a, F b) { return {__fadd_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator-(F a, F b) { return {__fsub_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator*(F a, F b) { return {__fmul_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator/(F a, F b) { return {__fdiv_rn(a.v, b.v)}; }

__device__ __forceinline__ F sqrt_(F a) { return {__fsqrt_rn(a.v)}; }
// torch.reciprocal
__device__ __forceinline__ F rcp(F a) { return {__fdiv_rn(1.0f, a.v)}; }
// torch.clamp_min: NaN passes through
__device__ __forceinline__ F cmin(F a, F lo) {
  return isnan(a.v) ? a : F{fmaxf(a.v, lo.v)};
}

struct F3 { F x, y, z; };

__device__ __forceinline__ F3 ld3(const float* p) { return {{p[0]}, {p[1]}, {p[2]}}; }
__device__ __forceinline__ void st3(float* p, F3 a) { p[0] = a.x.v; p[1] = a.y.v; p[2] = a.z.v; }
__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, F s) { return {a.x * s, a.y * s, a.z * s}; }

// torch.sum(a * b, -1) on the card: the products, then ((0 + p0) + p2) + (0 + p1)
__device__ __forceinline__ F dot(F3 a, F3 b) {
  F p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return ((K(0.0) + p0) + p2) + (K(0.0) + p1);
}
// ops/linalg.py::normalize
__device__ __forceinline__ F3 normalize(F3 a) {
  return a * rcp(cmin(sqrt_(dot(a, a)), K(1e-20)));
}

// Python's floor division and remainder of int64s (torch's // and %)
__device__ __forceinline__ void floor_divmod(long long p, long long w, long long& q,
                                             long long& r) {
  q = p / w;
  r = p % w;
  if (r != 0 && ((r < 0) != (w < 0))) {
    q -= 1;
    r += w;
  }
}

__device__ __forceinline__ int lanes_index() { return blockIdx.x * BLOCK + threadIdx.x; }

// ------------------------------------------------------------ the camera

__global__ void __launch_bounds__(BLOCK) camera_rays_kernel(const __grid_constant__ CameraArgs a) {
  const int i = lanes_index();
  if (i < 4) a.counts[i] = 0;
  if (i >= a.n) return;
  long long q, r;
  floor_divmod(a.pixel[i], a.width, q, r);
  // pixel + in-pixel jitter (models/render.py::wave_fn)
  F x = F{__ll2float_rn(r)} + F{a.jitter[2 * (size_t)i]};
  F y = F{__ll2float_rn(q)} + F{a.jitter[2 * (size_t)i + 1]};
  // models/camera.py::generate_rays
  F w = {a.resolution[0]}, h = {a.resolution[1]};
  F sx = K(2.0) * (x / w - K(0.5));
  F sy = K(2.0) * (K(0.5) - y / h);
  F3 d = normalize((ld3(a.front) + ld3(a.right) * sx) + ld3(a.up) * sy);
  const size_t j = 3 * (size_t)i;
  st3(a.o + j, ld3(a.position));
  st3(a.d + j, d);
  // li_path's initial state
  const F3 zero = {K(0.0), K(0.0), K(0.0)}, one = {K(1.0), K(1.0), K(1.0)};
  st3(a.L + j, zero);
  st3(a.beta + j, one);
  a.active[i] = 1;
  a.spec[i] = 0;
  a.pdf[i] = 0.0f;
  a.lane[i] = i;
  a.tmin[i] = *a.ray_eps;
  a.tmax[i] = INFINITY;
}

// ----------------------------------------------------------- the permute

template <typename T>
__device__ __forceinline__ void gather_row(const T* in, T* out, long long i, int j, int w) {
  if (!in) return;
  for (int c = 0; c < w; ++c) out[(size_t)j * w + c] = in[i * w + c];
}

__global__ void __launch_bounds__(BLOCK) permute_state_kernel(const __grid_constant__ PermuteArgs a) {
  const int j = lanes_index();
  if (j >= a.n) return;
  const long long i = a.perm[j];
  const StateRows& s = a.in;
  const StateRows& t = a.out;
  if (i < 0 || i >= a.n) {
    // not a permutation of the lanes: the row is a dead lane of no pixel
    if (t.active) t.active[j] = 0;
    if (t.lane) t.lane[j] = -1;
    if (t.tmin) t.tmin[j] = INFINITY;
    if (t.tmax) t.tmax[j] = -1.0f;
    return;
  }
  gather_row(s.L, t.L, i, j, 3);
  gather_row(s.beta, t.beta, i, j, 3);
  gather_row(s.o, t.o, i, j, 3);
  gather_row(s.d, t.d, i, j, 3);
  gather_row(s.active, t.active, i, j, 1);
  gather_row(s.spec, t.spec, i, j, 1);
  gather_row(s.pdf, t.pdf, i, j, 1);
  gather_row(s.lane, t.lane, i, j, 1);
  gather_row(s.tmin, t.tmin, i, j, 1);
  gather_row(s.tmax, t.tmax, i, j, 1);
  gather_row(s.k0, t.k0, i, j, 1);
  gather_row(s.k1, t.k1, i, j, 1);
  gather_row(s.sample, t.sample, i, j, 1);
  gather_row(s.u, t.u, i, j, a.u_width);
}

// ------------------------------------------------------------ the un-sort

__global__ void __launch_bounds__(BLOCK) unsort_guard_kernel(const __grid_constant__ UnsortArgs a) {
  const int i = lanes_index();
  if (i >= a.n) return;
  const long long k = a.lane ? a.lane[i] : i;
  if (k < 0 || k >= a.n) return;
  float v[3];
  for (int c = 0; c < 3; ++c) {
    const float x = a.L[3 * (size_t)i + c];
    v[c] = isfinite(x) ? x : 0.0f;
  }
  for (int c = 0; c < 3; ++c) a.out[3 * k + c] = v[c];
}

// ------------------------------------------------- the backward passes

__device__ __forceinline__ void scatter_row(const float* g, float* out, long long k, int j) {
  for (int c = 0; c < 3; ++c) out[3 * k + c] = g ? g[3 * (size_t)j + c] : 0.0f;
}

__global__ void __launch_bounds__(BLOCK) permute_state_backward_kernel(
    const __grid_constant__ PermuteGradArgs a) {
  const int j = lanes_index();
  if (j >= a.n) return;
  const long long i = a.perm[j];
  if (i < 0 || i >= a.n) return;
  scatter_row(a.gL, a.gL_in, i, j);
  scatter_row(a.gbeta, a.gbeta_in, i, j);
}

__global__ void __launch_bounds__(BLOCK) unsort_guard_backward_kernel(
    const __grid_constant__ UnsortGradArgs a) {
  const int i = lanes_index();
  if (i >= a.n) return;
  const long long k = a.lane ? a.lane[i] : i;
  const bool in = k >= 0 && k < a.n;
  for (int c = 0; c < 3; ++c) {
    const float x = a.L[3 * (size_t)i + c];
    a.gL[3 * (size_t)i + c] = in && isfinite(x) ? a.g[3 * k + c] : 0.0f;
  }
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" {

int wave_camera_args_size() { return (int)sizeof(CameraArgs); }
int wave_permute_args_size() { return (int)sizeof(PermuteArgs); }
int wave_unsort_args_size() { return (int)sizeof(UnsortArgs); }
int wave_permute_grad_args_size() { return (int)sizeof(PermuteGradArgs); }
int wave_unsort_grad_args_size() { return (int)sizeof(UnsortGradArgs); }

// Each launches on `stream` and returns cudaGetLastError(). The camera
// launches for an empty batch too (it zeroes the counters).
int camera_rays(const CameraArgs* a, void* stream) {
  camera_rays_kernel<<<blocks(a->n > 4 ? a->n : 4), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int permute_state(const PermuteArgs* a, void* stream) {
  if (a->n == 0) return 0;
  permute_state_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int unsort_guard(const UnsortArgs* a, void* stream) {
  if (a->n == 0) return 0;
  unsort_guard_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int permute_state_backward(const PermuteGradArgs* a, void* stream) {
  if (a->n == 0) return 0;
  permute_state_backward_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int unsort_guard_backward(const UnsortGradArgs* a, void* stream) {
  if (a->n == 0) return 0;
  unsort_guard_backward_kernel<<<blocks(a->n), BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
