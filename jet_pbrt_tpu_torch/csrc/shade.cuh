// The path vertex's shading math, shared by csrc/shade.cu (the forward
// kernels) and csrc/shade_grad.cu (the backward): the pinned float type F,
// vectors, sampling warps, Fresnel terms, microfacet distributions, lobes,
// lights, textures and the kernels' argument struct.
//
// Every function a material parameter reaches (the lobe, its f, pdf and
// sample, the Fresnel and microfacet terms they call) is a template over
// its scalar type T. The forward instantiates it with F, whose every
// operation rounds as torch's eager op does (see csrc/shade.cu's note); the
// backward instantiates it once more with D<N>, F's value and N forward-mode
// tangents over the parameters of the lane's own material row (of c0 rgb,
// c1 rgb, s0, s1) that its kind's tangent set carries. A
// D's value is computed by the same F operation as the forward's, so the
// backward's branch decisions and values equal the forward's bit for bit;
// its tangents follow the derivative rules of torch's autograd at the
// edges (clamp passes the gradient where the input is inside its range,
// equality included; |x| has slope 0 at 0; where and a selected branch
// pass it to the selected side alone), and a tangent that is exactly 0
// stays 0 through every operation, as a parameter a quantity does not
// depend on is absent from torch's tape. The light sample and the texture
// tap carry no tangent: the radiance enters the estimate linearly and the
// tap's texels by its weights, which csrc/shade_grad.cu applies itself.
// The lobe's evaluation and sampling are inlined: called with a lobe by
// reference, an outlined D<8> instance put the lobe on the stack (an 800 B
// frame in csrc/shade_grad.cu's kernels).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TABLE_W 32
#define STATIC_W 5
#define EM_W 12

namespace {

// ---------------------------------------------------------------- floats

struct F { float v; };

#define K(x) (F{(float)(x)})

// Built with -DSHADE_COUNT_OPS (a measurement variant), every float
// operation below adds to its thread's count in g_ops: an add, multiply,
// divide, square root, clamp or libdevice call one, an FMA two.
#ifdef SHADE_COUNT_OPS
__device__ unsigned long long* g_ops;
#define OPS(k) (g_ops[blockIdx.x * blockDim.x + threadIdx.x] += (k))
#else
#define OPS(k) ((void)0)
#endif

__device__ __forceinline__ F operator+(F a, F b) { OPS(1); return {__fadd_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator-(F a, F b) { OPS(1); return {__fsub_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator*(F a, F b) { OPS(1); return {__fmul_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator/(F a, F b) { OPS(1); return {__fdiv_rn(a.v, b.v)}; }
__device__ __forceinline__ F operator-(F a) { return {-a.v}; }
__device__ __forceinline__ bool operator<(F a, F b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(F a, F b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(F a, F b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(F a, F b) { return a.v >= b.v; }
__device__ __forceinline__ bool operator==(F a, F b) { return a.v == b.v; }
__device__ __forceinline__ bool operator!=(F a, F b) { return a.v != b.v; }

__device__ __forceinline__ F sel(bool c, F a, F b) { return c ? a : b; }
__device__ __forceinline__ F fabs_(F a) { return {fabsf(a.v)}; }
__device__ __forceinline__ F sqrt_(F a) { OPS(1); return {__fsqrt_rn(a.v)}; }
// torch.reciprocal and `1.0 / x` (reciprocal times 1)
__device__ __forceinline__ F rcp(F a) { OPS(1); return {__fdiv_rn(1.0f, a.v)}; }
__device__ __forceinline__ F sin_(F a) { OPS(1); return {sinf(a.v)}; }
__device__ __forceinline__ F cos_(F a) { OPS(1); return {cosf(a.v)}; }
__device__ __forceinline__ F exp_(F a) { OPS(1); return {expf(a.v)}; }
__device__ __forceinline__ F log_(F a) { OPS(1); return {logf(a.v)}; }
__device__ __forceinline__ F log1p_(F a) { OPS(1); return {log1pf(a.v)}; }
__device__ __forceinline__ F erf_(F a) { OPS(1); return {erff(a.v)}; }
__device__ __forceinline__ F erfinv_(F a) { OPS(1); return {erfinvf(a.v)}; }
__device__ __forceinline__ F acos_(F a) { OPS(1); return {acosf(a.v)}; }
__device__ __forceinline__ F pow_(F a, F b) { OPS(1); return {powf(a.v, b.v)}; }
__device__ __forceinline__ F fma_(F a, F b, F c) { OPS(2); return {__fmaf_rn(a.v, b.v, c.v)}; }
__device__ __forceinline__ bool isfinite_(F a) { return isfinite(a.v); }
// torch.clamp_min / torch.clamp: NaN passes through
__device__ __forceinline__ F cmin(F a, F lo) {
  OPS(1);
  return isnan(a.v) ? a : F{fmaxf(a.v, lo.v)};
}
__device__ __forceinline__ F clamp_(F a, F lo, F hi) {
  OPS(1);
  return isnan(a.v) ? a : F{fminf(fmaxf(a.v, lo.v), hi.v)};
}
// safe_sqrt: sqrt(x) where x > 0, else 0
__device__ __forceinline__ F ssqrt(F x) { return x > K(0.0) ? sqrt_(x) : K(0.0); }

const double PI = 3.14159265358979323846;

// ------------------------------------------------------------ dual numbers

// D<N>: a value rounded as F rounds it and N tangents (d value / d each of
// the lane material parameters the backward carries for the lane's kind:
// csrc/shade_grad.cu's tangent sets). The tangents' own arithmetic is plain
// float: the backward's gradients are held to a tolerance, its values and
// branches to the forward's bits. Each tangent's arithmetic reads only its
// own tangents and the values, so a tangent's result does not depend on
// how many others are carried. The binary operations are friends found by
// argument-dependent lookup, so an F operand converts to D<N> as it did
// when N was fixed.

// t * s, 0 where the tangent t is 0 (a parameter the operand does not
// depend on contributes nothing, even through an infinite slope)
__device__ __forceinline__ float tm(float t, float s) { return t == 0.0f ? 0.0f : t * s; }

template <int N> struct D {
  float v;
  float d[N];
  __device__ __forceinline__ D() {}
  __device__ __forceinline__ D(F a) : v(a.v) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = 0.0f;
  }

  friend __device__ __forceinline__ D operator+(D a, D b) {
    D r;
    r.v = __fadd_rn(a.v, b.v);
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
    return r;
  }
  friend __device__ __forceinline__ D operator-(D a, D b) {
    D r;
    r.v = __fsub_rn(a.v, b.v);
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
    return r;
  }
  friend __device__ __forceinline__ D operator*(D a, D b) {
    D r;
    r.v = __fmul_rn(a.v, b.v);
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = tm(a.d[k], b.v) + tm(b.d[k], a.v);
    return r;
  }
  friend __device__ __forceinline__ D operator/(D a, D b) {
    D r;
    r.v = __fdiv_rn(a.v, b.v);
    const float inv = 1.0f / b.v, q = r.v / b.v;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = tm(a.d[k], inv) - tm(b.d[k], q);
    return r;
  }
  friend __device__ __forceinline__ bool operator<(D a, D b) { return a.v < b.v; }
  friend __device__ __forceinline__ bool operator>(D a, D b) { return a.v > b.v; }
  friend __device__ __forceinline__ bool operator<=(D a, D b) { return a.v <= b.v; }
  friend __device__ __forceinline__ bool operator>=(D a, D b) { return a.v >= b.v; }
  friend __device__ __forceinline__ bool operator==(D a, D b) { return a.v == b.v; }
  friend __device__ __forceinline__ bool operator!=(D a, D b) { return a.v != b.v; }
  friend __device__ __forceinline__ D sel(bool c, D a, D b) { return c ? a : b; }
  // torch.pow's backward: the base's slope b a^(b-1), 0 where b is 0; the
  // exponent's a^b log(a), 0 where a is 0 and b >= 0
  friend __device__ __forceinline__ D pow_(D a, D b) {
    D r;
    r.v = powf(a.v, b.v);
    const float sa = b.v == 0.0f ? 0.0f : b.v * powf(a.v, b.v - 1.0f);
    const float sb = (a.v == 0.0f && b.v >= 0.0f) ? 0.0f : r.v * logf(a.v);
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = tm(a.d[k], sa) + tm(b.d[k], sb);
    return r;
  }
  friend __device__ __forceinline__ D fma_(D a, D b, D c) {
    D r;
    r.v = __fmaf_rn(a.v, b.v, c.v);
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = tm(a.d[k], b.v) + tm(b.d[k], a.v) + c.d[k];
    return r;
  }
  // torch.clamp_min: the input's tangent where it is >= lo (NaN: lo's)
  friend __device__ __forceinline__ D cmin(D a, D lo) {
    if (isnan(a.v)) return take(a.v, lo);
    return a.v >= lo.v ? a : lo;
  }
  friend __device__ __forceinline__ D clamp_(D a, D lo, D hi) {
    if (isnan(a.v)) return take(a.v, lo);
    if (a.v < lo.v) return lo;
    if (a.v > hi.v) return hi;
    return a;
  }
  // a value that takes the tangents of `from`
  static __device__ __forceinline__ D take(float v, const D& from) {
    D r = from;
    r.v = v;
    return r;
  }
};

// a value with every tangent scaled by its slope
template <int N> __device__ __forceinline__ D<N> chain(float v, const D<N>& a, float slope) {
  D<N> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = tm(a.d[k], slope);
  return r;
}

template <int N> __device__ __forceinline__ D<N> operator-(D<N> a) {
  a.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) a.d[k] = -a.d[k];
  return a;
}
// torch.abs: slope sign(x), 0 at 0
template <int N> __device__ __forceinline__ D<N> fabs_(D<N> a) {
  return chain(fabsf(a.v), a, a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f));
}
template <int N> __device__ __forceinline__ D<N> sqrt_(D<N> a) {
  const float r = __fsqrt_rn(a.v);
  return chain(r, a, 0.5f / r);
}
template <int N> __device__ __forceinline__ D<N> rcp(D<N> a) {
  const float r = __fdiv_rn(1.0f, a.v);
  return chain(r, a, -(r * r));
}
template <int N> __device__ __forceinline__ D<N> sin_(D<N> a) { return chain(sinf(a.v), a, cosf(a.v)); }
template <int N> __device__ __forceinline__ D<N> cos_(D<N> a) { return chain(cosf(a.v), a, -sinf(a.v)); }
template <int N> __device__ __forceinline__ D<N> exp_(D<N> a) {
  const float r = expf(a.v);
  return chain(r, a, r);
}
template <int N> __device__ __forceinline__ D<N> log_(D<N> a) { return chain(logf(a.v), a, 1.0f / a.v); }
template <int N> __device__ __forceinline__ D<N> log1p_(D<N> a) {
  return chain(log1pf(a.v), a, 1.0f / (1.0f + a.v));
}
template <int N> __device__ __forceinline__ D<N> erf_(D<N> a) {
  return chain(erff(a.v), a, 1.12837916709551257f * expf(-a.v * a.v));
}
template <int N> __device__ __forceinline__ D<N> erfinv_(D<N> a) {
  const float r = erfinvf(a.v);
  return chain(r, a, 0.886226925452758014f * expf(r * r));
}
template <int N> __device__ __forceinline__ D<N> acos_(D<N> a) {
  return chain(acosf(a.v), a, -rsqrtf(1.0f - a.v * a.v));
}
template <int N> __device__ __forceinline__ bool isfinite_(D<N> a) { return isfinite(a.v); }
template <int N> __device__ __forceinline__ D<N> ssqrt(D<N> x) {
  return x > K(0.0) ? sqrt_(x) : D<N>(K(0.0));
}

// ---------------------------------------------------------------- vectors

template <class T> struct V3 { T x, y, z; };
using F3 = V3<F>;
template <class T> struct Id { using type = T; };

__device__ __forceinline__ F3 v3(F x, F y, F z) { return {x, y, z}; }
__device__ __forceinline__ F3 ld3(const float* p) { return {{p[0]}, {p[1]}, {p[2]}}; }
__device__ __forceinline__ void st3(float* p, F3 a) { p[0] = a.x.v; p[1] = a.y.v; p[2] = a.z.v; }
template <class T> __device__ __forceinline__ V3<T> up3(F3 a) { return {T(a.x), T(a.y), T(a.z)}; }
template <int N> __device__ __forceinline__ F3 value3(const V3<D<N>>& a) { return {{a.x.v}, {a.y.v}, {a.z.v}}; }
__device__ __forceinline__ F3 value3(const F3& a) { return a; }
template <class T> __device__ __forceinline__ V3<T> operator+(V3<T> a, V3<T> b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
template <class T> __device__ __forceinline__ V3<T> operator-(V3<T> a, V3<T> b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
template <class T> __device__ __forceinline__ V3<T> operator*(V3<T> a, V3<T> b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
template <class T> __device__ __forceinline__ V3<T> operator/(V3<T> a, V3<T> b) { return {a.x / b.x, a.y / b.y, a.z / b.z}; }
template <class T> __device__ __forceinline__ V3<T> operator*(V3<T> a, typename Id<T>::type s) { return {a.x * s, a.y * s, a.z * s}; }
template <class T> __device__ __forceinline__ V3<T> operator/(V3<T> a, typename Id<T>::type s) { return {a.x / s, a.y / s, a.z / s}; }
template <class T> __device__ __forceinline__ V3<T> operator-(V3<T> a) { return {-a.x, -a.y, -a.z}; }
template <class T> __device__ __forceinline__ V3<T> zero3() { return {T(K(0.0)), T(K(0.0)), T(K(0.0))}; }
__device__ __forceinline__ F3 zero3() { return {K(0.0), K(0.0), K(0.0)}; }

// torch.sum(a * b, -1) on the card: the products, then ((0 + p0) + p2) + (0 + p1)
template <class T> __device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  T p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return ((T(K(0.0)) + p0) + p2) + (T(K(0.0)) + p1);
}
template <class T> __device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {fma_(a.y, b.z, -(a.z * b.y)), fma_(a.z, b.x, -(a.x * b.z)),
          fma_(a.x, b.y, -(a.y * b.x))};
}
template <class T> __device__ __forceinline__ T length(V3<T> a) { return sqrt_(dot(a, a)); }
template <class T> __device__ __forceinline__ V3<T> normalize(V3<T> a) {
  return a * rcp(cmin(length(a), T(K(1e-20))));
}
// torch.amax(c, -1) on the card
__device__ __forceinline__ F max_component(F3 c) {
  auto mx = [](F a, F b) { return (isnan(a.v) || a.v > b.v) ? a : b; };
  return mx(mx(c.x, c.z), c.y);
}
template <class T> __device__ __forceinline__ bool is_black(V3<T> c) {
  return c.x == K(0.0) && c.y == K(0.0) && c.z == K(0.0);
}
template <class T> __device__ __forceinline__ T luminance(V3<T> c) {
  return (K(0.212671) * c.x + K(0.715160) * c.y) + K(0.072169) * c.z;
}
template <class T> __device__ __forceinline__ V3<T> flip_z(V3<T> v) { return {-v.x, -v.y, v.z}; }
template <class T> __device__ __forceinline__ V3<T> negate_z(V3<T> v) { return {v.x, v.y, -v.z}; }

template <class T> struct FrameT { V3<T> s, t, n; };
using Frame = FrameT<F>;

template <class T> __device__ __forceinline__ FrameT<T> frame_from_z(V3<T> n) {
  V3<T> helper = fabs_(n.x) > K(0.99) ? V3<T>{K(0.0), K(1.0), K(0.0)}
                                      : V3<T>{K(1.0), K(0.0), K(0.0)};
  V3<T> t = normalize(cross(n, helper));
  V3<T> s = normalize(cross(t, n));
  return {s, t, n};
}
template <class T> __device__ __forceinline__ V3<T> to_local(const FrameT<T>& f, V3<T> v) {
  return {dot(v, f.s), dot(v, f.t), dot(v, f.n)};
}
template <class T> __device__ __forceinline__ V3<T> to_world(const FrameT<T>& f, V3<T> v) {
  return (f.s * v.x + f.t * v.y) + f.n * v.z;
}

// refract(wi, n, eta) -> (wt, ok)
template <class T> __device__ __forceinline__ V3<T> refract(V3<T> wi, V3<T> n, T eta, bool* ok) {
  T cos_i = dot(n, wi);
  T sin2_i = cmin(K(1.0) - cos_i * cos_i, K(0.0));
  T sin2_t = eta * eta * sin2_i;
  *ok = sin2_t < K(1.0);
  T cos_t = ssqrt(K(1.0) - sin2_t);
  return (-wi) * eta + n * (eta * cos_i - cos_t);
}

// ---------------------------------------------------------------- sampling

__device__ __forceinline__ void concentric_disk(F u0, F u1, F* px, F* py) {
  F ox = K(2.0) * u0 - K(1.0);
  F oy = K(2.0) * u1 - K(1.0);
  bool degenerate = ox == K(0.0) && oy == K(0.0);
  bool use_x = fabs_(ox) > fabs_(oy);
  F r = sel(use_x, ox, oy);
  F theta = use_x ? K(PI / 4.0) * (oy / sel(ox == K(0.0), K(1.0), ox))
                  : K(PI / 2.0) - K(PI / 4.0) * (ox / sel(oy == K(0.0), K(1.0), oy));
  *px = degenerate ? K(0.0) : r * cos_(theta);
  *py = degenerate ? K(0.0) : r * sin_(theta);
}

// ---------------------------------------------------------------- fresnel

template <class T> __device__ T fresnel_dielectric(T cos_theta_i, T eta_i, T eta_t) {
  T ci = clamp_(cos_theta_i, K(-1.0), K(1.0));
  bool entering = ci > K(0.0);
  T e_i = sel(entering, eta_i, eta_t);
  T e_t = sel(entering, eta_t, eta_i);
  ci = fabs_(ci);
  T sin_t = e_i / e_t * ssqrt(K(1.0) - ci * ci);
  bool tir = sin_t >= K(1.0);
  T ct = ssqrt(K(1.0) - sin_t * sin_t);
  T r_parl = (e_t * ci - e_i * ct) / cmin(e_t * ci + e_i * ct, K(1e-20));
  T r_perp = (e_i * ci - e_t * ct) / cmin(e_i * ci + e_t * ct, K(1e-20));
  T f = K(0.5) * (r_parl * r_parl + r_perp * r_perp);
  return tir ? T(K(1.0)) : f;
}

// eta_i = 1: `eta_t / 1.0` and `k / 1.0` are exact
template <class T> __device__ T fresnel_conductor_1(T cos_theta_i, T eta, T etak) {
  T c = clamp_(fabs_(cos_theta_i), K(0.0), K(1.0));
  T c2 = c * c;
  T s2 = K(1.0) - c2;
  T eta2 = eta * eta;
  T etak2 = etak * etak;
  T t0 = eta2 - etak2 - s2;
  T a2b2 = sqrt_(cmin(t0 * t0 + K(4.0) * eta2 * etak2, K(0.0)));
  T t1 = a2b2 + c2;
  T a = sqrt_(cmin(K(0.5) * (a2b2 + t0), K(0.0)));
  T t2 = K(2.0) * a * c;
  T rs = (t1 - t2) / cmin(t1 + t2, K(1e-20));
  T t3 = c2 * a2b2 + s2 * s2;
  T t4 = t2 * s2;
  T rp = rs * (t3 - t4) / cmin(t3 + t4, K(1e-20));
  return K(0.5) * (rp + rs);
}

// ---------------------------------------------------------------- microfacet

enum { GGX = 0, BECKMANN = 1 };

template <class T> struct Trig { T cos2, sin2, cphi, sphi; };

template <class T> __device__ __forceinline__ Trig<T> trig(V3<T> w) {
  T cos2 = clamp_(w.z * w.z, K(0.0), K(1.0));
  T sin2 = K(1.0) - cos2;
  T sin_theta = sqrt_(sin2);
  T safe_sin = cmin(sin_theta, K(1e-12));
  bool big = sin_theta > K(1e-12);
  T cphi = big ? w.x / safe_sin : T(K(1.0));
  T sphi = big ? w.y / safe_sin : T(K(0.0));
  return {cos2, sin2, clamp_(cphi, K(-1.0), K(1.0)), clamp_(sphi, K(-1.0), K(1.0))};
}

template <class T> __device__ T d_ggx(V3<T> wh, T ax, T ay) {
  Trig<T> g = trig(wh);
  T tan2 = g.sin2 / cmin(g.cos2, K(1e-12));
  T e = (g.cphi * g.cphi / cmin(ax * ax, K(1e-12))
         + g.sphi * g.sphi / cmin(ay * ay, K(1e-12))) * tan2;
  T c2 = cmin(g.cos2, K(1e-12));
  T ope = K(1.0) + e;
  T d = rcp(K(PI) * ax * ay * (c2 * c2) * (ope * ope));
  return g.cos2 > K(0.0) ? d : T(K(0.0));
}

template <class T> __device__ T lambda_ggx(V3<T> w, T ax, T ay) {
  Trig<T> g = trig(w);
  T abs_tan = sqrt_(g.sin2 / cmin(g.cos2, K(1e-12)));
  T alpha = sqrt_(g.cphi * g.cphi * (ax * ax) + g.sphi * g.sphi * (ay * ay));
  T at = alpha * abs_tan;
  T lam = K(0.5) * (sqrt_(K(1.0) + at * at) + K(-1.0));
  return g.cos2 > K(1e-12) ? lam : T(K(0.0));
}

template <class T> __device__ T d_beckmann(V3<T> wh, T ax, T ay) {
  Trig<T> g = trig(wh);
  T tan2 = g.sin2 / cmin(g.cos2, K(1e-12));
  T c2 = cmin(g.cos2, K(1e-12));
  T d = exp_(-tan2 * (g.cphi * g.cphi / cmin(ax * ax, K(1e-12))
                      + g.sphi * g.sphi / cmin(ay * ay, K(1e-12))))
        / (K(PI) * ax * ay * (c2 * c2));
  return g.cos2 > K(0.0) ? d : T(K(0.0));
}

template <class T> __device__ T lambda_beckmann(V3<T> w, T ax, T ay) {
  Trig<T> g = trig(w);
  T abs_tan = sqrt_(g.sin2 / cmin(g.cos2, K(1e-12)));
  T alpha = sqrt_(g.cphi * g.cphi * (ax * ax) + g.sphi * g.sphi * (ay * ay));
  T a = rcp(cmin(alpha * abs_tan, K(1e-12)));
  T lam = (K(1.0) - K(1.259) * a + K(0.396) * a * a) / (K(3.535) * a + K(2.181) * a * a);
  return (a >= K(1.6) || g.cos2 <= K(1e-12)) ? T(K(0.0)) : lam;
}

// mf_mode: 0 select by the lane's kind (GGX, else Beckmann), 1 GGX alone,
// 2 Beckmann alone (the scene's present_mf_kinds)
__device__ __forceinline__ bool use_ggx(int mode, int kind) {
  return mode == 1 || (mode == 0 && kind == GGX);
}
template <class T> __device__ T mf_d(int mode, int kind, V3<T> wh, T ax, T ay) {
  return use_ggx(mode, kind) ? d_ggx(wh, ax, ay) : d_beckmann(wh, ax, ay);
}
template <class T> __device__ T mf_lam(int mode, int kind, V3<T> w, T ax, T ay) {
  return use_ggx(mode, kind) ? lambda_ggx(w, ax, ay) : lambda_beckmann(w, ax, ay);
}
template <class T> __device__ T mf_g1(int mode, int kind, V3<T> w, T ax, T ay) {
  return rcp(mf_lam(mode, kind, w, ax, ay) + K(1.0));
}
template <class T> __device__ T mf_g(int mode, int kind, V3<T> wo, V3<T> wi, T ax, T ay) {
  return rcp(mf_lam(mode, kind, wo, ax, ay) + K(1.0) + mf_lam(mode, kind, wi, ax, ay));
}
template <class T> __device__ __forceinline__ T pdf_wh(int mode, int kind, V3<T> wo, V3<T> wh, T ax, T ay) {
  return mf_d(mode, kind, wh, ax, ay) * mf_g1(mode, kind, wo, ax, ay)
         * fabs_(dot(wo, wh)) / cmin(fabs_(wo.z), K(1e-12));
}

template <class T> __device__ V3<T> sample_ggx_vndf(V3<T> wo_up, T ax, T ay, F u0, F u1) {
  V3<T> vh = normalize(V3<T>{ax * wo_up.x, ay * wo_up.y, wo_up.z});
  T lensq = vh.x * vh.x + vh.y * vh.y;
  T inv = rcp(sqrt_(cmin(lensq, K(1e-20))));
  V3<T> t1 = lensq > K(1e-20) ? V3<T>{-vh.y * inv, vh.x * inv, K(0.0)}
                              : V3<T>{K(1.0), K(0.0), K(0.0)};
  V3<T> t2 = cross(vh, t1);
  F r = sqrt_(u0);
  F phi = K(2.0 * PI) * u1;
  F p1 = r * cos_(phi);
  T p2 = r * sin_(phi);
  T s = K(0.5) * (vh.z + K(1.0));
  p2 = (K(1.0) - s) * ssqrt(K(1.0) - p1 * p1) + s * p2;
  T pz = ssqrt(K(1.0) - p1 * p1 - p2 * p2);
  V3<T> nh = (t1 * p1 + t2 * p2) + vh * pz;
  return normalize(V3<T>{ax * nh.x, ay * nh.y, cmin(nh.z, K(1e-6))});
}

template <class T> __device__ void beckmann_slope_sample(T cos_theta, F u1, F u2, T* sx, T* sy) {
  u1 = clamp_(u1, K(1e-6), K(1.0 - 1e-6));
  u2 = clamp_(u2, K(1e-6), K(1.0 - 1e-6));
  F r_ni = sqrt_(-log1p_(-u1));
  bool ni = cos_theta > K(0.9999);
  if (ni) {
    *sx = r_ni * cos_(K(2.0 * PI) * u2);
    *sy = r_ni * sin_(K(2.0 * PI) * u2);
    return;
  }
  T cos_safe = clamp_(cos_theta, K(-0.9999), K(0.9999));
  T sin_t = sqrt_(cmin(K(1.0) - cos_safe * cos_safe, K(0.0)));
  T tan_t = sin_t / cos_safe;
  T cot_t = rcp(tan_t);
  T a = K(-1.0);
  T c = erf_(cot_t);
  T theta = acos_(cos_safe);
  T fit = K(1.0) + theta * (theta * (K(0.4265) - K(0.0594) * theta) + K(-0.876));
  T b = c - (K(1.0) + c) * pow_(T(K(1.0) - u1), fit);
  // 1 / sqrt(PI) rounded in float32 (a 0-d tensor in the plain version)
  F sqrt_pi_inv = rcp(sqrt_(K(PI)));
  T norm = rcp(K(1.0) + c + sqrt_pi_inv * tan_t * exp_(-cot_t * cot_t));
  for (int i = 0; i < 10; ++i) {
    b = (b >= a && b <= c) ? b : K(0.5) * (a + c);
    T inv_erf = erfinv_(clamp_(b, K(-1.0 + 1e-7), K(1.0 - 1e-7)));
    T value = norm * (K(1.0) + b + sqrt_pi_inv * tan_t * exp_(-inv_erf * inv_erf)) - u1;
    T deriv = norm * (K(1.0) - inv_erf * tan_t);
    bool pos = value > K(0.0);
    c = pos ? b : c;
    a = pos ? a : b;
    T step = value / (fabs_(deriv) > K(1e-12) ? deriv : T(K(1.0)));
    b = b - (fabs_(value) < K(1e-6) ? T(K(0.0)) : step);
  }
  b = clamp_(b, K(-1.0 + 1e-7), K(1.0 - 1e-7));
  *sx = erfinv_(b);
  *sy = erfinv_(K(2.0) * u2 - K(1.0));
}

template <class T> __device__ V3<T> sample_beckmann_vndf(V3<T> wo_up, T ax, T ay, F u0, F u1) {
  V3<T> w_s = normalize(V3<T>{ax * wo_up.x, ay * wo_up.y, wo_up.z});
  Trig<T> g = trig(w_s);
  T sx, sy;
  beckmann_slope_sample(w_s.z, u0, u1, &sx, &sy);
  T rx = g.cphi * sx - g.sphi * sy;
  T ry = g.sphi * sx + g.cphi * sy;
  return normalize(V3<T>{-ax * rx, -ay * ry, K(1.0)});
}

template <class T> __device__ __forceinline__ V3<T> sample_wh(int mode, int kind, V3<T> wo, T ax, T ay, F u0, F u1) {
  bool flip = wo.z < K(0.0);
  V3<T> wo_up = flip ? -wo : wo;
  V3<T> wh = use_ggx(mode, kind) ? sample_ggx_vndf(wo_up, ax, ay, u0, u1)
                                 : sample_beckmann_vndf(wo_up, ax, ay, u0, u1);
  return flip ? -wh : wh;
}

// ---------------------------------------------------------------- lobes

enum { MAT_MATTE = 0, MAT_MIRROR, MAT_GLASS, MAT_PLASTIC, MAT_METAL,
       MAT_ROUGHGLASS, MAT_PHONG };
enum { LOBE_LAMBERT = 0, LOBE_SPECULAR, LOBE_FRESNEL, LOBE_MICROFACET,
       LOBE_PHONG, LOBE_MICROFACET_TRANS };

template <class T> struct LobeT {
  int kind, mf;
  V3<T> f0, f1, f2;
  T a0, a1, eta_i, eta_t;
  bool conductor;
};
using Lobe = LobeT<F>;

template <class T> __device__ T roughness_to_alpha(T r) {
  T x = log_(cmin(r, K(1e-3)));
  T x2 = x * x;
  return K(1.62142) + K(0.819955) * x + K(0.1734) * x * x + K(0.0171201) * (x2 * x)
         + K(0.000640711) * (x2 * x2);
}

// make_lobe, then _sanitize (every use of the lobe sanitizes it first)
template <class T>
__device__ LobeT<T> make_lobe(int mat, V3<T> c0, V3<T> c1, T s0, T s1, bool remap, F u_lobe, int mf) {
  LobeT<T> L;
  T ld = luminance(c0);
  T ls = luminance(c1);
  T qd = ld / cmin(ld + ls, K(1e-12));
  bool diffuse = u_lobe < qd;
  bool reflect = u_lobe < K(0.5);
  T rs0 = remap ? roughness_to_alpha(s0) : s0;
  T rs1 = remap ? roughness_to_alpha(s1) : s1;
  bool pl = mat == MAT_PLASTIC, rg = mat == MAT_ROUGHGLASS, metal = mat == MAT_METAL;
  int kind = LOBE_LAMBERT;
  if (mat == MAT_MATTE) kind = LOBE_LAMBERT;
  else if (mat == MAT_MIRROR) kind = LOBE_SPECULAR;
  else if (mat == MAT_GLASS) kind = LOBE_FRESNEL;
  else if (pl) kind = diffuse ? LOBE_LAMBERT : LOBE_MICROFACET;
  else if (metal) kind = LOBE_MICROFACET;
  else if (rg) kind = reflect ? LOBE_MICROFACET : LOBE_MICROFACET_TRANS;
  else if (mat == MAT_PHONG) kind = LOBE_PHONG;
  L.kind = kind;
  L.mf = mf;
  V3<T> f0 = c0;
  if (pl && diffuse) f0 = c0 / cmin(qd, K(1e-12));
  if (pl && !diffuse) f0 = c1 / cmin(K(1.0) - qd, K(1e-12));
  if (metal) f0 = V3<T>{K(1.0), K(1.0), K(1.0)};
  if (rg && reflect) f0 = c0 * K(2.0);
  if (rg && !reflect) f0 = c1 * K(2.0);
  L.f0 = f0;
  L.f1 = mat == MAT_GLASS ? c1 : (metal ? c0 : zero3<T>());
  L.f2 = metal ? c1 : zero3<T>();
  T a0 = K(0.0), a1 = K(0.0);
  if (mat == MAT_GLASS) a0 = s0;
  if (pl || metal || rg) a0 = rs0;
  if (mat == MAT_PHONG) a0 = s0;
  if (pl || rg) a1 = rs0;
  if (metal) a1 = rs1;
  L.conductor = metal;
  T eta_i = pl ? T(K(1.5)) : T(K(1.0));
  T eta_t = rg ? cmin(s1, K(1.0001)) : T(K(1.0));
  // _sanitize
  bool is_mf = kind == LOBE_MICROFACET || kind == LOBE_MICROFACET_TRANS;
  T alpha0 = is_mf ? cmin(a0, K(1e-4)) : T(K(0.25));
  T alpha1 = is_mf ? cmin(a1, K(1e-4)) : T(K(0.25));
  T sa0 = kind == LOBE_FRESNEL ? cmin(a0, K(1.0001)) : alpha0;
  if (kind == LOBE_PHONG) sa0 = cmin(a0, K(1e-3));
  L.a0 = sa0;
  L.a1 = alpha1;
  L.eta_i = cmin(eta_i, K(1e-3));
  L.eta_t = cmin(eta_t, K(1e-3));
  return L;
}

template <class T> __device__ __forceinline__ bool same_hemisphere(V3<T> wo, V3<T> wi) {
  return wo.z * wi.z > K(0.0);
}

template <class T> __device__ V3<T> eval_lambert(const LobeT<T>& L, V3<T> wo, V3<T> wi) {
  return same_hemisphere(wo, wi) ? L.f0 * K(1.0 / PI) : zero3<T>();
}
template <class T> __device__ T pdf_lambert(V3<T> wo, V3<T> wi) {
  return same_hemisphere(wo, wi) ? fabs_(wi.z) * K(1.0 / PI) : T(K(0.0));
}

template <class T> __device__ V3<T> microfacet_fresnel(const LobeT<T>& L, T cos_i) {
  if (L.conductor)
    return {fresnel_conductor_1(cos_i, L.f1.x, L.f2.x),
            fresnel_conductor_1(cos_i, L.f1.y, L.f2.y),
            fresnel_conductor_1(cos_i, L.f1.z, L.f2.z)};
  T f = fresnel_dielectric(cos_i, L.eta_i, L.eta_t);
  return {f, f, f};
}

template <class T> __device__ __forceinline__ V3<T> eval_microfacet(const LobeT<T>& L, int mode, V3<T> wo, V3<T> wi) {
  T cos_o = fabs_(wo.z);
  T cos_i = fabs_(wi.z);
  V3<T> wh_raw = wo + wi;
  bool degenerate = cos_o < K(1e-9) || cos_i < K(1e-9) || dot(wh_raw, wh_raw) < K(1e-18);
  V3<T> wh = normalize(wh_raw);
  V3<T> wh_ff = dot(wh, V3<T>{K(0.0), K(0.0), K(1.0)}) < K(0.0) ? -wh : wh;
  V3<T> fr = microfacet_fresnel(L, dot(wi, wh_ff));
  T d = mf_d(mode, L.mf, wh, L.a0, L.a1);
  T g = mf_g(mode, L.mf, wo, wi, L.a0, L.a1);
  T den = cmin(K(4.0) * cos_i * cos_o, K(1e-12));
  V3<T> f = L.f0 * (d * g) * fr / den;
  return degenerate ? zero3<T>() : f;
}

template <class T> __device__ V3<T> eval_phong(const LobeT<T>& L, V3<T> wo, V3<T> wi) {
  bool ok = same_hemisphere(wo, wi);
  T cos_alpha = dot(flip_z(wo), wi);
  bool pos = cos_alpha > K(0.0);
  T base = sel(pos, cos_alpha, T(K(0.5)));
  V3<T> rho = L.f0 * ((L.a0 + K(2.0)) * K(1.0 / (2.0 * PI)));
  V3<T> f = rho * (pos ? pow_(base, cmin(L.a0, K(1e-6))) : T(K(0.0)));
  return ok ? f : zero3<T>();
}
template <class T> __device__ T pdf_phong(const LobeT<T>& L, V3<T> wo, V3<T> wi) {
  T cos_t = dot(flip_z(wo), wi);
  bool pos = cos_t > K(0.0);
  T base = sel(pos, cos_t, T(K(0.5)));
  T p = (L.a0 + K(1.0)) * pow_(base, cmin(L.a0, K(1e-6))) * K(1.0 / (2.0 * PI));
  return pos ? p : T(K(0.0));
}

template <class T> __device__ __forceinline__ T trans_eta(const LobeT<T>& L, V3<T> wo) {
  return wo.z > K(0.0) ? L.eta_t / L.eta_i : L.eta_i / L.eta_t;
}

template <class T> __device__ __forceinline__ V3<T> eval_microfacet_trans(const LobeT<T>& L, int mode, V3<T> wo, V3<T> wi) {
  T cos_o = wo.z, cos_i = wi.z;
  T eta = trans_eta(L, wo);
  V3<T> wh = normalize(wo + wi * eta);
  wh = wh.z < K(0.0) ? -wh : wh;
  T dot_o = dot(wo, wh);
  T dot_i = dot(wi, wh);
  bool invalid = same_hemisphere(wo, wi) || fabs_(cos_o) < K(1e-9)
                 || fabs_(cos_i) < K(1e-9) || dot_o * dot_i > K(0.0);
  T fr = fresnel_dielectric(dot_o, L.eta_i, L.eta_t);
  T sqrt_denom = dot_o + eta * dot_i;
  T d = mf_d(mode, L.mf, wh, L.a0, L.a1);
  T g = mf_g(mode, L.mf, wo, wi, L.a0, L.a1);
  T factor = rcp(cmin(eta, K(1e-6)));
  T mag = fabs_(d * g * eta * eta * fabs_(dot_i) * fabs_(dot_o) * factor * factor
                / cmin(fabs_(cos_i * cos_o) * sqrt_denom * sqrt_denom, K(1e-12)));
  V3<T> f = L.f0 * ((K(1.0) - fr) * mag);
  return invalid ? zero3<T>() : f;
}

template <class T> __device__ __forceinline__ T pdf_microfacet_trans(const LobeT<T>& L, int mode, V3<T> wo, V3<T> wi) {
  T eta = trans_eta(L, wo);
  V3<T> wh = normalize(wo + wi * eta);
  T dot_o = dot(wo, wh);
  T dot_i = dot(wi, wh);
  bool invalid = same_hemisphere(wo, wi) || dot_o * dot_i > K(0.0);
  T sqrt_denom = dot_o + eta * dot_i;
  T dwh_dwi = fabs_(eta * eta * dot_i) / cmin(sqrt_denom * sqrt_denom, K(1e-12));
  V3<T> wh_up = wh.z < K(0.0) ? -wh : wh;
  T p = pdf_wh(mode, L.mf, wo, wh_up, L.a0, L.a1) * dwh_dwi;
  return invalid ? T(K(0.0)) : p;
}

// eval_f of the lane's own lobe; a kind the scene does not hold gives 0
template <class T> __device__ __forceinline__ V3<T> eval_f(const LobeT<T>& L, int lobes, int mode, V3<T> wo, V3<T> wi) {
  if (!((lobes >> L.kind) & 1)) return zero3<T>();
  switch (L.kind) {
    case LOBE_LAMBERT: return eval_lambert(L, wo, wi);
    case LOBE_MICROFACET: return eval_microfacet(L, mode, wo, wi);
    case LOBE_PHONG: return eval_phong(L, wo, wi);
    case LOBE_MICROFACET_TRANS: return eval_microfacet_trans(L, mode, wo, wi);
    default: return zero3<T>();
  }
}

template <class T> struct BSDFSampleT { V3<T> wi, f; T pdf; };
using BSDFSample = BSDFSampleT<F>;

template <class T>
__device__ __forceinline__ BSDFSampleT<T> sample_bsdf(const LobeT<T>& L, int lobes, int mode, V3<T> wo, F u0, F u1) {
  BSDFSampleT<T> s = {zero3<T>(), zero3<T>(), T(K(0.0))};
  if (!((lobes >> L.kind) & 1)) return s;
  switch (L.kind) {
    case LOBE_LAMBERT: {
      F dx, dy;
      concentric_disk(u0, u1, &dx, &dy);
      F z = sqrt_(cmin(K(1.0) - dx * dx - dy * dy, K(0.0)));
      V3<T> wi = up3<T>(v3(dx, dy, z));
      wi = wo.z < K(0.0) ? negate_z(wi) : wi;
      s.wi = wi;
      s.f = eval_lambert(L, wo, wi);
      s.pdf = pdf_lambert(wo, wi);
      return s;
    }
    case LOBE_SPECULAR: {
      V3<T> wi = flip_z(wo);
      s.wi = wi;
      s.f = L.f0 / cmin(fabs_(wi.z), K(1e-9));
      s.pdf = K(1.0);
      return s;
    }
    case LOBE_FRESNEL: {
      T eta_t = L.a0;
      T cos_o = wo.z;
      T Fr = fresnel_dielectric(cos_o, T(K(1.0)), eta_t);
      if (u0 < Fr) {
        V3<T> wi = flip_z(wo);
        s.wi = wi;
        s.f = L.f0 * Fr / cmin(fabs_(wi.z), K(1e-9));
        s.pdf = Fr;
        return s;
      }
      bool entering = cos_o > K(0.0);
      T nz = entering ? T(K(1.0)) : T(K(-1.0));
      T e_i = sel(entering, T(K(1.0)), eta_t);
      T e_t = sel(entering, eta_t, T(K(1.0)));
      T eta = e_i / e_t;
      bool ok;
      V3<T> wi_t = refract(wo, V3<T>{K(0.0), K(0.0), nz}, eta, &ok);
      V3<T> ft = L.f1 * ((K(1.0) - Fr) * eta * eta);
      s.wi = wi_t;
      s.f = ok ? ft / cmin(fabs_(wi_t.z), K(1e-9)) : zero3<T>();
      s.pdf = ok ? K(1.0) - Fr : T(K(0.0));
      return s;
    }
    case LOBE_MICROFACET: {
      V3<T> wh = sample_wh(mode, L.mf, wo, L.a0, L.a1, u0, u1);
      V3<T> wi = -wo + wh * (K(2.0) * dot(wo, wh));
      bool ok = dot(wo, wh) >= K(0.0) && same_hemisphere(wo, wi) && fabs_(wo.z) > K(1e-9);
      V3<T> f = eval_microfacet(L, mode, wo, wi);
      T p = pdf_wh(mode, L.mf, wo, wh, L.a0, L.a1) / cmin(K(4.0) * dot(wo, wh), K(1e-12));
      s.wi = wi;
      s.f = ok ? f : zero3<T>();
      s.pdf = ok ? p : T(K(0.0));
      return s;
    }
    case LOBE_PHONG: {
      F phi = K(2.0 * PI) * u0;
      T ex = cmin(L.a0, K(1e-6));
      T cos_t = pow_(T(cmin(u1, K(1e-12))), rcp(ex + K(1.0)));
      T sin_t = ssqrt(K(1.0) - cos_t * cos_t);
      V3<T> local = {cos_(phi) * sin_t, sin_(phi) * sin_t, cos_t};
      V3<T> wi = to_world(frame_from_z(flip_z(wo)), local);
      wi = wo.z < K(0.0) ? negate_z(wi) : wi;
      s.wi = wi;
      s.f = eval_phong(L, wo, wi);
      s.pdf = pdf_phong(L, wo, wi);
      return s;
    }
    case LOBE_MICROFACET_TRANS: {
      V3<T> wh = sample_wh(mode, L.mf, wo, L.a0, L.a1, u0, u1);
      T eta_s = wo.z > K(0.0) ? L.eta_i / L.eta_t : L.eta_t / L.eta_i;
      bool refr_ok;
      V3<T> wi = normalize(refract(wo, wh, eta_s, &refr_ok));
      bool ok = dot(wo, wh) >= K(0.0) && refr_ok && fabs_(wo.z) > K(1e-9);
      V3<T> f = eval_microfacet_trans(L, mode, wo, wi);
      T p = pdf_microfacet_trans(L, mode, wo, wi);
      s.wi = wi;
      s.f = ok ? f : zero3<T>();
      s.pdf = ok ? p : T(K(0.0));
      return s;
    }
  }
  return s;
}

// ---------------------------------------------------------------- lights

enum { LIGHT_POINT = 0, LIGHT_DIRECTIONAL, LIGHT_AREA, LIGHT_ENV };
enum { KIND_TRI = 0, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST };

// One NEE light: its kinds, its slot in the vertex uniforms and, for an
// emissive instance, its family's raw mesh rows (p0, e1, e2, normal) in the
// light table's emissive-triangle buffer. Read from row k of the table's
// static part (ops/shade.py::light_table: kind, shape, slot, t_count, first
// em row); its numbers are row k of the table's float rows.
struct LightStatic {
  int kind, shape, slot, t_count;
  const float* em;    // [t_count, EM_W]
};

// li is the radiance, divided by d2 for a point light (1 for the others)
struct LightSample { F3 wi, li, pos; F pdf, d2; };

__device__ F area_convert_pdf(F pdf_area, F3 lpos, F3 ln, F3 p, F3 wi) {
  F3 dd = lpos - p;
  F d2 = dot(dd, dd);
  F cos_l = fabs_(dot(ln, -wi));
  F pdf = pdf_area * d2 / cmin(cos_l, K(1e-12));
  bool ok = d2 > K(0.0) && cos_l > K(1e-9) && isfinite_(pdf);
  return ok ? pdf : K(0.0);
}

__device__ LightSample sample_li(const LightStatic& ls, const float* row, F3 p, F u0, F u1) {
  LightSample out;
  out.d2 = K(1.0);
  F3 radiance = ld3(row);
  F two_wr = {row[TABLE_W - 1]};
  if (ls.kind == LIGHT_POINT) {
    F3 lpos = ld3(row + 3);
    F3 delta = lpos - p;
    F d2 = cmin(dot(delta, delta), K(1e-20));
    out.wi = delta / sqrt_(d2);
    out.li = radiance / d2;
    out.d2 = d2;
    out.pdf = K(1.0);
    out.pos = lpos;
    return out;
  }
  if (ls.kind == LIGHT_DIRECTIONAL) {
    F3 wi = -ld3(row + 3);
    out.wi = wi;
    out.pos = p + wi * two_wr;
    out.li = radiance;
    out.pdf = K(1.0);
    return out;
  }
  if (ls.kind == LIGHT_ENV) {
    F theta = u1 * K(PI);
    F phi = u0 * K(2.0) * K(PI);
    F sin_t = sin_(theta);
    F3 wi = v3(sin_t * cos_(phi), sin_t * sin_(phi), cos_(theta));
    out.wi = wi;
    out.pos = p + wi * two_wr;
    out.pdf = sin_t != K(0.0) ? rcp(K(2.0 * PI * PI) * cmin(sin_t, K(1e-12))) : K(0.0);
    out.li = radiance;
    return out;
  }
  // area lights (FAreaLight::Sample_Li)
  F3 pos, nrm;
  F pdf;
  F pdf_area = {row[15]};
  if (ls.shape == KIND_SPHERE) {
    F3 c = ld3(row + 3);
    F r = {row[16]};
    F3 delta = c - p;
    F dist2 = cmin(dot(delta, delta), K(1e-20));
    bool inside = dist2 <= r * r;
    if (inside) {
      F z = K(1.0) - K(2.0) * u0;
      F rr = sqrt_(cmin(K(1.0) - z * z, K(0.0)));
      F phi = K(2.0 * PI) * u1;
      F3 dirs = v3(rr * cos_(phi), rr * sin_(phi), z);
      pos = c + dirs * r;
      nrm = dirs;
      pdf = area_convert_pdf(pdf_area, pos, nrm, p, normalize(pos - p));
    } else {
      F dist = sqrt_(dist2);
      F3 w = delta * rcp(dist);
      F sin2_max = clamp_(r * r / dist2, K(0.0), K(1.0));
      F sin_max = sqrt_(sin2_max);
      F inv_sin_max = rcp(cmin(sin_max, K(1e-12)));
      F cos_max = sqrt_(cmin(K(1.0) - sin2_max, K(0.0)));
      F cos_t = (cos_max - K(1.0)) * u0 + K(1.0);
      F sin2_t = K(1.0) - cos_t * cos_t;
      if (sin2_max < K(0.00068523)) {
        sin2_t = sin2_max * u0;
        cos_t = sqrt_(K(1.0) - sin2_t);
      }
      F cos_alpha = sin2_t * inv_sin_max
                    + cos_t * sqrt_(cmin(K(1.0) - sin2_t * inv_sin_max * inv_sin_max, K(0.0)));
      F sin_alpha = sqrt_(cmin(K(1.0) - cos_alpha * cos_alpha, K(0.0)));
      F phi = u1 * K(2.0) * K(PI);
      F3 local = v3(sin_alpha * cos_(phi), sin_alpha * sin_(phi), cos_alpha);
      F3 wn = -to_world(frame_from_z(w), local);
      pos = c + wn * r;
      nrm = wn;
      pdf = rcp(K(2.0 * PI) * cmin(K(1.0) - cos_max, K(1e-12)));
    }
  } else {
    if (ls.shape == KIND_TRI) {
      F su0 = sqrt_(u0);
      F b0 = K(1.0) - su0, b1 = u1 * su0;
      pos = (ld3(row + 3) * b0 + ld3(row + 6) * b1) + ld3(row + 9) * (K(1.0) - b0 - b1);
      nrm = ld3(row + 12);
    } else if (ls.shape == KIND_RECT) {
      pos = (ld3(row + 3) + ld3(row + 6) * u0) + ld3(row + 9) * u1;
      nrm = ld3(row + 12);
    } else if (ls.shape == KIND_DISK) {
      F dx, dy;
      concentric_disk(u0, u1, &dx, &dy);
      F r = {row[16]};
      pos = ld3(row + 3) + (ld3(row + 6) * dx + ld3(row + 9) * dy) * r;
      nrm = ld3(row + 12);
    } else {  // an emissive instance: a raw-mesh triangle picked by index
      F t_count = {(float)ls.t_count};
      F uu = clamp_(u0 * t_count, K(0.0), K((double)ls.t_count - 1e-3));
      long long ti = (long long)uu.v;
      F u0r = uu - F{(float)ti};
      const float* em = ls.em + ti * EM_W;
      F3 p0 = ld3(em), e1 = ld3(em + 3), e2 = ld3(em + 6);
      F su0 = sqrt_(u0r);
      F b0 = K(1.0) - su0, b1 = u1 * su0;
      F3 pos_l = (p0 + e1 * b1) + e2 * (K(1.0) - b0 - b1);
      F scl = {row[16]};
      pos = pos_l * scl + ld3(row + 3);
      F area_w = cmin(K(0.5) * length(cross(e1, e2)) * scl * scl, K(1e-20));
      pdf_area = rcp(t_count * area_w);
      nrm = ld3(em + 9);
    }
    pdf = area_convert_pdf(pdf_area, pos, nrm, p, normalize(pos - p));
  }
  F3 wi = normalize(pos - p);
  bool facing = dot(nrm, -wi) > K(0.0);
  F3 dd = pos - p;
  F d2 = dot(dd, dd);
  bool lit = facing && pdf > K(0.0) && d2 > K(0.0);
  out.wi = wi;
  out.pdf = pdf;
  out.li = lit ? radiance : zero3();
  out.pos = pos;
  return out;
}

// ---------------------------------------------------------------- textures

enum { TEX_SOLID = 0, TEX_CHECKER, TEX_IMAGE, TEX_IMAGE_BILINEAR };

}  // namespace

struct ShadeArgs {
  int n, bounce, last, roulette, lobes, mf_mode, n_tex, has_images;
  int n_light_rows, th, tw, s, n_nee;
  int u_stride;  // floats from one lane's uniforms to the next (s where contiguous)
  // hit
  const uint8_t* valid; const float* pos; const float* nrm; const float* wo;
  const float* uv; const int32_t* mat_id; const int32_t* light_id;
  // lane state
  const float* L; const float* beta; const uint8_t* active;
  const uint8_t* prev_specular; const float* prev_pdf; const float* ray_o;
  const float* ray_d; const float* u;
  // materials, textures, lights
  const int32_t* mat_kind; const float* mat_c0; const float* mat_c1;
  const float* mat_s0; const float* mat_s1; const uint8_t* mat_remap;
  const int32_t* mat_tex; const int32_t* mat_mf;
  const int32_t* tex_kind; const float* tex_c0; const float* tex_c1;
  const float* tex_scale; const float* tex_image; const int32_t* tex_wh;
  const float* light_c;
  // the light table: float rows [n_nee, TABLE_W], static part [n_nee,
  // STATIC_W], emissive-instance triangles [*, EM_W], the environment
  // lights' summed radiance [3]
  const float* table; const int32_t* statics; const float* em; const float* le_env;
  // outputs
  float* L_out; float* beta_out; uint8_t* active_out; uint8_t* spec_out;
  float* pdf_out; float* o_out; float* d_out; uint8_t* useful;
  float* contrib; float* shadow_to;
  // the next cast's bounds where(active_out, ray_eps, inf) and
  // where(active_out, inf, -1) (null on the last bounce)
  const float* ray_eps; float* tmin_out; float* tmax_out;
  // null, or the wave's int64 ray counters (primary, bounce, shadow, all):
  // this vertex adds its live lanes (the cast that found its hits) and its
  // useful shadow rays
  long long* counts;
};

namespace {

__device__ __forceinline__ long long texel_row(const ShadeArgs& a, int tex, int xi, int yi) {
  xi = min(max(xi, 0), a.tex_wh[2 * tex] - 1);
  yi = min(max(yi, 0), a.tex_wh[2 * tex + 1] - 1);
  return ((long long)tex * a.th + yi) * a.tw + xi;
}
__device__ F3 texel(const ShadeArgs& a, int tex, int xi, int yi) {
  return ld3(a.tex_image + texel_row(a, tex, xi, yi) * 3);
}

// Where a texture tap's value came from: `src` 0 the texture's c0 row,
// 1 its c1 row, 2 the image's texels (rows[k] with weights w[k], k <
// taps). The weights are the plain version's: d out / d texel k, each the
// product its backward forms, (g (1 - ty)) (1 - tx) and so on; the
// gradient multiplies them in that order (tap_weights).
struct TexTap {
  int src, taps;
  long long rows[4];
  F tx, ty;
};

// texture.sample at the hit; tap (where given) says where it came from
__device__ F3 tex_sample(const ShadeArgs& a, int tex, F uu, F uv, F3 p, TexTap* tap = nullptr) {
  int kind = a.tex_kind[tex];
  F3 c0 = ld3(a.tex_c0 + 3 * tex);
  F3 out = c0;
  if (tap) tap->src = 0, tap->taps = 0;
  if (kind == TEX_CHECKER) {
    F scale = {a.tex_scale[tex]};
    F s = sin_(scale * p.x) * sin_(scale * p.y) * sin_(scale * p.z);
    out = s < K(0.0) ? c0 : ld3(a.tex_c1 + 3 * tex);
    if (tap) tap->src = s < K(0.0) ? 0 : 1;
  }
  if (a.has_images && (kind == TEX_IMAGE || kind == TEX_IMAGE_BILINEAR)) {
    F x = clamp_(uu, K(0.0), K(1.0));
    F y = clamp_(uv, K(0.0), K(1.0));
    F w = {(float)a.tex_wh[2 * tex]}, h = {(float)a.tex_wh[2 * tex + 1]};
    if (kind == TEX_IMAGE) {
      int xi = (int)(x * w).v, yi = (int)((K(1.0) - y) * h).v;
      out = texel(a, tex, xi, yi);
      if (tap) *tap = {2, 1, {texel_row(a, tex, xi, yi), 0, 0, 0}, K(0.0), K(0.0)};
    } else {
      F fx = x * w - K(0.5);
      F fy = (K(1.0) - y) * h - K(0.5);
      int x0 = (int)floorf(fx.v), y0 = (int)floorf(fy.v);
      F tx = fx - F{(float)x0}, ty = fy - F{(float)y0};
      F3 ta = texel(a, tex, x0, y0), tb = texel(a, tex, x0 + 1, y0);
      F3 tc = texel(a, tex, x0, y0 + 1), td = texel(a, tex, x0 + 1, y0 + 1);
      out = (ta * (K(1.0) - tx) + tb * tx) * (K(1.0) - ty)
            + (tc * (K(1.0) - tx) + td * tx) * ty;
      if (tap)
        *tap = {2, 4, {texel_row(a, tex, x0, y0), texel_row(a, tex, x0 + 1, y0),
                       texel_row(a, tex, x0, y0 + 1), texel_row(a, tex, x0 + 1, y0 + 1)},
                tx, ty};
    }
  }
  return out;
}

}  // namespace
