// The path vertex of li_path as two CUDA kernels for sm_90a.
//
// Replaces the per-lane math of one path vertex in
// jet_pbrt_tpu_torch/models/integrators.py::li_path (the counterpart of the
// vertex block of jet_pbrt_tpu/models/integrators.py:108-237 under
// jax.jit(wave), which XLA fuses; the reference has no Pallas kernel for
// it), as ops/shade.py's plain versions compute it op by op:
//
//   shade_vertex_kernel    one thread per lane: the emission add, then (not
//                          on the last bounce) the material with its
//                          texture tap, the lobe, the shading frame, every
//                          NEE light's sample, f, `useful` mask,
//                          contribution and shadow endpoint, the BSDF
//                          sample, Russian roulette and the next bounce's
//                          state with the next cast's bounds. Only the
//                          lane's own lobe and light branches run (the
//                          plain version computes every present kind and
//                          selects). Where the wave counts its rays, each
//                          block adds its live lanes and useful shadow rays
//                          to the wave's int64 counters, one atomic add per
//                          counter (the sums are exact: integers).
//   nee_accumulate_kernel  L + where(useful & ~occluded, contrib, 0), one
//                          light after another in light order.
//
// Bit for bit with the plain version on the card: every float operation is
// the one torch's eager op rounds (__fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn through the F type, never contracted to an FMA), with the
// three rules torch's CUDA ops follow that were measured on the card: a sum
// over a last dimension of 3 adds ((0 + p0) + p2) + (0 + p1); torch.linalg
// .cross rounds each component as fmaf(a1, b2, -(a2 * b1)); amax keeps the
// first NaN and otherwise the larger value, reducing (c0, c2) before c1.
// clamp / clamp_min propagate NaN, and libdevice's sinf, cosf, expf, logf,
// log1pf, erff, erfinvf, acosf and powf are what torch calls. Constants are
// the float32 roundings of the Python doubles (K()).
//
// Bound: bytes. A lane reads its hit, state and uniforms (about 115 B at the
// default bunny's S = 8) and writes its state, and per NEE light its shadow
// endpoint, contribution and mask (about 105 B): about 0.07 ms per vertex at
// 2^20 lanes and 3.35 TB/s. Making it approach that is left to later work:
// lanes sorted by material (the lanes of a warp diverge by lobe here), a
// structure-of-arrays state, and the hit reconstruction folded in.

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

// ---------------------------------------------------------------- vectors

struct F3 { F x, y, z; };

__device__ __forceinline__ F3 v3(F x, F y, F z) { return {x, y, z}; }
__device__ __forceinline__ F3 ld3(const float* p) { return {{p[0]}, {p[1]}, {p[2]}}; }
__device__ __forceinline__ void st3(float* p, F3 a) { p[0] = a.x.v; p[1] = a.y.v; p[2] = a.z.v; }
__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, F3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ F3 operator/(F3 a, F3 b) { return {a.x / b.x, a.y / b.y, a.z / b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, F s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ F3 operator/(F3 a, F s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ F3 operator-(F3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ F3 zero3() { return {K(0.0), K(0.0), K(0.0)}; }

// torch.sum(a * b, -1) on the card: the products, then ((0 + p0) + p2) + (0 + p1)
__device__ __forceinline__ F dot(F3 a, F3 b) {
  F p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return ((K(0.0) + p0) + p2) + (K(0.0) + p1);
}
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {fma_(a.y, b.z, -(a.z * b.y)), fma_(a.z, b.x, -(a.x * b.z)),
          fma_(a.x, b.y, -(a.y * b.x))};
}
__device__ __forceinline__ F length(F3 a) { return sqrt_(dot(a, a)); }
__device__ __forceinline__ F3 normalize(F3 a) { return a * rcp(cmin(length(a), K(1e-20))); }
// torch.amax(c, -1) on the card
__device__ __forceinline__ F max_component(F3 c) {
  auto mx = [](F a, F b) { return (isnan(a.v) || a.v > b.v) ? a : b; };
  return mx(mx(c.x, c.z), c.y);
}
__device__ __forceinline__ bool is_black(F3 c) {
  return c.x == K(0.0) && c.y == K(0.0) && c.z == K(0.0);
}
__device__ __forceinline__ F luminance(F3 c) {
  return (K(0.212671) * c.x + K(0.715160) * c.y) + K(0.072169) * c.z;
}
__device__ __forceinline__ F3 flip_z(F3 v) { return {-v.x, -v.y, v.z}; }
__device__ __forceinline__ F3 negate_z(F3 v) { return {v.x, v.y, -v.z}; }

struct Frame { F3 s, t, n; };

__device__ __forceinline__ Frame frame_from_z(F3 n) {
  F3 helper = fabs_(n.x) > K(0.99) ? v3(K(0.0), K(1.0), K(0.0))
                                   : v3(K(1.0), K(0.0), K(0.0));
  F3 t = normalize(cross(n, helper));
  F3 s = normalize(cross(t, n));
  return {s, t, n};
}
__device__ __forceinline__ F3 to_local(const Frame& f, F3 v) {
  return {dot(v, f.s), dot(v, f.t), dot(v, f.n)};
}
__device__ __forceinline__ F3 to_world(const Frame& f, F3 v) {
  return (f.s * v.x + f.t * v.y) + f.n * v.z;
}

// refract(wi, n, eta) -> (wt, ok)
__device__ __forceinline__ F3 refract(F3 wi, F3 n, F eta, bool* ok) {
  F cos_i = dot(n, wi);
  F sin2_i = cmin(K(1.0) - cos_i * cos_i, K(0.0));
  F sin2_t = eta * eta * sin2_i;
  *ok = sin2_t < K(1.0);
  F cos_t = ssqrt(K(1.0) - sin2_t);
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

__device__ F fresnel_dielectric(F cos_theta_i, F eta_i, F eta_t) {
  F ci = clamp_(cos_theta_i, K(-1.0), K(1.0));
  bool entering = ci > K(0.0);
  F e_i = sel(entering, eta_i, eta_t);
  F e_t = sel(entering, eta_t, eta_i);
  ci = fabs_(ci);
  F sin_t = e_i / e_t * ssqrt(K(1.0) - ci * ci);
  bool tir = sin_t >= K(1.0);
  F ct = ssqrt(K(1.0) - sin_t * sin_t);
  F r_parl = (e_t * ci - e_i * ct) / cmin(e_t * ci + e_i * ct, K(1e-20));
  F r_perp = (e_i * ci - e_t * ct) / cmin(e_i * ci + e_t * ct, K(1e-20));
  F f = K(0.5) * (r_parl * r_parl + r_perp * r_perp);
  return tir ? K(1.0) : f;
}

// eta_i = 1: `eta_t / 1.0` and `k / 1.0` are exact
__device__ F fresnel_conductor_1(F cos_theta_i, F eta, F etak) {
  F c = clamp_(fabs_(cos_theta_i), K(0.0), K(1.0));
  F c2 = c * c;
  F s2 = K(1.0) - c2;
  F eta2 = eta * eta;
  F etak2 = etak * etak;
  F t0 = eta2 - etak2 - s2;
  F a2b2 = sqrt_(cmin(t0 * t0 + K(4.0) * eta2 * etak2, K(0.0)));
  F t1 = a2b2 + c2;
  F a = sqrt_(cmin(K(0.5) * (a2b2 + t0), K(0.0)));
  F t2 = K(2.0) * a * c;
  F rs = (t1 - t2) / cmin(t1 + t2, K(1e-20));
  F t3 = c2 * a2b2 + s2 * s2;
  F t4 = t2 * s2;
  F rp = rs * (t3 - t4) / cmin(t3 + t4, K(1e-20));
  return K(0.5) * (rp + rs);
}

// ---------------------------------------------------------------- microfacet

enum { GGX = 0, BECKMANN = 1 };

struct Trig { F cos2, sin2, cphi, sphi; };

__device__ __forceinline__ Trig trig(F3 w) {
  F cos2 = clamp_(w.z * w.z, K(0.0), K(1.0));
  F sin2 = K(1.0) - cos2;
  F sin_theta = sqrt_(sin2);
  F safe_sin = cmin(sin_theta, K(1e-12));
  bool big = sin_theta > K(1e-12);
  F cphi = big ? w.x / safe_sin : K(1.0);
  F sphi = big ? w.y / safe_sin : K(0.0);
  return {cos2, sin2, clamp_(cphi, K(-1.0), K(1.0)), clamp_(sphi, K(-1.0), K(1.0))};
}

__device__ F d_ggx(F3 wh, F ax, F ay) {
  Trig g = trig(wh);
  F tan2 = g.sin2 / cmin(g.cos2, K(1e-12));
  F e = (g.cphi * g.cphi / cmin(ax * ax, K(1e-12))
         + g.sphi * g.sphi / cmin(ay * ay, K(1e-12))) * tan2;
  F c2 = cmin(g.cos2, K(1e-12));
  F ope = K(1.0) + e;
  F d = rcp(K(PI) * ax * ay * (c2 * c2) * (ope * ope));
  return g.cos2 > K(0.0) ? d : K(0.0);
}

__device__ F lambda_ggx(F3 w, F ax, F ay) {
  Trig g = trig(w);
  F abs_tan = sqrt_(g.sin2 / cmin(g.cos2, K(1e-12)));
  F alpha = sqrt_(g.cphi * g.cphi * (ax * ax) + g.sphi * g.sphi * (ay * ay));
  F at = alpha * abs_tan;
  F lam = K(0.5) * (sqrt_(K(1.0) + at * at) + K(-1.0));
  return g.cos2 > K(1e-12) ? lam : K(0.0);
}

__device__ F d_beckmann(F3 wh, F ax, F ay) {
  Trig g = trig(wh);
  F tan2 = g.sin2 / cmin(g.cos2, K(1e-12));
  F c2 = cmin(g.cos2, K(1e-12));
  F d = exp_(-tan2 * (g.cphi * g.cphi / cmin(ax * ax, K(1e-12))
                      + g.sphi * g.sphi / cmin(ay * ay, K(1e-12))))
        / (K(PI) * ax * ay * (c2 * c2));
  return g.cos2 > K(0.0) ? d : K(0.0);
}

__device__ F lambda_beckmann(F3 w, F ax, F ay) {
  Trig g = trig(w);
  F abs_tan = sqrt_(g.sin2 / cmin(g.cos2, K(1e-12)));
  F alpha = sqrt_(g.cphi * g.cphi * (ax * ax) + g.sphi * g.sphi * (ay * ay));
  F a = rcp(cmin(alpha * abs_tan, K(1e-12)));
  F lam = (K(1.0) - K(1.259) * a + K(0.396) * a * a) / (K(3.535) * a + K(2.181) * a * a);
  return (a >= K(1.6) || g.cos2 <= K(1e-12)) ? K(0.0) : lam;
}

// mf_mode: 0 select by the lane's kind (GGX, else Beckmann), 1 GGX alone,
// 2 Beckmann alone (the scene's present_mf_kinds)
__device__ __forceinline__ bool use_ggx(int mode, int kind) {
  return mode == 1 || (mode == 0 && kind == GGX);
}
__device__ F mf_d(int mode, int kind, F3 wh, F ax, F ay) {
  return use_ggx(mode, kind) ? d_ggx(wh, ax, ay) : d_beckmann(wh, ax, ay);
}
__device__ F mf_lam(int mode, int kind, F3 w, F ax, F ay) {
  return use_ggx(mode, kind) ? lambda_ggx(w, ax, ay) : lambda_beckmann(w, ax, ay);
}
__device__ F mf_g1(int mode, int kind, F3 w, F ax, F ay) {
  return rcp(mf_lam(mode, kind, w, ax, ay) + K(1.0));
}
__device__ F mf_g(int mode, int kind, F3 wo, F3 wi, F ax, F ay) {
  return rcp(mf_lam(mode, kind, wo, ax, ay) + K(1.0) + mf_lam(mode, kind, wi, ax, ay));
}
__device__ F pdf_wh(int mode, int kind, F3 wo, F3 wh, F ax, F ay) {
  return mf_d(mode, kind, wh, ax, ay) * mf_g1(mode, kind, wo, ax, ay)
         * fabs_(dot(wo, wh)) / cmin(fabs_(wo.z), K(1e-12));
}

__device__ F3 sample_ggx_vndf(F3 wo_up, F ax, F ay, F u0, F u1) {
  F3 vh = normalize(v3(ax * wo_up.x, ay * wo_up.y, wo_up.z));
  F lensq = vh.x * vh.x + vh.y * vh.y;
  F inv = rcp(sqrt_(cmin(lensq, K(1e-20))));
  F3 t1 = lensq > K(1e-20) ? v3(-vh.y * inv, vh.x * inv, K(0.0))
                           : v3(K(1.0), K(0.0), K(0.0));
  F3 t2 = cross(vh, t1);
  F r = sqrt_(u0);
  F phi = K(2.0 * PI) * u1;
  F p1 = r * cos_(phi);
  F p2 = r * sin_(phi);
  F s = K(0.5) * (vh.z + K(1.0));
  p2 = (K(1.0) - s) * ssqrt(K(1.0) - p1 * p1) + s * p2;
  F pz = ssqrt(K(1.0) - p1 * p1 - p2 * p2);
  F3 nh = (t1 * p1 + t2 * p2) + vh * pz;
  return normalize(v3(ax * nh.x, ay * nh.y, cmin(nh.z, K(1e-6))));
}

__device__ void beckmann_slope_sample(F cos_theta, F u1, F u2, F* sx, F* sy) {
  u1 = clamp_(u1, K(1e-6), K(1.0 - 1e-6));
  u2 = clamp_(u2, K(1e-6), K(1.0 - 1e-6));
  F r_ni = sqrt_(-log1p_(-u1));
  bool ni = cos_theta > K(0.9999);
  if (ni) {
    *sx = r_ni * cos_(K(2.0 * PI) * u2);
    *sy = r_ni * sin_(K(2.0 * PI) * u2);
    return;
  }
  F cos_safe = clamp_(cos_theta, K(-0.9999), K(0.9999));
  F sin_t = sqrt_(cmin(K(1.0) - cos_safe * cos_safe, K(0.0)));
  F tan_t = sin_t / cos_safe;
  F cot_t = rcp(tan_t);
  F a = K(-1.0);
  F c = erf_(cot_t);
  F theta = acos_(cos_safe);
  F fit = K(1.0) + theta * (theta * (K(0.4265) - K(0.0594) * theta) + K(-0.876));
  F b = c - (K(1.0) + c) * pow_(K(1.0) - u1, fit);
  // 1 / sqrt(PI) rounded in float32 (a 0-d tensor in the plain version)
  F sqrt_pi_inv = rcp(sqrt_(K(PI)));
  F norm = rcp(K(1.0) + c + sqrt_pi_inv * tan_t * exp_(-cot_t * cot_t));
  for (int i = 0; i < 10; ++i) {
    b = (b >= a && b <= c) ? b : K(0.5) * (a + c);
    F inv_erf = erfinv_(clamp_(b, K(-1.0 + 1e-7), K(1.0 - 1e-7)));
    F value = norm * (K(1.0) + b + sqrt_pi_inv * tan_t * exp_(-inv_erf * inv_erf)) - u1;
    F deriv = norm * (K(1.0) - inv_erf * tan_t);
    bool pos = value > K(0.0);
    c = pos ? b : c;
    a = pos ? a : b;
    F step = value / (fabs_(deriv) > K(1e-12) ? deriv : K(1.0));
    b = b - (fabs_(value) < K(1e-6) ? K(0.0) : step);
  }
  b = clamp_(b, K(-1.0 + 1e-7), K(1.0 - 1e-7));
  *sx = erfinv_(b);
  *sy = erfinv_(K(2.0) * u2 - K(1.0));
}

__device__ F3 sample_beckmann_vndf(F3 wo_up, F ax, F ay, F u0, F u1) {
  F3 w_s = normalize(v3(ax * wo_up.x, ay * wo_up.y, wo_up.z));
  Trig g = trig(w_s);
  F sx, sy;
  beckmann_slope_sample(w_s.z, u0, u1, &sx, &sy);
  F rx = g.cphi * sx - g.sphi * sy;
  F ry = g.sphi * sx + g.cphi * sy;
  return normalize(v3(-ax * rx, -ay * ry, K(1.0)));
}

__device__ F3 sample_wh(int mode, int kind, F3 wo, F ax, F ay, F u0, F u1) {
  bool flip = wo.z < K(0.0);
  F3 wo_up = flip ? -wo : wo;
  F3 wh = use_ggx(mode, kind) ? sample_ggx_vndf(wo_up, ax, ay, u0, u1)
                              : sample_beckmann_vndf(wo_up, ax, ay, u0, u1);
  return flip ? -wh : wh;
}

// ---------------------------------------------------------------- lobes

enum { MAT_MATTE = 0, MAT_MIRROR, MAT_GLASS, MAT_PLASTIC, MAT_METAL,
       MAT_ROUGHGLASS, MAT_PHONG };
enum { LOBE_LAMBERT = 0, LOBE_SPECULAR, LOBE_FRESNEL, LOBE_MICROFACET,
       LOBE_PHONG, LOBE_MICROFACET_TRANS };

struct Lobe {
  int kind, mf;
  F3 f0, f1, f2;
  F a0, a1, eta_i, eta_t;
  bool conductor;
};

__device__ F roughness_to_alpha(F r) {
  F x = log_(cmin(r, K(1e-3)));
  F x2 = x * x;
  return K(1.62142) + K(0.819955) * x + K(0.1734) * x * x + K(0.0171201) * (x2 * x)
         + K(0.000640711) * (x2 * x2);
}

// make_lobe, then _sanitize (every use of the lobe sanitizes it first)
__device__ Lobe make_lobe(int mat, F3 c0, F3 c1, F s0, F s1, bool remap, F u_lobe, int mf) {
  Lobe L;
  F ld = luminance(c0);
  F ls = luminance(c1);
  F qd = ld / cmin(ld + ls, K(1e-12));
  bool diffuse = u_lobe < qd;
  bool reflect = u_lobe < K(0.5);
  F rs0 = remap ? roughness_to_alpha(s0) : s0;
  F rs1 = remap ? roughness_to_alpha(s1) : s1;
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
  F3 f0 = c0;
  if (pl && diffuse) f0 = c0 / cmin(qd, K(1e-12));
  if (pl && !diffuse) f0 = c1 / cmin(K(1.0) - qd, K(1e-12));
  if (metal) f0 = v3(K(1.0), K(1.0), K(1.0));
  if (rg && reflect) f0 = c0 * K(2.0);
  if (rg && !reflect) f0 = c1 * K(2.0);
  L.f0 = f0;
  L.f1 = mat == MAT_GLASS ? c1 : (metal ? c0 : zero3());
  L.f2 = metal ? c1 : zero3();
  F a0 = K(0.0), a1 = K(0.0);
  if (mat == MAT_GLASS) a0 = s0;
  if (pl || metal || rg) a0 = rs0;
  if (mat == MAT_PHONG) a0 = s0;
  if (pl || rg) a1 = rs0;
  if (metal) a1 = rs1;
  L.conductor = metal;
  F eta_i = pl ? K(1.5) : K(1.0);
  F eta_t = rg ? cmin(s1, K(1.0001)) : K(1.0);
  // _sanitize
  bool is_mf = kind == LOBE_MICROFACET || kind == LOBE_MICROFACET_TRANS;
  F alpha0 = is_mf ? cmin(a0, K(1e-4)) : K(0.25);
  F alpha1 = is_mf ? cmin(a1, K(1e-4)) : K(0.25);
  F sa0 = kind == LOBE_FRESNEL ? cmin(a0, K(1.0001)) : alpha0;
  if (kind == LOBE_PHONG) sa0 = cmin(a0, K(1e-3));
  L.a0 = sa0;
  L.a1 = alpha1;
  L.eta_i = cmin(eta_i, K(1e-3));
  L.eta_t = cmin(eta_t, K(1e-3));
  return L;
}

__device__ __forceinline__ bool same_hemisphere(F3 wo, F3 wi) { return wo.z * wi.z > K(0.0); }

__device__ F3 eval_lambert(const Lobe& L, F3 wo, F3 wi) {
  return same_hemisphere(wo, wi) ? L.f0 * K(1.0 / PI) : zero3();
}
__device__ F pdf_lambert(F3 wo, F3 wi) {
  return same_hemisphere(wo, wi) ? fabs_(wi.z) * K(1.0 / PI) : K(0.0);
}

__device__ F3 microfacet_fresnel(const Lobe& L, F cos_i) {
  if (L.conductor)
    return v3(fresnel_conductor_1(cos_i, L.f1.x, L.f2.x),
              fresnel_conductor_1(cos_i, L.f1.y, L.f2.y),
              fresnel_conductor_1(cos_i, L.f1.z, L.f2.z));
  F f = fresnel_dielectric(cos_i, L.eta_i, L.eta_t);
  return v3(f, f, f);
}

__device__ F3 eval_microfacet(const Lobe& L, int mode, F3 wo, F3 wi) {
  F cos_o = fabs_(wo.z);
  F cos_i = fabs_(wi.z);
  F3 wh_raw = wo + wi;
  bool degenerate = cos_o < K(1e-9) || cos_i < K(1e-9) || dot(wh_raw, wh_raw) < K(1e-18);
  F3 wh = normalize(wh_raw);
  F3 wh_ff = dot(wh, v3(K(0.0), K(0.0), K(1.0))) < K(0.0) ? -wh : wh;
  F3 fr = microfacet_fresnel(L, dot(wi, wh_ff));
  F d = mf_d(mode, L.mf, wh, L.a0, L.a1);
  F g = mf_g(mode, L.mf, wo, wi, L.a0, L.a1);
  F den = cmin(K(4.0) * cos_i * cos_o, K(1e-12));
  F3 f = L.f0 * (d * g) * fr / den;
  return degenerate ? zero3() : f;
}

__device__ F3 eval_phong(const Lobe& L, F3 wo, F3 wi) {
  bool ok = same_hemisphere(wo, wi);
  F cos_alpha = dot(flip_z(wo), wi);
  bool pos = cos_alpha > K(0.0);
  F base = sel(pos, cos_alpha, K(0.5));
  F3 rho = L.f0 * ((L.a0 + K(2.0)) * K(1.0 / (2.0 * PI)));
  F3 f = rho * (pos ? pow_(base, cmin(L.a0, K(1e-6))) : K(0.0));
  return ok ? f : zero3();
}
__device__ F pdf_phong(const Lobe& L, F3 wo, F3 wi) {
  F cos_t = dot(flip_z(wo), wi);
  bool pos = cos_t > K(0.0);
  F base = sel(pos, cos_t, K(0.5));
  F p = (L.a0 + K(1.0)) * pow_(base, cmin(L.a0, K(1e-6))) * K(1.0 / (2.0 * PI));
  return pos ? p : K(0.0);
}

__device__ __forceinline__ F trans_eta(const Lobe& L, F3 wo) {
  return wo.z > K(0.0) ? L.eta_t / L.eta_i : L.eta_i / L.eta_t;
}

__device__ F3 eval_microfacet_trans(const Lobe& L, int mode, F3 wo, F3 wi) {
  F cos_o = wo.z, cos_i = wi.z;
  F eta = trans_eta(L, wo);
  F3 wh = normalize(wo + wi * eta);
  wh = wh.z < K(0.0) ? -wh : wh;
  F dot_o = dot(wo, wh);
  F dot_i = dot(wi, wh);
  bool invalid = same_hemisphere(wo, wi) || fabs_(cos_o) < K(1e-9)
                 || fabs_(cos_i) < K(1e-9) || dot_o * dot_i > K(0.0);
  F fr = fresnel_dielectric(dot_o, L.eta_i, L.eta_t);
  F sqrt_denom = dot_o + eta * dot_i;
  F d = mf_d(mode, L.mf, wh, L.a0, L.a1);
  F g = mf_g(mode, L.mf, wo, wi, L.a0, L.a1);
  F factor = rcp(cmin(eta, K(1e-6)));
  F mag = fabs_(d * g * eta * eta * fabs_(dot_i) * fabs_(dot_o) * factor * factor
                / cmin(fabs_(cos_i * cos_o) * sqrt_denom * sqrt_denom, K(1e-12)));
  F3 f = L.f0 * ((K(1.0) - fr) * mag);
  return invalid ? zero3() : f;
}

__device__ F pdf_microfacet_trans(const Lobe& L, int mode, F3 wo, F3 wi) {
  F eta = trans_eta(L, wo);
  F3 wh = normalize(wo + wi * eta);
  F dot_o = dot(wo, wh);
  F dot_i = dot(wi, wh);
  bool invalid = same_hemisphere(wo, wi) || dot_o * dot_i > K(0.0);
  F sqrt_denom = dot_o + eta * dot_i;
  F dwh_dwi = fabs_(eta * eta * dot_i) / cmin(sqrt_denom * sqrt_denom, K(1e-12));
  F3 wh_up = wh.z < K(0.0) ? -wh : wh;
  F p = pdf_wh(mode, L.mf, wo, wh_up, L.a0, L.a1) * dwh_dwi;
  return invalid ? K(0.0) : p;
}

// eval_f of the lane's own lobe; a kind the scene does not hold gives 0
__device__ F3 eval_f(const Lobe& L, int lobes, int mode, F3 wo, F3 wi) {
  if (!((lobes >> L.kind) & 1)) return zero3();
  switch (L.kind) {
    case LOBE_LAMBERT: return eval_lambert(L, wo, wi);
    case LOBE_MICROFACET: return eval_microfacet(L, mode, wo, wi);
    case LOBE_PHONG: return eval_phong(L, wo, wi);
    case LOBE_MICROFACET_TRANS: return eval_microfacet_trans(L, mode, wo, wi);
    default: return zero3();
  }
}

struct BSDFSample { F3 wi, f; F pdf; };

__device__ BSDFSample sample_bsdf(const Lobe& L, int lobes, int mode, F3 wo, F u0, F u1) {
  BSDFSample s = {zero3(), zero3(), K(0.0)};
  if (!((lobes >> L.kind) & 1)) return s;
  switch (L.kind) {
    case LOBE_LAMBERT: {
      F dx, dy;
      concentric_disk(u0, u1, &dx, &dy);
      F z = sqrt_(cmin(K(1.0) - dx * dx - dy * dy, K(0.0)));
      F3 wi = v3(dx, dy, z);
      wi = wo.z < K(0.0) ? negate_z(wi) : wi;
      s.wi = wi;
      s.f = eval_lambert(L, wo, wi);
      s.pdf = pdf_lambert(wo, wi);
      return s;
    }
    case LOBE_SPECULAR: {
      F3 wi = flip_z(wo);
      s.wi = wi;
      s.f = L.f0 / cmin(fabs_(wi.z), K(1e-9));
      s.pdf = K(1.0);
      return s;
    }
    case LOBE_FRESNEL: {
      F eta_t = L.a0;
      F cos_o = wo.z;
      F Fr = fresnel_dielectric(cos_o, K(1.0), eta_t);
      if (u0 < Fr) {
        F3 wi = flip_z(wo);
        s.wi = wi;
        s.f = L.f0 * Fr / cmin(fabs_(wi.z), K(1e-9));
        s.pdf = Fr;
        return s;
      }
      bool entering = cos_o > K(0.0);
      F nz = entering ? K(1.0) : K(-1.0);
      F e_i = sel(entering, K(1.0), eta_t);
      F e_t = sel(entering, eta_t, K(1.0));
      F eta = e_i / e_t;
      bool ok;
      F3 wi_t = refract(wo, v3(K(0.0), K(0.0), nz), eta, &ok);
      F3 ft = L.f1 * ((K(1.0) - Fr) * eta * eta);
      s.wi = wi_t;
      s.f = ok ? ft / cmin(fabs_(wi_t.z), K(1e-9)) : zero3();
      s.pdf = ok ? K(1.0) - Fr : K(0.0);
      return s;
    }
    case LOBE_MICROFACET: {
      F3 wh = sample_wh(mode, L.mf, wo, L.a0, L.a1, u0, u1);
      F3 wi = -wo + wh * (K(2.0) * dot(wo, wh));
      bool ok = dot(wo, wh) >= K(0.0) && same_hemisphere(wo, wi) && fabs_(wo.z) > K(1e-9);
      F3 f = eval_microfacet(L, mode, wo, wi);
      F p = pdf_wh(mode, L.mf, wo, wh, L.a0, L.a1) / cmin(K(4.0) * dot(wo, wh), K(1e-12));
      s.wi = wi;
      s.f = ok ? f : zero3();
      s.pdf = ok ? p : K(0.0);
      return s;
    }
    case LOBE_PHONG: {
      F phi = K(2.0 * PI) * u0;
      F ex = cmin(L.a0, K(1e-6));
      F cos_t = pow_(cmin(u1, K(1e-12)), rcp(ex + K(1.0)));
      F sin_t = ssqrt(K(1.0) - cos_t * cos_t);
      F3 local = v3(cos_(phi) * sin_t, sin_(phi) * sin_t, cos_t);
      F3 wi = to_world(frame_from_z(flip_z(wo)), local);
      wi = wo.z < K(0.0) ? negate_z(wi) : wi;
      s.wi = wi;
      s.f = eval_phong(L, wo, wi);
      s.pdf = pdf_phong(L, wo, wi);
      return s;
    }
    case LOBE_MICROFACET_TRANS: {
      F3 wh = sample_wh(mode, L.mf, wo, L.a0, L.a1, u0, u1);
      F eta_s = wo.z > K(0.0) ? L.eta_i / L.eta_t : L.eta_t / L.eta_i;
      bool refr_ok;
      F3 wi = normalize(refract(wo, wh, eta_s, &refr_ok));
      bool ok = dot(wo, wh) >= K(0.0) && refr_ok && fabs_(wo.z) > K(1e-9);
      F3 f = eval_microfacet_trans(L, mode, wo, wi);
      F p = pdf_microfacet_trans(L, mode, wo, wi);
      s.wi = wi;
      s.f = ok ? f : zero3();
      s.pdf = ok ? p : K(0.0);
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

struct LightSample { F3 wi, li, pos; F pdf; };

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
  F3 radiance = ld3(row);
  F two_wr = {row[TABLE_W - 1]};
  if (ls.kind == LIGHT_POINT) {
    F3 lpos = ld3(row + 3);
    F3 delta = lpos - p;
    F d2 = cmin(dot(delta, delta), K(1e-20));
    out.wi = delta / sqrt_(d2);
    out.li = radiance / d2;
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

__device__ F3 texel(const ShadeArgs& a, int tex, int xi, int yi) {
  xi = min(max(xi, 0), a.tex_wh[2 * tex] - 1);
  yi = min(max(yi, 0), a.tex_wh[2 * tex + 1] - 1);
  long long flat = ((long long)tex * a.th + yi) * a.tw + xi;
  return ld3(a.tex_image + flat * 3);
}

// texture.sample at the hit
__device__ F3 tex_sample(const ShadeArgs& a, int tex, F uu, F uv, F3 p) {
  int kind = a.tex_kind[tex];
  F3 c0 = ld3(a.tex_c0 + 3 * tex);
  F3 out = c0;
  if (kind == TEX_CHECKER) {
    F scale = {a.tex_scale[tex]};
    F s = sin_(scale * p.x) * sin_(scale * p.y) * sin_(scale * p.z);
    out = s < K(0.0) ? c0 : ld3(a.tex_c1 + 3 * tex);
  }
  if (a.has_images && (kind == TEX_IMAGE || kind == TEX_IMAGE_BILINEAR)) {
    F x = clamp_(uu, K(0.0), K(1.0));
    F y = clamp_(uv, K(0.0), K(1.0));
    F w = {(float)a.tex_wh[2 * tex]}, h = {(float)a.tex_wh[2 * tex + 1]};
    if (kind == TEX_IMAGE) {
      out = texel(a, tex, (int)(x * w).v, (int)((K(1.0) - y) * h).v);
    } else {
      F fx = x * w - K(0.5);
      F fy = (K(1.0) - y) * h - K(0.5);
      int x0 = (int)floorf(fx.v), y0 = (int)floorf(fy.v);
      F tx = fx - F{(float)x0}, ty = fy - F{(float)y0};
      F3 ta = texel(a, tex, x0, y0), tb = texel(a, tex, x0 + 1, y0);
      F3 tc = texel(a, tex, x0, y0 + 1), td = texel(a, tex, x0 + 1, y0 + 1);
      out = (ta * (K(1.0) - tx) + tb * tx) * (K(1.0) - ty)
            + (tc * (K(1.0) - tx) + td * tx) * ty;
    }
  }
  return out;
}

// One lane's vertex; live and n_useful take its counts (the lane's own
// cast, its useful shadow rays).
__device__ __forceinline__ void shade_lane(const ShadeArgs& a, int i, int& live,
                                           int& n_useful) {
  bool valid = a.valid[i];
  bool active = a.active[i];
  live = active;
  F3 p = ld3(a.pos + 3 * i), n = ld3(a.nrm + 3 * i), wo = ld3(a.wo + 3 * i);
  F3 beta = ld3(a.beta + 3 * i);
  int lid = a.light_id[i];

  // emission (reference: src/integrator.cc:328-337)
  F3 le = ld3(a.le_env);
  if (valid) {
    le = zero3();
    if (a.n_light_rows) {
      int row = min(max(lid, 0), a.n_light_rows - 1);
      F3 radiance = ld3(a.light_c + 3 * row);
      bool facing = dot(n, wo) > K(0.0);
      le = (lid >= 0 && facing) ? radiance : zero3();
    }
  }
  bool gate = a.bounce == 0 ? active : (active && a.prev_specular[i]);
  F3 L = ld3(a.L + 3 * i) + (gate ? beta * le : zero3());
  st3(a.L_out + 3 * i, L);
  if (a.last) return;

  bool cont = active && valid;
  const float* u = a.u + (long long)i * a.u_stride;
  int mat = a.mat_id[i];
  F3 c0 = ld3(a.mat_c0 + 3 * mat);
  if (a.n_tex) {
    int tex = a.mat_tex[mat];
    if (tex >= 0) c0 = tex_sample(a, tex, F{a.uv[2 * i]}, F{a.uv[2 * i + 1]}, p);
  }
  Lobe lobe = make_lobe(a.mat_kind[mat], c0, ld3(a.mat_c1 + 3 * mat), F{a.mat_s0[mat]},
                        F{a.mat_s1[mat]}, a.mat_remap[mat], F{u[0]}, a.mat_mf[mat]);
  bool delta = lobe.kind == LOBE_SPECULAR || lobe.kind == LOBE_FRESNEL;
  Frame frame = frame_from_z(n);
  F3 wo_local = to_local(frame, wo);

  // NEE over the non-black lights (reference: src/integrator.cc:357-372)
  for (int k = 0; k < a.n_nee; ++k) {
    const int32_t* st = a.statics + k * STATIC_W;
    LightStatic ls = {st[0], st[1], st[2], st[3], a.em + (long long)st[4] * EM_W};
    LightSample smp = sample_li(ls, a.table + k * TABLE_W, p, F{u[ls.slot]}, F{u[ls.slot + 1]});
    F3 f = eval_f(lobe, a.lobes, a.mf_mode, wo_local, to_local(frame, smp.wi));
    bool useful = cont && !delta && smp.pdf > K(0.0) && !is_black(smp.li) && !is_black(f);
    F3 contrib = beta * f * smp.li * (fabs_(dot(smp.wi, n)) / cmin(smp.pdf, K(1e-20)));
    long long j = (long long)k * a.n + i;
    a.useful[j] = useful;
    n_useful += useful;
    st3(a.contrib + 3 * j, contrib);
    st3(a.shadow_to + 3 * j, smp.pos);
  }

  // BSDF sampling (reference: src/integrator.cc:375-379)
  int base = a.s - 3;
  BSDFSample bs = sample_bsdf(lobe, a.lobes, a.mf_mode, wo_local, F{u[base]}, F{u[base + 1]});
  F3 wi_world = to_world(frame, bs.wi);
  bool sample_ok = bs.pdf > K(0.0) && !is_black(bs.f);

  // Russian roulette (reference: src/integrator.cc:383-393)
  bool rr_die = false;
  F rr_scale = K(1.0);
  if (a.roulette) {
    F q = cmin(K(1.0) - max_component(bs.f), K(0.05));
    rr_die = F{u[base + 2]} < q;
    rr_scale = rcp(cmin(K(1.0) - q, K(1e-6)));
  }
  bool next = cont && sample_ok && !rr_die;
  F3 weight = bs.f * (fabs_(dot(wi_world, n)) / cmin(bs.pdf, K(1e-20))) * rr_scale;
  st3(a.beta_out + 3 * i, next ? beta * weight : beta);
  a.active_out[i] = next;
  a.spec_out[i] = delta;
  a.pdf_out[i] = bs.pdf.v;
  st3(a.o_out + 3 * i, next ? p : ld3(a.ray_o + 3 * i));
  st3(a.d_out + 3 * i, next ? wi_world : ld3(a.ray_d + 3 * i));
  a.tmin_out[i] = next ? *a.ray_eps : INFINITY;
  a.tmax_out[i] = next ? INFINITY : -1.0f;
}

// The block's counts added to the wave's counters: a sum per warp, per
// block in shared memory, then one atomic add per counter and block.
__device__ __forceinline__ void count_block(const ShadeArgs& a, int live, int n_useful) {
  __shared__ int sums[2];
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;
  __syncthreads();
  const int wl = __reduce_add_sync(0xffffffffu, live);
  const int wu = __reduce_add_sync(0xffffffffu, n_useful);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sums[0], wl);
    atomicAdd(&sums[1], wu);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* c = reinterpret_cast<unsigned long long*>(a.counts);
    const unsigned long long l = sums[0], u = sums[1];
    if (l) atomicAdd(c + (a.bounce == 0 ? 0 : 1), l);
    if (u) atomicAdd(c + 2, u);
    if (l + u) atomicAdd(c + 3, l + u);
  }
}

__global__ void __launch_bounds__(128) shade_vertex_kernel(const __grid_constant__ ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int live = 0, n_useful = 0;
  if (i < a.n) shade_lane(a, i, live, n_useful);
  // every thread of the block comes here: count_block has barriers
  if (a.counts) count_block(a, live, n_useful);
}

__global__ void nee_accumulate_kernel(const float* L, const uint8_t* useful, const uint8_t* occ,
                                      const float* contrib, int n, int lights, float* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  F3 acc = ld3(L + 3 * i);
  for (int k = 0; k < lights; ++k) {
    long long j = (long long)k * n + i;
    bool add = useful[j] && !occ[j];
    acc = acc + (add ? ld3(contrib + 3 * j) : zero3());
  }
  st3(out + 3 * i, acc);
}

}  // namespace

extern "C" {

int shade_args_size() { return (int)sizeof(ShadeArgs); }

int shade_table_width() { return TABLE_W; }

// The measurement variant's per-thread operation counts go to `counts`
// (one per thread of the next launches' grids); 1 where this build does
// not count.
int shade_count_ops(unsigned long long* counts) {
#ifdef SHADE_COUNT_OPS
  return (int)cudaMemcpyToSymbol(g_ops, &counts, sizeof(counts));
#else
  return 1;
#endif
}

int shade_vertex(const ShadeArgs* args, cudaStream_t stream) {
  if (args->n > 0) {
    shade_vertex_kernel<<<(args->n + 127) / 128, 128, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

int nee_accumulate(const float* L, const uint8_t* useful, const uint8_t* occ,
                   const float* contrib, int n, int lights, float* out,
                   cudaStream_t stream) {
  if (n > 0) {
    nee_accumulate_kernel<<<(n + 255) / 256, 256, 0, stream>>>(L, useful, occ, contrib, n,
                                                               lights, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
