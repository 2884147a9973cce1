// The path vertex's backward as CUDA kernels for sm_90a.
//
// The transpose of one vertex of li_path (ops/shade.py's shade_vertex and
// that bounce's nee_accumulate): the counterpart of the transpose XLA
// fuses under jax.jit(jax.value_and_grad(loss)) of the vertex block of
// jet_pbrt_tpu/models/integrators.py:108-237. The reference has no
// custom_vjp and no Pallas kernel for it; the port's plain version is
// autograd through ops/shade.py's plain vertex (shade.vertex_backward_plain).
//
//   vertex_backward_kernel<S>  one launch per tangent set S the scene's
//       materials need (ops/shade.py::backward_sets). A lane's f depends
//       only on the parameters of its material kind (ops/shade.py's
//       TANGENTS); set S carries N_S tangents: 0 c0 (matte, mirror), 1 c0
//       and s0 (phong), 2 all eight (glass, plastic, metal, rough glass),
//       and each set is its own kernel, so the matte lanes of a scene pay
//       for 3 tangents and the registers of their own path. A block owns
//       spans of SPAN lanes. It lists in shared memory the span's lanes
//       that continue (active, valid, below max_depth) and whose kind is in
//       S, grouped by the lobe code they run (cheap lobes, microfacet
//       reflection, microfacet transmission) and in lane order within a
//       group, and its warps then run full of such lanes: each
//       recomputes from the vertex's saved inputs (hit, beta, active,
//       prev_specular, uniforms, the light table and the bounce's occlusion
//       flags) its own lobe, every NEE light's sample, f and mask, the BSDF
//       sample and the roulette with csrc/shade.cuh's code, the values and
//       branches by F, equal to the forward's bit for bit, and each f's
//       derivatives by D<N_S> (a light's f by D only where it adds: useful
//       and unoccluded, which its F value decides). It writes the lane's
//       d loss / d beta, the sum of
//         where(active_out, gbeta * weight, gbeta)     (the next beta),
//         gate * gL * le                               (the emission),
//         sum_j [useful_j & ~occ_j] gL * f_j * Li_j |cos_j| / pdf_j,
//       and adds its parameter gradients (the material row's through each
//       unoccluded f_j and the BSDF sample's f; the texture's colour rows
//       or, for an image, the lane's texel taps with the tap's weights; the
//       radiance rows of light_c through each light's Li). The first
//       launch of a vertex also covers every lane's cheap part: the
//       emission's gradient (light_c's hit emitter row, or the
//       environment's summed radiance), and d loss / d beta and the zero
//       texel taps of the lanes that do not continue. Sums: per warp, for
//       each distinct row the warp's lanes hold, a butterfly over the
//       lanes of that row (the others add 0), whose first lane adds the
//       sum into its warp's accumulators; the block then writes the sum
//       of its warps' copies, in warp order, as its row of partial sums
//       (a later launch adds into the row the first wrote). Where a
//       block's four copies do not fit in SMEM_ACC bytes of shared memory
//       (more than 2,560 parameter slots), each warp accumulates into its
//       own row of the partial sums in device memory instead: no cap on
//       the slots. Every sampled quantity is detached, as in the
//       reference: its gradient is 0. An image texture's taps go out per
//       lane ([N, 4, 3] and their flat texel rows), for index_add_.
//   grad_reduce_kernel  the partial sums' columns summed over the rows in a
//       fixed order: CHAINS chains, chain c summing rows c, c + CHAINS, ...
//       in order (a row past the end adds 0), then a pairwise tree over
//       the chains (chain c plus chain c + h, h = CHAINS / 2 down to 1),
//       the order ops/shade.py::grad_reduce_plain takes too. With the
//       in-block order fixed by the lane list, every parameter gradient
//       is the same bit for bit from run to run, eager or replayed from a
//       graph, under deterministic algorithms or not.
//
// Bound: bytes for the lane's reads and writes (hit, state, uniforms,
// flags and gradients, about 170 B a lane at the bunny's S = 8 and two
// lights); the dual arithmetic over a lobe's whole evaluation, once a
// light that adds and once for the BSDF sample, is what the kernel spends
// its time on: the tangent sets cut it for the kinds that need fewer
// tangents, the buckets keep a warp on one lobe's code, and the kernels
// run at three blocks an SM (set 2, 168 registers) or four (sets 0 and 1,
// 128), spilling, which measured faster than fewer blocks without
// (PERF.md).

#include "shade.cuh"

struct GradArgs {
  ShadeArgs a;            // the vertex's inputs as the forward read them
  const float* gL;        // [n,3] d loss / d L after the vertex's NEE
  const float* gbeta;     // [n,3] d loss / d beta after it, or null (0)
  const uint8_t* occ;     // [n_nee, n] the bounce's shadow flags (null: last)
  float* gbeta_in;        // [n,3]
  float* partials;        // [vertex_backward_rows, n_slots]
  float* taps;            // [n,4,3] an image texture's texel gradients, or null
  int64_t* tap_rows;      // [n,4] their flat rows of tex_image
  int n_mat, n_tex_rows, n_slots;
  int first;              // the vertex's first launch (set by vertex_backward)
  int device_acc;         // accumulators in partials' warp rows (likewise)
};

namespace {

constexpr int GB = 128;           // threads a block
constexpr int WARPS = GB / 32;
constexpr int SPAN = 1024;        // lanes a block lists at a time
constexpr int MAX_GRID = 1024;    // blocks: each loops over spans
constexpr int SMEM_ACC = 40 * 1024;            // the warps' accumulators
constexpr long long DEVICE_ACC = 16 << 20;     // floats of partials, device path
constexpr int CHAINS = 64;        // grad_reduce's chains
constexpr int RX = 8;             // grad_reduce's slots a block
constexpr unsigned FULL = 0xffffffffu;

// The tangent sets: set S carries tangents of the material parameters
// (0-2 c0 rgb, 3-5 c1 rgb, 6 s0, 7 s1) param<S>(0 .. N_S - 1).
constexpr int N_SETS = 3;
template <int S> __host__ __device__ constexpr int n_tangents() { return S == 0 ? 3 : (S == 1 ? 4 : 8); }
__host__ __device__ constexpr int param_of(int set, int t) {
  return set == 1 && t == 3 ? 6 : t;
}
// the tangent of parameter p in set S, or -1
template <int S> __device__ constexpr int tangent_of(int p) {
  return S == 2 ? p : (p < 3 ? p : (S == 1 && p == 6 ? 3 : -1));
}
// a material kind's set: the smallest that holds ops/shade.py's TANGENTS row
__host__ __device__ constexpr int set_of(int kind) {
  return kind == MAT_MATTE || kind == MAT_MIRROR ? 0 : (kind == MAT_PHONG ? 1 : 2);
}

// Adds the values v of every lane of the warp that holds `key` into
// region[slot[k]] (the same slots for one key), key -1 adding nothing:
// for each distinct key, the lowest lane holding it first, a butterfly
// over the warp in which the other lanes add 0, and that lane adds the
// sum. Every lane of the warp calls it.
template <int NV>
__device__ __forceinline__ void group_add(float* region, int key, const int (&slot)[NV],
                                          const float (&v)[NV]) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(FULL, key >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int k = __shfl_sync(FULL, key, leader);
    const unsigned peers = __ballot_sync(FULL, key == k);
    float s[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float x = key == k ? v[j] : 0.0f;
#pragma unroll
      for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
      s[j] = x;
    }
    if (lane == leader)
#pragma unroll
      for (int j = 0; j < NV; ++j) region[slot[j]] += s[j];
    todo &= ~peers;
  }
  __syncwarp();
}

template <int N> __device__ __forceinline__ V3<D<N>> seed3(F3 c, int first) {
  V3<D<N>> r = up3<D<N>>(c);
  if (first >= 0) {
    r.x.d[first] = 1.0f;
    r.y.d[first + 1] = 1.0f;
    r.z.d[first + 2] = 1.0f;
  }
  return r;
}
template <int N> __device__ __forceinline__ D<N> seed1(F c, int k) {
  D<N> r(c);
  if (k >= 0) r.d[k] = 1.0f;
  return r;
}
__device__ __forceinline__ float comp(const F3& a, int c) { return c == 0 ? a.x.v : (c == 1 ? a.y.v : a.z.v); }
template <int N> __device__ __forceinline__ const D<N>& comp(const V3<D<N>>& a, int c) {
  return c == 0 ? a.x : (c == 1 ? a.y : a.z);
}

// The emission: gate, and le, the hit emitter's row of light_c or the
// environment's summed radiance; erow its row (n_light_rows for the
// environment, -1 for none).
struct Emission {
  bool gate;
  F3 le;
  int erow;
};

__device__ __forceinline__ Emission emission(const ShadeArgs& a, int i, bool valid, bool active,
                                             F3 n, F3 wo) {
  const int R = a.n_light_rows;
  Emission e;
  e.le = ld3(a.le_env);
  e.erow = R;
  if (valid) {
    e.le = zero3();
    e.erow = -1;
    if (R) {
      const int lid = a.light_id[i];
      const int row = min(max(lid, 0), R - 1);
      if (lid >= 0 && dot(n, wo) > K(0.0)) {
        e.le = ld3(a.light_c + 3 * row);
        e.erow = row;
      }
    }
  }
  e.gate = a.bounce == 0 ? active : (active && a.prev_specular[i]);
  return e;
}

// Whether lane i continues below max_depth (so one set's launch computes
// its lobe)
__device__ __forceinline__ bool continues(const ShadeArgs& a, long long i) {
  return !a.last && a.active[i] && a.valid[i];
}

// The list's buckets, in order: lanes whose lobe is cheap (Lambert,
// specular, Fresnel, Phong), microfacet reflection, microfacet
// transmission. A warp then runs one lobe's code. The bucket only orders
// the list: a textured plastic, whose lobe depends on its texel, goes to
// the microfacet bucket whatever its lobe.
constexpr int BUCKETS = 3;
__device__ __forceinline__ int bucket(const ShadeArgs& a, long long i, int mat, int kind) {
  if (kind == MAT_METAL) return 1;
  if (kind == MAT_ROUGHGLASS) return F{a.u[i * a.u_stride]} < K(0.5) ? 1 : 2;
  if (kind != MAT_PLASTIC || (a.n_tex && a.mat_tex[mat] >= 0)) return kind == MAT_PLASTIC;
  // make_lobe's choice of the diffuse lobe
  const F ld = luminance(ld3(a.mat_c0 + 3 * mat)), ls = luminance(ld3(a.mat_c1 + 3 * mat));
  return F{a.u[i * a.u_stride]} < ld / cmin(ld + ls, K(1e-12)) ? 0 : 1;
}

// The cheap part of lane i (every lane of the warp comes here, `in` false
// past the end), in the vertex's first launch: the emission's gradient
// gL * beta added to its light_c row (or the environment's slots) and,
// where the lane does not continue, its d loss / d beta and zero taps.
__device__ void rest_lane(const GradArgs& g, long long i, bool in, float* region) {
  const ShadeArgs& a = g.a;
  const int R = a.n_light_rows;
  const int light_base = 8 * g.n_mat + 6 * g.n_tex_rows, env_base = light_base + 3 * R;
  int ekey = -1, eslot[3];
  float ge[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    const bool valid = a.valid[i], active = a.active[i];
    const Emission e = emission(a, (int)i, valid, active, ld3(a.nrm + 3 * i),
                                ld3(a.wo + 3 * i));
    const F3 beta = ld3(a.beta + 3 * i);
    float gL[3];
    for (int c = 0; c < 3; ++c) gL[c] = g.gL[3 * i + c];
    if (e.gate && e.erow >= 0) {
      ekey = e.erow;
      for (int c = 0; c < 3; ++c) ge[c] = __fmul_rn(gL[c], comp(beta, c));
    }
    if (!(active && valid && !a.last)) {
      // d L_out / d beta through the emission, then (below max_depth) the
      // unsampled next beta's gb: ((gb + gL * le) + 0), as a continuing
      // lane's sum with no sample and no NEE term
      float gbeta_in[3];
      for (int c = 0; c < 3; ++c) gbeta_in[c] = e.gate ? __fmul_rn(gL[c], comp(e.le, c)) : 0.0f;
      if (!a.last) {
        const float gnee = 0.0f;
        for (int c = 0; c < 3; ++c) {
          const float gb = g.gbeta ? g.gbeta[3 * i + c] : 0.0f;
          gbeta_in[c] = (gb + gbeta_in[c]) + gnee;
        }
        if (g.taps)
          for (int k = 0; k < 4; ++k) {
            g.tap_rows[4 * i + k] = 0;
            for (int c = 0; c < 3; ++c) g.taps[12 * i + 3 * k + c] = 0.0f;
          }
      }
      for (int c = 0; c < 3; ++c) g.gbeta_in[3 * i + c] = gbeta_in[c];
    }
  }
  for (int c = 0; c < 3; ++c) eslot[c] = (ekey < R ? light_base + 3 * ekey : env_base) + c;
  group_add(region, ekey, eslot, ge);
}

// One continuing lane's lobe part in set S (every lane of the warp comes
// here, `in` false past the list's end): its d loss / d beta and its
// parameter gradients added to its warp's accumulators `region`.
template <int S>
__device__ __forceinline__ void lobe_lane(const GradArgs& g, long long i, bool in,
                                          float* region) {
  constexpr int N = n_tangents<S>();
  using T = D<N>;
  const ShadeArgs& a = g.a;
  const int M = g.n_mat, KT = g.n_tex_rows;
  const int light_base = 8 * M + 6 * KT;

  F3 p = zero3(), n = zero3(), beta = zero3();
  float gL[3] = {0.0f, 0.0f, 0.0f}, gb[3] = {0.0f, 0.0f, 0.0f}, gbeta_in[3];
  float th[N];
  for (int k = 0; k < N; ++k) th[k] = 0.0f;
  float gnee[3] = {0.0f, 0.0f, 0.0f};
  LobeT<T> lobe;
  Lobe lobe_v;  // its values: which lights add is decided on them
  Frame frame;
  F3 wo_local = zero3();
  bool delta = false;
  const float* u = a.u;
  int mat = 0, tex = -1;
  TexTap tap;
  tap.src = 0;
  tap.taps = 0;
  tap.tx = tap.ty = K(0.0);
  if (in) {
    p = ld3(a.pos + 3 * i);
    n = ld3(a.nrm + 3 * i);
    const F3 wo = ld3(a.wo + 3 * i);
    beta = ld3(a.beta + 3 * i);
    for (int c = 0; c < 3; ++c) gL[c] = g.gL[3 * i + c];
    if (g.gbeta)
      for (int c = 0; c < 3; ++c) gb[c] = g.gbeta[3 * i + c];
    const Emission e = emission(a, (int)i, true, true, n, wo);
    for (int c = 0; c < 3; ++c) gbeta_in[c] = e.gate ? __fmul_rn(gL[c], comp(e.le, c)) : 0.0f;
    u = a.u + i * a.u_stride;
    mat = a.mat_id[i];
    F3 c0 = ld3(a.mat_c0 + 3 * mat);
    if (a.n_tex) {
      tex = a.mat_tex[mat];
      if (tex >= 0) c0 = tex_sample(a, tex, F{a.uv[2 * i]}, F{a.uv[2 * i + 1]}, p, &tap);
    }
    const F3 c1 = ld3(a.mat_c1 + 3 * mat);
    const F s0 = {a.mat_s0[mat]}, s1 = {a.mat_s1[mat]};
    lobe = make_lobe(a.mat_kind[mat], seed3<N>(c0, tangent_of<S>(0)),
                     seed3<N>(c1, tangent_of<S>(3)), seed1<N>(s0, tangent_of<S>(6)),
                     seed1<N>(s1, tangent_of<S>(7)), a.mat_remap[mat], F{u[0]}, a.mat_mf[mat]);
    lobe_v = make_lobe(a.mat_kind[mat], c0, c1, s0, s1, a.mat_remap[mat], F{u[0]}, a.mat_mf[mat]);
    delta = lobe.kind == LOBE_SPECULAR || lobe.kind == LOBE_FRESNEL;
    frame = frame_from_z(n);
    wo_local = to_local(frame, wo);
  }

  // NEE: contrib_j = ((beta * f_j) * li_j) * s_j where unoccluded
  for (int k = 0; k < a.n_nee; ++k) {
    const int32_t* st = a.statics + k * STATIC_W;
    float gr[3] = {0.0f, 0.0f, 0.0f};
    if (in) {
      LightStatic ls = {st[0], st[1], st[2], st[3], a.em + (long long)st[4] * EM_W};
      LightSample smp = sample_li(ls, a.table + k * TABLE_W, p, F{u[ls.slot]},
                                  F{u[ls.slot + 1]});
      const F3 wi_local = to_local(frame, smp.wi);
      // the light adds where useful and unoccluded: decided on the values
      // (eval_f by F, as the forward), then f's tangents by D
      const bool adds = !delta && smp.pdf > K(0.0) && !is_black(smp.li)
                        && !g.occ[(long long)k * a.n + i]
                        && !is_black(eval_f(lobe_v, a.lobes, a.mf_mode, wo_local, wi_local));
      if (adds) {
        V3<T> f = eval_f(lobe, a.lobes, a.mf_mode, up3<T>(wo_local), up3<T>(wi_local));
        const F3 fv = value3(f);
        const float s = (fabs_(dot(smp.wi, n)) / cmin(smp.pdf, K(1e-20))).v;
        for (int c = 0; c < 3; ++c) {
          const float g1 = gL[c] * s, g2 = g1 * comp(smp.li, c);
          const float gf = g2 * comp(beta, c);
          gnee[c] += g2 * comp(fv, c);
          const float gli = g1 * (comp(beta, c) * comp(fv, c));
          gr[c] = ls.kind == LIGHT_POINT ? gli / smp.d2.v : gli;
          const T& fc = comp(f, c);
          for (int t = 0; t < N; ++t) th[t] += tm(fc.d[t], gf);
        }
      }
    }
    // light j is row (slot - 1) / 2 of light_c
    int rslot[3];
    for (int c = 0; c < 3; ++c) rslot[c] = light_base + 3 * ((st[2] - 1) / 2) + c;
    group_add(region, in ? k : -1, rslot, gr);
  }

  // the BSDF sample: beta_out = where(next, beta * ((f * s_b) * rr), beta)
  bool next = false;
  float weight[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    const int base = a.s - 3;
    BSDFSampleT<T> bs = sample_bsdf(lobe, a.lobes, a.mf_mode, up3<T>(wo_local), F{u[base]},
                                    F{u[base + 1]});
    const F3 fv = value3(bs.f);
    const F pdf = {bs.pdf.v};
    const F3 wi_world = to_world(frame, value3(bs.wi));
    const bool sample_ok = pdf > K(0.0) && !is_black(fv);
    bool rr_die = false;
    F rr_scale = K(1.0);
    if (a.roulette) {
      F q = cmin(K(1.0) - max_component(fv), K(0.05));
      rr_die = F{u[base + 2]} < q;
      rr_scale = rcp(cmin(K(1.0) - q, K(1e-6)));
    }
    next = sample_ok && !rr_die;
    if (next) {
      const F sb = fabs_(dot(wi_world, n)) / cmin(pdf, K(1e-20));
      const F3 w = fv * sb * rr_scale;
      for (int c = 0; c < 3; ++c) {
        weight[c] = comp(w, c);
        const float gf = (gb[c] * comp(beta, c)) * rr_scale.v * sb.v;
        const T& fc = comp(bs.f, c);
        for (int t = 0; t < N; ++t) th[t] += tm(fc.d[t], gf);
      }
    }
    for (int c = 0; c < 3; ++c)
      g.gbeta_in[3 * i + c] = ((next ? gb[c] * weight[c] : gb[c]) + gbeta_in[c]) + gnee[c];
  }

  // route the lane's c0 gradient to its texture or its material row: the
  // material adds its set's tangents (c0's zero where a texture takes it;
  // in set 0, which carries c0 alone, none), the texture a colour row
  const bool textured = tex >= 0;
  int mkey = in && !(S == 0 && textured) ? mat : -1;
  int tkey = in && textured && tap.src < 2 ? 2 * tex + tap.src : -1;
  int mslot[N], tslot[3];
  float gm[N], gt[3];
  for (int t = 0; t < N; ++t) {
    const int q = param_of(S, t);
    mslot[t] = q < 6 ? 3 * M * (q / 3) + 3 * mkey + q % 3 : q * M + mkey;
    gm[t] = q < 3 && textured ? 0.0f : th[t];
  }
  for (int c = 0; c < 3; ++c) {
    tslot[c] = 8 * M + (tkey & 1 ? 3 * KT : 0) + 3 * (tkey >> 1) + c;
    gt[c] = th[c];
  }
  if (g.taps && in) {
    // the taps' weights as the plain version's backward forms them
    const float tx = tap.tx.v, ty = tap.ty.v;
    const float rx = __fsub_rn(1.0f, tx), ry = __fsub_rn(1.0f, ty);
    for (int k = 0; k < 4; ++k) {
      const bool on = textured && tap.src == 2 && k < tap.taps;
      g.tap_rows[4 * i + k] = on ? tap.rows[k] : 0;
      for (int c = 0; c < 3; ++c) {
        float v = 0.0f;
        if (on) {
          if (tap.taps == 1) {
            v = th[c];
          } else {
            const float gy = th[c] * (k < 2 ? ry : ty);
            v = gy * ((k & 1) ? tx : rx);
          }
        }
        g.taps[12 * i + 3 * k + c] = v;
      }
    }
  }
  group_add(region, mkey, mslot, gm);
  group_add(region, tkey, tslot, gt);
}

constexpr int CHUNKS = SPAN / GB;
constexpr int ENTRIES = BUCKETS * CHUNKS * WARPS;
constexpr int PER = (ENTRIES + 31) / 32;

template <int S>
__global__ void __launch_bounds__(GB, S == 2 ? 3 : 4)
    vertex_backward_kernel(const __grid_constant__ GradArgs g) {
  extern __shared__ float acc[];     // [WARPS][n_slots], unless device_acc
  __shared__ int list[SPAN];
  __shared__ int offs[ENTRIES];      // [BUCKETS][CHUNKS][WARPS]
  __shared__ int total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = g.a.n;
  float* region;
  if (g.device_acc) {
    region = g.partials + ((long long)blockIdx.x * WARPS + warp) * g.n_slots;
    if (g.first)
      for (int s = lane; s < g.n_slots; s += 32) region[s] = 0.0f;
    __syncwarp();
  } else {
    for (int s = threadIdx.x; s < WARPS * g.n_slots; s += GB) acc[s] = 0.0f;
    __syncthreads();
    region = acc + warp * g.n_slots;
  }
  for (long long base = (long long)blockIdx.x * SPAN; base < n;
       base += (long long)gridDim.x * SPAN) {
    // list the span's continuing lanes of set S by bucket, in lane order
    // within one (and, in the first launch, do every lane's cheap part):
    // count each warp's lanes of each bucket in each chunk of GB lanes,
    // scan the counts, then place the lanes. The thread's lanes' buckets
    // are kept two bits a chunk in `held` (0: not listed, else bucket + 1)
    unsigned held = 0;
    for (int k = 0; k < CHUNKS; ++k) {
      const long long i = base + k * GB + threadIdx.x;
      const bool in = i < n;
      int b = -1;
      if (in && continues(g.a, i)) {
        const int mat = g.a.mat_id[i], kind = g.a.mat_kind[mat];
        if (set_of(kind) == S) b = S == 2 ? bucket(g.a, i, mat, kind) : 0;
      }
      held |= (unsigned)(b + 1) << (2 * k);
      if (g.first) rest_lane(g, i, in, region);
#pragma unroll
      for (int c = 0; c < BUCKETS; ++c) {
        const unsigned ballot = __ballot_sync(FULL, b == c);
        if (lane == 0) offs[(c * CHUNKS + k) * WARPS + warp] = __popc(ballot);
      }
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the counts, PER entries a lane
      int v[PER], t = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = lane * PER + j;
        v[j] = e < ENTRIES ? offs[e] : 0;
        t += v[j];
      }
      int incl = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += x;
      }
      int at = incl - t;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = lane * PER + j;
        if (e < ENTRIES) offs[e] = at;
        at += v[j];
      }
      if (lane == 31) total = incl;
    }
    __syncthreads();
    for (int k = 0; k < CHUNKS; ++k) {
      const int b = (int)((held >> (2 * k)) & 3u) - 1;
#pragma unroll
      for (int c = 0; c < BUCKETS; ++c) {
        const unsigned ballot = __ballot_sync(FULL, b == c);
        if (b == c)
          list[offs[(c * CHUNKS + k) * WARPS + warp] + __popc(ballot & ((1u << lane) - 1u))] =
              k * GB + threadIdx.x;
      }
    }
    __syncthreads();
    const int count = total;
    // the listed lanes, GB at a time; a warp past the list's end skips
    for (int r = 0; r < count; r += GB) {
      if (r + 32 * warp < count) {
        const int j = r + threadIdx.x;
        lobe_lane<S>(g, j < count ? base + list[j] : 0, j < count, region);
      }
    }
    __syncthreads();
  }
  if (!g.device_acc) {
    __syncthreads();
    float* row = g.partials + (long long)blockIdx.x * g.n_slots;
    for (int s = threadIdx.x; s < g.n_slots; s += GB) {
      float t = acc[s];
      for (int w = 1; w < WARPS; ++w) t += acc[w * g.n_slots + s];
      row[s] = g.first ? t : row[s] + t;
    }
  }
}

// out[s] = the column s of partials [rows, n_slots] summed in CHAINS
// chains, then a pairwise tree over the chains; a block covers RX slots
// (threadIdx.x) and every chain (threadIdx.y)
__global__ void __launch_bounds__(RX * CHAINS) grad_reduce_kernel(const float* partials, int rows,
                                                                  int n_slots, float* out) {
  __shared__ float part[CHAINS][RX];
  const int x = threadIdx.x, c = threadIdx.y;
  const int s = blockIdx.x * RX + x;
  float t = 0.0f;
  if (s < n_slots) {
    const int per = (rows + CHAINS - 1) / CHAINS;
    t = c < rows ? partials[(long long)c * n_slots + s] : 0.0f;
#pragma unroll 4
    for (int r = 1; r < per; ++r) {
      const int b = c + r * CHAINS;
      t += b < rows ? partials[(long long)b * n_slots + s] : 0.0f;
    }
  }
  part[c][x] = t;
  __syncthreads();
#pragma unroll
  for (int h = CHAINS / 2; h; h >>= 1) {
    if (c < h) part[c][x] = part[c][x] + part[c + h][x];
    __syncthreads();
  }
  if (c == 0 && s < n_slots) out[s] = part[0][x];
}

bool device_acc(int n_slots) { return (long long)WARPS * n_slots * 4 > SMEM_ACC; }

int grid_of(int n, int n_slots) {
  int grid = (n + SPAN - 1) / SPAN;
  grid = grid < 1 ? 1 : (grid > MAX_GRID ? MAX_GRID : grid);
  if (device_acc(n_slots)) {
    const long long most = DEVICE_ACC / ((long long)WARPS * n_slots);
    grid = (int)(grid < most ? grid : (most > 1 ? most : 1));
  }
  return grid;
}

template <int S> int launch(const GradArgs& g, int grid, cudaStream_t stream) {
  const int smem = g.device_acc ? 0 : WARPS * g.n_slots * (int)sizeof(float);
  vertex_backward_kernel<S><<<grid, GB, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int shade_grad_args_size() { return (int)sizeof(GradArgs); }

// The tangent sets: the count, a material kind's set, and set s's
// parameters (of 0-2 c0 rgb, 3-5 c1 rgb, 6 s0, 7 s1) into params[8],
// returning how many
int vertex_backward_sets() { return N_SETS; }
int vertex_backward_set_of(int kind) { return set_of(kind); }
int vertex_backward_set_params(int set, int* params) {
  const int n = set == 0 ? n_tangents<0>() : (set == 1 ? n_tangents<1>() : n_tangents<2>());
  for (int t = 0; t < n; ++t) params[t] = param_of(set, t);
  return n;
}

// The rows of partial sums the backward of n lanes with n_slots parameter
// slots writes: one a block, or one a warp where the accumulators live in
// device memory (then at most DEVICE_ACC floats in all)
int vertex_backward_rows(int n, int n_slots) {
  return grid_of(n, n_slots) * (device_acc(n_slots) ? WARPS : 1);
}

// One launch of set `set`'s kernel; `first` for the vertex's first
int vertex_backward(const GradArgs* args, int set, int first, cudaStream_t stream) {
  GradArgs g = *args;
  g.first = first;
  g.device_acc = device_acc(g.n_slots);
  const int grid = grid_of(g.a.n, g.n_slots);
  switch (set) {
    case 0: return launch<0>(g, grid, stream);
    case 1: return launch<1>(g, grid, stream);
    case 2: return launch<2>(g, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int grad_reduce(const float* partials, int rows, int n_slots, float* out, cudaStream_t stream) {
  if (n_slots > 0)
    grad_reduce_kernel<<<(n_slots + RX - 1) / RX, dim3(RX, CHAINS), 0, stream>>>(
        partials, rows, n_slots, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
