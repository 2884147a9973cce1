// The path vertex's backward as two CUDA kernels for sm_90a.
//
// The transpose of one vertex of li_path (ops/shade.py's shade_vertex and
// that bounce's nee_accumulate): the counterpart of the transpose XLA
// fuses under jax.jit(jax.value_and_grad(loss)) of the vertex block of
// jet_pbrt_tpu/models/integrators.py:108-237. The reference has no
// custom_vjp and no Pallas kernel for it; the port's plain version is
// autograd through ops/shade.py's plain vertex (shade.vertex_backward_plain).
//
//   vertex_backward_kernel  one thread per lane, recomputing from the
//       vertex's saved inputs (hit, beta, active, prev_specular, uniforms,
//       the light table and the bounce's occlusion flags) the lane's own
//       lobe, every NEE light's sample, f and mask, the BSDF sample and the
//       roulette with csrc/shade.cuh's code: the values and branches by F,
//       equal to the forward's bit for bit, and each f's derivatives in the
//       lane's material row by D (8 forward-mode tangents: c0 rgb, c1 rgb,
//       s0, s1). It writes the lane's d loss / d beta, the sum of
//         where(active_out, gbeta * weight, gbeta)     (the next beta),
//         gate * gL * le                               (the emission),
//         sum_j [useful_j & ~occ_j] gL * f_j * Li_j |cos_j| / pdf_j,
//       and adds the parameter gradients (the material row's through each
//       unoccluded f_j and the BSDF sample's f; the texture's colour rows
//       or, for an image, the lane's texel taps with the tap's weights; the
//       radiance rows of light_c through the hit emitter's emission and
//       each light's Li, and the environment's summed radiance) into the
//       block's accumulators: per warp, lanes with the same row add in lane
//       order (__match_any_sync, then a butterfly where all lanes share a
//       row), the group's first lane adds the sum into its warp's copy of
//       the accumulators in shared memory, and the block writes the sum of
//       its warps' copies, in warp order, as its row of partial sums. Every
//       sampled quantity is detached, as in the reference: its gradient is
//       0. An image texture's taps go out per lane ([N, 4, 3] and their
//       flat texel rows), for index_add_.
//   grad_reduce_kernel  the partial sums' columns summed over the blocks in
//       block order: with the in-block order fixed by the lanes, every
//       parameter gradient is the same bit for bit from run to run, eager
//       or replayed from a graph, under deterministic algorithms or not.
//
// Bound: bytes for the lane's reads and writes (hit, state, uniforms,
// flags and gradients, about 170 B a lane at the bunny's S = 8 and two
// lights), but the dual arithmetic (9 floats an operation over a lobe's
// whole evaluation, twice or more a light) is what this simple kernel
// spends its time on; making it fast (per-lobe tangent sets, lanes sorted
// by material) is later work.

#include "shade.cuh"

struct GradArgs {
  ShadeArgs a;            // the vertex's inputs as the forward read them
  const float* gL;        // [n,3] d loss / d L after the vertex's NEE
  const float* gbeta;     // [n,3] d loss / d beta after it, or null (0)
  const uint8_t* occ;     // [n_nee, n] the bounce's shadow flags (null: last)
  float* gbeta_in;        // [n,3]
  float* partials;        // [gridDim.x, n_slots]
  float* taps;            // [n,4,3] an image texture's texel gradients, or null
  int64_t* tap_rows;      // [n,4] their flat rows of tex_image
  int n_mat, n_tex_rows, n_slots;
};

namespace {

constexpr int GB = 128;           // threads a block
constexpr int WARPS = GB / 32;
constexpr int MAX_GRID = 1024;    // blocks: each loops over lane tiles
constexpr unsigned FULL = 0xffffffffu;

// Adds the values v of every lane of the warp that holds `key` into
// region[slot[k]] (the same slots for one key), summed in lane order by the
// group's first lane; key -1 adds nothing. Every lane of the warp calls it.
template <int NV>
__device__ __forceinline__ void group_add(float* region, int key, const int (&slot)[NV],
                                          float (&v)[NV]) {
  const unsigned peers = __match_any_sync(FULL, key);
  const int lane = threadIdx.x & 31;
  if (peers == FULL) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      for (int o = 16; o; o >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], o);
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float s = 0.0f;
      for (int src = 0; src < 32; ++src) {
        const float x = __shfl_sync(FULL, v[k], src);
        if ((peers >> src) & 1u) s += x;
      }
      v[k] = s;
    }
  }
  if (key >= 0 && lane == __ffs(peers) - 1)
    for (int k = 0; k < NV; ++k) region[slot[k]] += v[k];
}

__device__ __forceinline__ V3<D> seed3(F3 c, int first) {
  V3<D> r = up3<D>(c);
  r.x.d[first] = 1.0f;
  r.y.d[first + 1] = 1.0f;
  r.z.d[first + 2] = 1.0f;
  return r;
}
__device__ __forceinline__ D seed1(F c, int k) {
  D r(c);
  r.d[k] = 1.0f;
  return r;
}
__device__ __forceinline__ float comp(const F3& a, int c) { return c == 0 ? a.x.v : (c == 1 ? a.y.v : a.z.v); }
__device__ __forceinline__ const D& comp(const V3<D>& a, int c) { return c == 0 ? a.x : (c == 1 ? a.y : a.z); }

// One lane's backward (every lane of the warp comes here, `in` false past
// the end): its d loss / d beta and its parameter gradients added to its
// warp's accumulators `region`.
__device__ void grad_lane(const GradArgs& g, int i, bool in, float* region) {
  const ShadeArgs& a = g.a;
  const int M = g.n_mat, KT = g.n_tex_rows, R = a.n_light_rows;
  const int light_base = 8 * M + 6 * KT, env_base = light_base + 3 * R;

  bool valid = false, active = false, gate = false;
  F3 p = zero3(), n = zero3(), wo = zero3(), beta = zero3(), le = zero3();
  float gL[3] = {0.0f, 0.0f, 0.0f}, gb[3] = {0.0f, 0.0f, 0.0f};
  int ekey = -1, eslot[3];
  float ge[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    valid = a.valid[i];
    active = a.active[i];
    p = ld3(a.pos + 3 * i);
    n = ld3(a.nrm + 3 * i);
    wo = ld3(a.wo + 3 * i);
    beta = ld3(a.beta + 3 * i);
    for (int c = 0; c < 3; ++c) gL[c] = g.gL[3 * i + c];
    if (g.gbeta)
      for (int c = 0; c < 3; ++c) gb[c] = g.gbeta[3 * i + c];
    // emission: le is the hit emitter's row, or the environment's sum
    le = ld3(a.le_env);
    int erow = R;
    if (valid) {
      le = zero3();
      erow = -1;
      if (R) {
        const int lid = a.light_id[i];
        const int row = min(max(lid, 0), R - 1);
        if (lid >= 0 && dot(n, wo) > K(0.0)) {
          le = ld3(a.light_c + 3 * row);
          erow = row;
        }
      }
    }
    gate = a.bounce == 0 ? active : (active && a.prev_specular[i]);
    if (gate && erow >= 0) {
      ekey = erow;
      for (int c = 0; c < 3; ++c) ge[c] = __fmul_rn(gL[c], comp(beta, c));
    }
  }
  for (int c = 0; c < 3; ++c) eslot[c] = (ekey < R ? light_base + 3 * ekey : env_base) + c;
  // d L_out / d beta through the emission: gL * le
  float gbeta_in[3];
  for (int c = 0; c < 3; ++c) gbeta_in[c] = gate ? __fmul_rn(gL[c], comp(le, c)) : 0.0f;

  int mkey = -1, tkey = -1, mslot[8], tslot[3];
  float gm[8] = {0, 0, 0, 0, 0, 0, 0, 0}, gt[3] = {0.0f, 0.0f, 0.0f};
  if (!a.last) {
    const bool cont = in && active && valid;
    float th[NT];
    for (int k = 0; k < NT; ++k) th[k] = 0.0f;
    float gnee[3] = {0.0f, 0.0f, 0.0f};
    LobeT<D> lobe;
    Frame frame;
    F3 wo_local = zero3();
    bool delta = false;
    const float* u = a.u;
    int mat = 0, tex = -1;
    TexTap tap;
    tap.src = 0;
    tap.taps = 0;
    tap.tx = tap.ty = K(0.0);
    if (cont) {
      u = a.u + (long long)i * a.u_stride;
      mat = a.mat_id[i];
      F3 c0 = ld3(a.mat_c0 + 3 * mat);
      if (a.n_tex) {
        tex = a.mat_tex[mat];
        if (tex >= 0) c0 = tex_sample(a, tex, F{a.uv[2 * i]}, F{a.uv[2 * i + 1]}, p, &tap);
      }
      lobe = make_lobe(a.mat_kind[mat], seed3(c0, 0), seed3(ld3(a.mat_c1 + 3 * mat), 3),
                       seed1(F{a.mat_s0[mat]}, 6), seed1(F{a.mat_s1[mat]}, 7),
                       a.mat_remap[mat], F{u[0]}, a.mat_mf[mat]);
      delta = lobe.kind == LOBE_SPECULAR || lobe.kind == LOBE_FRESNEL;
      frame = frame_from_z(n);
      wo_local = to_local(frame, wo);
    }

    // NEE: contrib_j = ((beta * f_j) * li_j) * s_j where unoccluded
    for (int k = 0; k < a.n_nee; ++k) {
      const int32_t* st = a.statics + k * STATIC_W;
      float gr[3] = {0.0f, 0.0f, 0.0f};
      if (cont) {
        LightStatic ls = {st[0], st[1], st[2], st[3], a.em + (long long)st[4] * EM_W};
        LightSample smp = sample_li(ls, a.table + k * TABLE_W, p, F{u[ls.slot]},
                                    F{u[ls.slot + 1]});
        V3<D> f = eval_f(lobe, a.lobes, a.mf_mode, up3<D>(wo_local),
                         up3<D>(to_local(frame, smp.wi)));
        const F3 fv = value3(f);
        const bool useful = !delta && smp.pdf > K(0.0) && !is_black(smp.li) && !is_black(fv);
        if (useful && !g.occ[(long long)k * a.n + i]) {
          const float s = (fabs_(dot(smp.wi, n)) / cmin(smp.pdf, K(1e-20))).v;
          for (int c = 0; c < 3; ++c) {
            const float g1 = gL[c] * s, g2 = g1 * comp(smp.li, c);
            const float gf = g2 * comp(beta, c);
            gnee[c] += g2 * comp(fv, c);
            const float gli = g1 * (comp(beta, c) * comp(fv, c));
            gr[c] = ls.kind == LIGHT_POINT ? gli / smp.d2.v : gli;
            const D& fc = comp(f, c);
            for (int t = 0; t < NT; ++t) th[t] += tm(fc.d[t], gf);
          }
        }
      }
      // light j is row (slot - 1) / 2 of light_c
      int rslot[3];
      for (int c = 0; c < 3; ++c) rslot[c] = light_base + 3 * ((st[2] - 1) / 2) + c;
      group_add(region, k, rslot, gr);
    }

    // the BSDF sample: beta_out = where(next, beta * ((f * s_b) * rr), beta)
    bool next = false;
    float weight[3] = {0.0f, 0.0f, 0.0f};
    if (cont) {
      const int base = a.s - 3;
      BSDFSampleT<D> bs = sample_bsdf(lobe, a.lobes, a.mf_mode, up3<D>(wo_local), F{u[base]},
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
          const D& fc = comp(bs.f, c);
          for (int t = 0; t < NT; ++t) th[t] += tm(fc.d[t], gf);
        }
      }
    }
    for (int c = 0; c < 3; ++c)
      gbeta_in[c] = ((next ? gb[c] * weight[c] : gb[c]) + gbeta_in[c]) + gnee[c];

    // route the lane's c0 gradient to its texture or its material row
    if (cont) {
      mkey = mat;
      for (int c = 0; c < 3; ++c) gm[3 + c] = th[3 + c];
      gm[6] = th[6];
      gm[7] = th[7];
      if (tex < 0) {
        for (int c = 0; c < 3; ++c) gm[c] = th[c];
      } else if (tap.src < 2) {
        tkey = 2 * tex + tap.src;
        for (int c = 0; c < 3; ++c) gt[c] = th[c];
      }
    }
    if (g.taps && in) {
      // the taps' weights as the plain version's backward forms them
      const float tx = tap.tx.v, ty = tap.ty.v;
      const float rx = __fsub_rn(1.0f, tx), ry = __fsub_rn(1.0f, ty);
      for (int k = 0; k < 4; ++k) {
        const bool on = cont && tex >= 0 && tap.src == 2 && k < tap.taps;
        g.tap_rows[4 * (long long)i + k] = on ? tap.rows[k] : 0;
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
          g.taps[12 * (long long)i + 3 * k + c] = v;
        }
      }
    }
  }
  if (in)
    for (int c = 0; c < 3; ++c) g.gbeta_in[3 * i + c] = gbeta_in[c];

  for (int c = 0; c < 3; ++c) {
    mslot[c] = 3 * mkey + c;
    mslot[3 + c] = 3 * M + 3 * mkey + c;
    tslot[c] = 8 * M + (tkey & 1 ? 3 * KT : 0) + 3 * (tkey >> 1) + c;
  }
  mslot[6] = 6 * M + mkey;
  mslot[7] = 7 * M + mkey;
  group_add(region, mkey, mslot, gm);
  group_add(region, tkey, tslot, gt);
  group_add(region, ekey, eslot, ge);
}

__global__ void __launch_bounds__(GB) vertex_backward_kernel(const __grid_constant__ GradArgs g) {
  extern __shared__ float acc[];     // [WARPS][n_slots]
  for (int s = threadIdx.x; s < WARPS * g.n_slots; s += GB) acc[s] = 0.0f;
  __syncthreads();
  float* region = acc + (threadIdx.x >> 5) * g.n_slots;
  // every thread of the block runs every tile: the warps' shuffles need
  // all their lanes
  for (long long base = (long long)blockIdx.x * GB; base < g.a.n;
       base += (long long)gridDim.x * GB) {
    const long long i = base + threadIdx.x;
    grad_lane(g, (int)i, i < g.a.n, region);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < g.n_slots; s += GB) {
    float t = acc[s];
    for (int w = 1; w < WARPS; ++w) t += acc[w * g.n_slots + s];
    g.partials[(long long)blockIdx.x * g.n_slots + s] = t;
  }
}

__global__ void __launch_bounds__(GB) grad_reduce_kernel(const float* partials, int grid,
                                                         int n_slots, float* out) {
  const int s = blockIdx.x * GB + threadIdx.x;
  if (s >= n_slots) return;
  float t = partials[s];
  for (int b = 1; b < grid; ++b) t += partials[(long long)b * n_slots + s];
  out[s] = t;
}

}  // namespace

extern "C" {

int shade_grad_args_size() { return (int)sizeof(GradArgs); }

// The backward's grid for n lanes: one block a tile of GB lanes, at most
// MAX_GRID blocks (each then loops over tiles); the partial sums have as
// many rows.
int vertex_backward_grid(int n) {
  const int tiles = (n + GB - 1) / GB;
  return tiles < MAX_GRID ? (tiles > 0 ? tiles : 1) : MAX_GRID;
}

// Bytes of shared memory a block takes for n_slots accumulators (one copy
// a warp).
int vertex_backward_smem(int n_slots) { return WARPS * n_slots * (int)sizeof(float); }

int vertex_backward(const GradArgs* g, cudaStream_t stream) {
  const int smem = vertex_backward_smem(g->n_slots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vertex_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  vertex_backward_kernel<<<vertex_backward_grid(g->a.n), GB, smem, stream>>>(*g);
  return (int)cudaGetLastError();
}

int grad_reduce(const float* partials, int grid, int n_slots, float* out, cudaStream_t stream) {
  if (n_slots > 0)
    grad_reduce_kernel<<<(n_slots + GB - 1) / GB, GB, 0, stream>>>(partials, grid, n_slots, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
