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
// The shading math (the F type, lobes, lights, textures, ShadeArgs) is
// csrc/shade.cuh's, shared with csrc/shade_grad.cu's backward.
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

#include "shade.cuh"

namespace {

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
