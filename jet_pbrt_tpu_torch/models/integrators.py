"""The path integrator as one batched wave.

PyTorch counterpart of jet_pbrt_tpu/models/integrators.py::li_path
(reference: src/integrator.cc:316-403): a wave of paths advances in
lockstep through an unrolled bounce loop with per-lane active masks.
Emission counts at bounce 0 and after specular bounces; NEE samples every
non-black light at non-delta vertices; Russian roulette from bounce 3 uses
the sampled f. With sort_rays (default: on whenever a mesh goes through a
traversal kernel, as in the reference), lanes are permuted between the
first bounces so the sweep kernel's 128-ray packets are dense and coherent
(ops/sort.py); every per-lane quantity, the lane's random stream included,
travels with its lane, so the estimate does not change. mis=True adds the
power-heuristic MIS the reference package defines (its BSDF-sampled
emitter hits weighted against `pdf_li`, its NEE weighted against the BSDF
pdf). `li_whitted` and `li_debug_normal` are the reference package's other
two integrators (integrators.py:300-381).

Each path vertex between two closest-hit casts (emission, material, lobe,
NEE set-up, BSDF sample, roulette) is ops/shade.py's: `shade_vertex` and
`nee_accumulate`, one fused kernel launch each on the card, where
`shade.kernel_route` allows (NEE on, MIS off, no gradient outside the
appearance fields shade.GRAD_FIELDS), and their plain versions otherwise.
The casts, the shadow tests and the sort stay here, each inside a
profiler span (utils/log.py::span: li_path.intersect, .rng, .vertex,
.occluded, .nee_accumulate, .sort) that a profile attributes the wave's
device time by; the work around the casts (the hit reconstruction, the shadow
segments, their sort key and merge, the sort key between bounces) is
ops/rays.py's, one kernel launch each on the card. On the vertex kernels'
route the state between the casts is ops/wave.py's WaveState: the camera
kernel makes it (models/render.py::wave_fn), shade_vertex writes the next
cast's bounds and adds to the ray counters, the casts write their rows in
place into slabs (scene/pack.py::_kind_hits), one permute_state launch
moves every row at a sort and unsort_guard scatters the colours back to
their lanes; the other routes keep the torch glue (`_li_path_plain`).

Gradients (models/render.py::render_fn): sampled directions, pdfs, light
sample points, MIS weights and the roulette probability are detached where
the reference package stops their gradients, so the estimate is
differentiable through f, Li and emission alone and no traversal input
carries a gradient. On the kernel route each vertex with its shadow casts
and NEE is one autograd Function (ops/shade.py::vertex, its backward
csrc/shade_grad.cu's kernels on the card) and the permutes and the
un-sort are ops/wave.py's Functions, so a gradient's forward runs the
fused wave and its backward a few launches a vertex; the plain route
(_li_path_plain) is differentiated by autograd op by op.
"""
from __future__ import annotations

import torch

from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops import rng
from ..ops import shade as shade_ops
from ..ops import rays as rays_ops
from ..ops import wave as wave_ops
from ..ops.linalg import absdot, frame_from_z, to_local, to_world, is_black
from ..scene import pack as scene_pack
from ..utils.log import span


def _permute(u, perm):
    """LaneKeys (both key words and the sample index) or uniforms [N, ...]
    reordered by perm."""
    if isinstance(u, rng.LaneKeys):
        return rng.LaneKeys(*(x[perm] for x in u))
    return u[perm]


def li_path(meta, pack, o, d, u, max_depth: int, mis: bool = False,
            nee: bool = True, with_stats: bool = False,
            sort_rays: bool | None = None,
            init: wave_ops.WaveState | None = None):
    """Path-traced radiance L [N,3] of rays o, d [N,3].

    u is `rng.LaneKeys` or pregenerated uniforms [N, max_depth+1, S].
    mis=True weights BSDF-sampled emitter hits after non-specular bounces
    and the NEE of non-delta lights by the power heuristic
    (reference package integrators.py:118-136, 182-196). nee=False
    credits emission at every bounce instead (the plain BSDF estimator of
    the same integral). with_stats also returns the casts the
    estimator needs, by class: closest-hit casts on live lanes (primary,
    bounce) and shadow casts with a non-zero potential contribution, and,
    for sweep-routed meshes, the sweep kernel's counters (pack._sweep).
    sort_rays permutes lanes after bounces 0-2 (default meta.kernel_routed,
    as in the reference); shadow batches of bounces 0-1 of kernel-routed
    scenes are sorted inside `occluded` either way. init: the state before
    the first cast (ops/wave.py::WaveState, as camera_rays makes it with o
    and d as its rays), else made here."""
    if sort_rays is None:
        sort_rays = meta.kernel_routed
    fused = shade_ops.kernel_route(meta, pack, o, d, nee=nee, mis=mis)
    if fused:
        if init is None:
            init = wave_ops.initial_state_plain(o, d, pack.ray_eps)
        return _li_path_kernels(meta, pack, u, max_depth, with_stats,
                                sort_rays, init)
    return _li_path_plain(meta, pack, o, d, u, max_depth, mis, nee,
                          with_stats, sort_rays, fused)


def _li_path_plain(meta, pack, o, d, u, max_depth: int, mis: bool,
                   nee: bool, with_stats: bool, sort_rays: bool,
                   fused: bool):
    """li_path in the torch glue it ran before the glue kernels: the
    route of every path shade.kernel_route refuses (MIS, no NEE, a
    gradient), with the plain vertex; with fused, the vertex through
    shade_vertex and nee_accumulate (the wave as it was before
    ops/wave.py)."""
    n = o.shape[0]
    dev = o.device
    nl = meta.n_lights
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_specular = torch.zeros((n,), dtype=torch.bool, device=dev)
    # pdf of the previous BSDF sample, for the MIS weight of emitter hits
    prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    ray_o, ray_d = o, d
    inf = torch.full((n,), float("inf"), device=dev)
    neg = torch.full((n,), -1.0, device=dev)
    eps = pack.ray_eps.expand(n)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_primary, n_bounce, n_shadow = zero, zero, zero
    sweep_stats = {} if with_stats else None
    # original lane of each row, to unsort the film at the end
    lane = torch.arange(n, device=dev)

    lights = (shade_ops.light_table(meta, pack)
              if fused and dev.type == "cuda" else None)
    le_env = None if fused else light_ops.env_radiance(meta, pack, n)
    # the BVH root spheres of the sort keys' kernel, made once a wave (a
    # captured wave makes them from the pack it replays)
    roots = (rays_ops.root_table(meta, pack)
             if dev.type == "cuda" and (sort_rays or meta.kernel_routed)
             else None)
    state = shade_ops.VertexState(L, beta, active, prev_specular, prev_pdf,
                                  ray_o, ray_d)

    for bounce in range(max_depth + 1):
        # dead lanes trace nothing: tmin=+inf / tmax=-1 miss at once
        tmin = torch.where(state.active, eps, inf)
        tmax = torch.where(state.active, inf, neg)
        with span("li_path.intersect"):
            hit = scene_pack.intersect(meta, pack, state.ray_o, state.ray_d,
                                       tmin, tmax, stats=sweep_stats)
        if with_stats:
            cast = state.active.sum()
            if bounce == 0:
                n_primary = n_primary + cast
            else:
                n_bounce = n_bounce + cast

        u_vertex = None
        if bounce < max_depth:
            with span("li_path.rng"):
                u_vertex = rng.vertex_uniforms(u, bounce, nl)
        with span("li_path.vertex"):
            if fused:
                v = shade_ops.shade_vertex(
                    meta, pack, hit, state, None if u_vertex is None
                    else u_vertex.contiguous(), bounce, max_depth,
                    lights=lights)
            else:
                v = shade_ops.shade_vertex_plain(
                    meta, pack, hit, state, u_vertex, bounce, max_depth,
                    le_env=le_env, nee=nee, mis=mis)
        if bounce >= max_depth:
            L = v.state.L
            break
        if with_stats:
            n_shadow = n_shadow + v.useful.sum()
        with span("li_path.occluded"):
            occ = [scene_pack.occluded(
                meta, pack, hit.position, v.shadow_to[j], mask=v.useful[j],
                sort=meta.kernel_routed and bounce < 2, stats=sweep_stats,
                roots=roots)
                for j in range(v.useful.shape[0])]
        with span("li_path.nee_accumulate"):
            occ = (torch.stack(occ) if occ
                   else torch.zeros_like(v.useful))
            accumulate = (shade_ops.nee_accumulate if fused
                          else shade_ops.nee_accumulate_plain)
            L = accumulate(v.state.L, v.useful, occ, v.contrib)
        L, beta, active, prev_specular, prev_pdf, ray_o, ray_d = \
            v.state._replace(L=L)

        if sort_rays and bounce < 3:
            with span("li_path.sort"):
                # regroup lanes for the next bounce's traversal (ops/sort.py's
                # key, ops/rays.py::shadow_key's kernel on the card); deep
                # bounces keep the order: lanes only die from here, so the
                # dead tail of the last sort persists
                key = rays_ops.shadow_key(meta, pack,
                                          ray_o.detach().contiguous(),
                                          ray_d.detach().contiguous(),
                                          active.contiguous(), bounce=True,
                                          roots=roots)
                perm = torch.argsort(key, stable=True)
                L, beta, ray_o, ray_d, active, prev_specular, prev_pdf, \
                    lane = (x[perm] for x in (L, beta, ray_o, ray_d, active,
                                              prev_specular, prev_pdf, lane))
                u = _permute(u, perm)

        state = shade_ops.VertexState(L, beta, active, prev_specular,
                                      prev_pdf, ray_o, ray_d)

    # undo the permutation (row i is lane i again) and the invalid-sample
    # guard (reference: src/integrator.cc:104)
    L = wave_ops.unsort_guard_plain(L, lane if sort_rays else None)
    if with_stats:
        return L, {"rays_primary": n_primary, "rays_bounce": n_bounce,
                   "rays_shadow": n_shadow,
                   "rays": n_primary + n_bounce + n_shadow, **sweep_stats}
    return L


def _li_path_kernels(meta, pack, u, max_depth: int, with_stats: bool,
                     sort_rays: bool, state: wave_ops.WaveState):
    """li_path on the glue kernels' route (shade.kernel_route: NEE on, MIS
    off, no gradient outside shade.GRAD_FIELDS): the state between the
    casts is a WaveState the kernels hand on. shade_vertex writes the next
    cast's bounds and adds to the ray counters, each vertex's shadow casts
    write their rows of one [J, N] flag slab, one permute_state moves every
    row at a sort, and unsort_guard scatters the rows back to their lanes.
    On the card no torch op runs between the kernels but the sorts'
    argsort; on the CPU each wrapper runs its plain version. The vertex,
    the permutes and the un-sort go through their autograd Functions
    (shade.vertex, wave.permute, wave.unsort), which record a backward
    where L and beta carry a gradient."""
    dev = state.L.device
    nl = meta.n_lights
    sweep_stats = {} if with_stats else None
    counts = state.counts if with_stats else None
    lights = (shade_ops.light_table(meta, pack) if dev.type == "cuda"
              else None)
    # the BVH root spheres of the sort keys' kernel, made once a wave (a
    # captured wave makes them from the pack it replays)
    roots = (rays_ops.root_table(meta, pack)
             if dev.type == "cuda" and (sort_rays or meta.kernel_routed)
             else None)
    for bounce in range(max_depth + 1):
        with span("li_path.intersect"):
            hit = scene_pack.intersect(meta, pack, state.ray_o, state.ray_d,
                                       state.tmin, state.tmax,
                                       stats=sweep_stats)
        u_vertex = None
        if bounce < max_depth:
            with span("li_path.rng"):
                u_vertex = rng.vertex_uniforms(u, bounce, nl)

        def occlude(v, hit=hit, bounce=bounce):
            # the bounce's shadow casts, each writing its row of the flags
            occ = torch.empty_like(v.useful)
            for j in range(v.useful.shape[0]):
                scene_pack.occluded(
                    meta, pack, hit.position, v.shadow_to[j],
                    mask=v.useful[j], sort=meta.kernel_routed and bounce < 2,
                    stats=sweep_stats, roots=roots, out=occ[j])
            return occ

        # shade_vertex, the shadow casts and nee_accumulate, each in its
        # li_path range (li_path.vertex, .occluded, .nee_accumulate)
        v, _ = shade_ops.vertex(
            meta, pack, hit, shade_ops.VertexState(*state[:7]), u_vertex,
            bounce, max_depth, lights=lights, counts=counts, occlude=occlude)
        counts = v.counts
        if bounce >= max_depth:
            L = v.state.L
            break
        state = wave_ops.WaveState(*v.state, state.lane, v.tmin, v.tmax,
                                   state.counts if counts is None
                                   else counts)
        if sort_rays and bounce < 3:
            with span("li_path.sort"):
                # regroup lanes for the next bounce's traversal (ops/sort.py's
                # key, ops/rays.py::shadow_key's kernel on the card); deep
                # bounces keep the order: lanes only die from here, so the
                # dead tail of the last sort persists
                key = rays_ops.shadow_key(meta, pack, state.ray_o,
                                          state.ray_d, state.active,
                                          bounce=True, roots=roots)
                perm = torch.argsort(key, stable=True)
                state, u = wave_ops.permute(state, u, perm)

    # undo the permutation (row i is lane i again: a scatter) and the
    # invalid-sample guard (reference: src/integrator.cc:104)
    L = wave_ops.unsort(L, state.lane if sort_rays else None)
    if with_stats:
        return L, {**dict(zip(wave_ops.COUNTS, counts.unbind(0))),
                   **sweep_stats}
    return L


def li_debug_normal(meta, pack, o, d):
    """Normal visualisation (reference: src/integrator.h:44-58): |normal|
    on a hit, black on a miss."""
    n = o.shape[0]
    tmin = pack.ray_eps.expand(n)
    tmax = torch.full((n,), float("inf"), device=o.device)
    hit = scene_pack.intersect(meta, pack, o, d, tmin, tmax)
    return torch.where(hit.valid[:, None], torch.abs(hit.normal),
                       torch.zeros_like(hit.normal))


def li_whitted(meta, pack, o, d, u, max_depth: int):
    """Whitted-style integrator (reference: src/integrator.cc:115-220):
    emission at every depth, NEE at every hit, and a path continues only
    through delta (specular) lobes."""
    n = o.shape[0]
    dev = o.device
    nl = meta.n_lights
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    ray_o, ray_d = o, d
    inf = torch.full((n,), float("inf"), device=dev)
    neg = torch.full((n,), -1.0, device=dev)
    eps = pack.ray_eps.expand(n)
    le_env = light_ops.env_radiance(meta, pack, n)

    for bounce in range(max_depth + 1):
        hit = scene_pack.intersect(meta, pack, ray_o, ray_d,
                                   torch.where(active, eps, inf),
                                   torch.where(active, inf, neg))
        le = torch.where(hit.valid[:, None], scene_pack.emitted(pack, hit),
                         le_env)
        L = L + torch.where(active[:, None], beta * le, torch.zeros_like(le))
        if bounce >= max_depth:
            break
        cont = active & hit.valid

        u_vertex = rng.vertex_uniforms(u, bounce, nl)
        mat_kind, c0, c1, s0, s1, remap, tex_id, mf_kind = \
            scene_pack.gather_material(pack, hit.mat_id)
        c0 = scene_pack.effective_kd(meta, pack, hit, c0, tex_id)
        lobe = bsdf_ops.make_lobe(mat_kind, c0, c1, s0, s1, remap,
                                  rng.stream_lobe(u_vertex), mf_kind=mf_kind)
        delta = bsdf_ops.is_delta(lobe)
        frame = frame_from_z(hit.normal)
        wo_local = to_local(frame, hit.wo)

        for li_idx in range(nl):
            if meta.lights[li_idx].static_black:
                continue
            ls = light_ops.sample_li(meta, pack, li_idx, hit.position,
                                     rng.stream_nee(u_vertex, li_idx))
            wi, pdf = ls.wi.detach(), ls.pdf.detach()
            f = bsdf_ops.eval_f(lobe, wo_local, to_local(frame, wi),
                                lobes=meta.present_lobes,
                                mf_kinds=meta.present_mf_kinds)
            useful = (cont & ~delta & (pdf > 0.0) & ~is_black(ls.li)
                      & ~is_black(f))
            occ = scene_pack.occluded(meta, pack, hit.position,
                                      ls.pos.detach(), mask=useful)
            contrib = beta * f * ls.li * (
                absdot(wi, hit.normal) / torch.clamp_min(pdf, 1e-20))[:, None]
            L = L + torch.where((useful & ~occ)[:, None], contrib,
                                torch.zeros_like(contrib))

        bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u_vertex, nl),
                             lobes=meta.present_lobes,
                             mf_kinds=meta.present_mf_kinds)
        wi_world = to_world(frame, bs.wi).detach()
        pdf_b = bs.pdf.detach()
        active = cont & delta & (pdf_b > 0.0) & ~is_black(bs.f)
        weight = bs.f * (absdot(wi_world, hit.normal)
                         / torch.clamp_min(pdf_b, 1e-20))[:, None]
        beta = torch.where(active[:, None], beta * weight, beta)
        ray_o = torch.where(active[:, None], hit.position, ray_o)
        ray_d = torch.where(active[:, None], wi_world, ray_d)

    return torch.where(torch.isfinite(L), L, torch.zeros_like(L))
