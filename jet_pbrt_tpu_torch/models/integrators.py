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

Gradients (models/render.py::render_fn): sampled directions, pdfs, light
sample points, MIS weights and the roulette probability are detached where
the reference package stops their gradients, so the estimate is
differentiable through f, Li and emission alone and no traversal input
carries a gradient (the kernels have no backward).
"""
from __future__ import annotations

import torch

from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops import rng
from ..ops import sort as sort_ops
from ..ops.linalg import absdot, frame_from_z, to_local, to_world, \
    max_component, is_black
from ..ops.sampling import power_heuristic
from ..scene import pack as scene_pack


def _permute(u, perm):
    """LaneKeys (both key words and the sample index) or uniforms [N, ...]
    reordered by perm."""
    if isinstance(u, rng.LaneKeys):
        return rng.LaneKeys(*(x[perm] for x in u))
    return u[perm]


def li_path(meta, pack, o, d, u, max_depth: int, mis: bool = False,
            nee: bool = True, with_stats: bool = False,
            sort_rays: bool | None = None):
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
    scenes are sorted inside `occluded` either way."""
    if sort_rays is None:
        sort_rays = meta.kernel_routed
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
    le_env = light_ops.env_radiance(meta, pack, n)
    # original lane of each row, to unsort the film at the end
    lane = torch.arange(n, device=dev)

    for bounce in range(max_depth + 1):
        # dead lanes trace nothing: tmin=+inf / tmax=-1 miss at once
        tmin = torch.where(active, eps, inf)
        tmax = torch.where(active, inf, neg)
        hit = scene_pack.intersect(meta, pack, ray_o, ray_d, tmin, tmax,
                                   stats=sweep_stats)
        if with_stats:
            cast = active.sum()
            if bounce == 0:
                n_primary = n_primary + cast
            else:
                n_bounce = n_bounce + cast

        # emission (reference: src/integrator.cc:328-337)
        gate = (active if bounce == 0 else active & prev_specular) if nee \
            else active
        le = torch.where(hit.valid[:, None], scene_pack.emitted(pack, hit),
                         le_env)
        L = L + torch.where(gate[:, None], beta * le, torch.zeros_like(le))

        if mis and bounce > 0:
            # the BSDF-sampled emitter hits that NEE alone drops
            w_area = torch.zeros((n,), dtype=torch.float32, device=dev)
            for li_idx in range(nl):
                kind = meta.lights[li_idx].kind
                if kind not in (scene_pack.LIGHT_AREA, scene_pack.LIGHT_ENV):
                    continue
                pl = light_ops.pdf_li(meta, pack, li_idx, ray_o, ray_d)
                w = power_heuristic(1.0, prev_pdf, 1.0, pl)
                this = (hit.valid & (hit.light_id == li_idx)
                        if kind == scene_pack.LIGHT_AREA else ~hit.valid)
                w_area = torch.where(this, w, w_area)
            L = L + torch.where((active & ~prev_specular)[:, None],
                                beta * le * w_area.detach()[:, None],
                                torch.zeros_like(le))

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

        # NEE over all lights (reference: src/integrator.cc:357-372)
        for li_idx in range(nl if nee else 0):
            if meta.lights[li_idx].static_black:
                continue
            ls = light_ops.sample_li(meta, pack, li_idx, hit.position,
                                     rng.stream_nee(u_vertex, li_idx))
            # the light sample's direction, pdf and point carry no gradient
            wi, pdf = ls.wi.detach(), ls.pdf.detach()
            wi_local = to_local(frame, wi)
            f = bsdf_ops.eval_f(lobe, wo_local, wi_local,
                                lobes=meta.present_lobes,
                                mf_kinds=meta.present_mf_kinds)
            useful = (cont & ~delta & (pdf > 0.0) & ~is_black(ls.li)
                      & ~is_black(f))
            if with_stats:
                n_shadow = n_shadow + useful.sum()
            contrib = beta * f * ls.li * (
                absdot(wi, hit.normal) / torch.clamp_min(pdf, 1e-20))[:, None]
            if mis and not scene_pack.light_is_delta(meta, li_idx):
                pb = bsdf_ops.pdf(lobe, wo_local, wi_local,
                                  lobes=meta.present_lobes,
                                  mf_kinds=meta.present_mf_kinds)
                contrib = contrib * power_heuristic(1.0, pdf, 1.0,
                                                    pb.detach())[:, None]
            occ = scene_pack.occluded(
                meta, pack, hit.position, ls.pos.detach(), mask=useful,
                sort=meta.kernel_routed and bounce < 2, stats=sweep_stats)
            L = L + torch.where((useful & ~occ)[:, None], contrib,
                                torch.zeros_like(contrib))

        # BSDF sampling (reference: src/integrator.cc:375-379)
        bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u_vertex, nl),
                             lobes=meta.present_lobes,
                             mf_kinds=meta.present_mf_kinds)
        # the sampled direction and its pdf carry no gradient; f does
        wi_world = to_world(frame, bs.wi).detach()
        pdf_b = bs.pdf.detach()
        sample_ok = (pdf_b > 0.0) & ~is_black(bs.f)

        # Russian roulette (reference: src/integrator.cc:383-393)
        if bounce >= 3:
            q = torch.clamp_min(1.0 - max_component(bs.f.detach()), 0.05)
            rr_die = rng.stream_rr(u_vertex, nl) < q
            rr_scale = 1.0 / torch.clamp_min(1.0 - q, 1e-6)
        else:
            rr_die = torch.zeros_like(active)
            rr_scale = torch.ones_like(pdf_b)

        active = cont & sample_ok & ~rr_die
        weight = (bs.f * (absdot(wi_world, hit.normal)
                          / torch.clamp_min(pdf_b, 1e-20))[:, None]
                  * rr_scale[:, None])
        beta = torch.where(active[:, None], beta * weight, beta)
        prev_specular = bs.is_specular
        prev_pdf = pdf_b
        ray_o = torch.where(active[:, None], hit.position, ray_o)
        ray_d = torch.where(active[:, None], wi_world, ray_d)

        if sort_rays and bounce < 3:
            # regroup lanes for the next bounce's traversal (ops/sort.py);
            # deep bounces keep the order: lanes only die from here, so the
            # dead tail of the last sort persists
            world_lo = (pack.world_center - pack.world_radius).detach()
            world_inv = (1.0 / torch.clamp_min(2.0 * pack.world_radius,
                                               1e-12)).detach().expand(3)
            o_key, d_key = ray_o.detach(), ray_d.detach()
            needs = sort_ops.bvh_needed(meta, pack, o_key, d_key,
                                        torch.where(active, eps, inf),
                                        torch.where(active, inf, neg))
            key = sort_ops.ray_sort_key(active, o_key, d_key, world_lo,
                                        world_inv, needs_bvh=needs)
            perm = torch.argsort(key, stable=True)
            L, beta, ray_o, ray_d, active, prev_specular, prev_pdf, lane = (
                x[perm] for x in (L, beta, ray_o, ray_d, active,
                                  prev_specular, prev_pdf, lane))
            u = _permute(u, perm)

    if sort_rays:
        # undo the permutation: row i is lane i again (gather, no scatter)
        L = L[torch.argsort(lane)]
    # invalid-sample guard (reference: src/integrator.cc:104)
    L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
    if with_stats:
        return L, {"rays_primary": n_primary, "rays_bounce": n_bounce,
                   "rays_shadow": n_shadow,
                   "rays": n_primary + n_bounce + n_shadow, **sweep_stats}
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
