"""The plain reference path tracer: the program's path integrator, with
NEE or without, with MIS or without, written as plain torch operations
over a batch of (sample, pixel) lanes.

The camera, the integrator loop, the path vertex and the hit
reconstruction are frozen copies of the program's plain route at commit
77f45ea (jet_pbrt_tpu_torch/models/camera.py, models/integrators.py::
_li_path_plain, ops/shade.py::shade_vertex_plain with nee=True and
mis=False, scene/pack.py's intersect, emitted and gather_material, and
ops/rays.py::segment_plain); what mis=True and nee=False add to that loop
(the emission gate, the MIS weights, prev_pdf) copies the same functions
at commit 2b2268e, and mis.py their pdf_li. The casts go through this
package's own BVH (bvh.py) and brute-force tests. Lanes are never sorted
(a sort moves lanes, never their values), and dead lanes are dropped from
the casts. Every float tensor is of the scene's dtype, so the same code
computed in bfloat16 is the control that `correct` must fail.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import bsdf as bsdf_ops
from . import bvh as bvh_ops
from . import intersect as isect_ops
from . import lights as light_ops
from . import mis as mis_ops
from . import rng
from .consts import (KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST,
                     LIGHT_AREA, LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_ENV)
from .linalg import (absdot, dot, frame_from_z, is_black, max_component,
                     normalize, to_local, to_world)


class Camera(NamedTuple):
    position: torch.Tensor
    front: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    resolution: torch.Tensor


class Hit(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor
    wo: torch.Tensor
    mat_id: torch.Tensor
    light_id: torch.Tensor


def make_camera(lookfrom, front, vup, vfov_degrees, resolution, device,
                dtype=torch.float32) -> Camera:
    """The scaled basis, derived in float64 and stored in float32 (then
    cast to dtype), as the program's make_camera does."""
    front = np.asarray(front, np.float64)
    front = front / np.linalg.norm(front)
    vup = np.asarray(vup, np.float64)
    vup = vup / np.linalg.norm(vup)
    w, h = float(resolution[0]), float(resolution[1])
    tan_fov = np.tan(np.deg2rad(vfov_degrees) / 2.0)
    right = np.cross(vup, front)
    right = right / np.linalg.norm(right) * (tan_fov * (w / h))
    up = np.cross(front, right)
    up = up / np.linalg.norm(up) * tan_fov

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device).to(dtype)

    return Camera(position=t(lookfrom), front=t(front), right=t(right),
                  up=t(up), resolution=t([w, h]))


def camera_rays(cam: Camera, pixel, width: int, jitter):
    """Rays through pixel ids [N] plus in-pixel jitter [N, 2]."""
    x = (pixel % width).to(jitter.dtype) + jitter[:, 0]
    y = (pixel // width).to(jitter.dtype) + jitter[:, 1]
    w = cam.resolution[0]
    h = cam.resolution[1]
    sx = 2.0 * (x / w - 0.5)
    sy = 2.0 * (0.5 - y / h)
    d = (cam.front[None, :] + cam.right[None, :] * sx[:, None]
         + cam.up[None, :] * sy[:, None])
    d = normalize(d)
    o = cam.position[None, :].expand(d.shape).contiguous()
    return o, d


# --------------------------------------------------------------------------
# casts
# --------------------------------------------------------------------------

def _brute(scene, o, d, tmin, tmax):
    """(kind, KindHit) of each brute-force kind, in the merge's order."""
    out = []
    if scene.brute_tri:
        out.append((KIND_TRI, isect_ops.intersect_triangles(
            o, d, tmin, tmax, scene.tri_p0, scene.tri_p1, scene.tri_p2)))
    return out


def _brute_rest(scene, o, d, tmin, tmax):
    out = []
    if scene.sph_c.shape[0]:
        out.append((KIND_SPHERE, isect_ops.intersect_spheres(
            o, d, tmin, tmax, scene.sph_c, scene.sph_r)))
    if scene.rect_q.shape[0]:
        q = scene.rect_q
        out.append((KIND_RECT, isect_ops.intersect_rects(
            o, d, tmin, tmax, q[:, 0], q[:, 1], q[:, 2], q[:, 3],
            scene.rect_n)))
    if scene.disk_c.shape[0]:
        out.append((KIND_DISK, isect_ops.intersect_disks(
            o, d, tmin, tmax, scene.disk_c, scene.disk_n, scene.disk_r)))
    return out


def _kind_hits(scene, o, d, tmin, tmax, any_hit: bool):
    hits = _brute(scene, o, d, tmin, tmax)
    for kind, tree, n_tris, off, scl, _m, _l in scene.meshes:
        got = bvh_ops.closest(tree, n_tris, o, d, tmin, tmax, off, scl,
                              any_hit)
        if any_hit:
            hits.append((kind, isect_ops.KindHit(None, None, got)))
        else:
            hits.append((kind, isect_ops.KindHit(*got)))
    hits += _brute_rest(scene, o, d, tmin, tmax)
    return hits


def intersect(scene, o, d, tmin, tmax) -> Hit:
    """The closest hit over the scene: each kind's, min-merged (an earlier
    kind keeps a tie), then the hit's position, normal, material and
    light."""
    n = o.shape[0]
    hits = _kind_hits(scene, o, d, tmin, tmax, False)
    kinds = [k for k, _ in hits]
    t, kind, index, valid = isect_ops.merge_hits([h for _, h in hits], kinds)
    t_safe = torch.where(valid, t, torch.ones_like(t))
    p = o + t_safe[:, None] * d
    index = index.to(torch.int64)
    rows = lambda table, i: torch.index_select(
        table, 0, torch.clamp(i, 0, max(table.shape[0] - 1, 0)))
    normal = torch.zeros_like(o)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=o.device)
    light_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for k in kinds:
        if k == KIND_TRI:
            nk, mk, lk = (rows(scene.tri_n, index), rows(scene.tri_mat, index),
                          rows(scene.tri_light, index))
        elif k >= KIND_INST:
            _, _, n_tris, _, _, imat, ilight = next(
                m for m in scene.meshes if m[0] == k)
            inst, ti = index // n_tris, index % n_tris
            nk = rows(scene.family_n[k - KIND_INST], ti)
            mk, lk = rows(imat, inst), rows(ilight, inst)
        elif k == KIND_SPHERE:
            nk = normalize(p - rows(scene.sph_c, index))
            mk, lk = rows(scene.sph_mat, index), rows(scene.sph_light, index)
        elif k == KIND_RECT:
            nk = isect_ops.rect_hit_normal(rows(scene.rect_n, index), d)
            mk, lk = rows(scene.rect_mat, index), rows(scene.rect_light, index)
        else:
            nk = rows(scene.disk_n, index)
            mk, lk = rows(scene.disk_mat, index), rows(scene.disk_light, index)
        sel = kind == k
        normal = torch.where(sel[:, None], nk, normal)
        mat_id = torch.where(sel, mk, mat_id)
        light_id = torch.where(sel, lk, light_id)
    return Hit(valid=valid, t=t, position=p, normal=normal, wo=-d,
               mat_id=torch.where(valid, mat_id, torch.zeros_like(mat_id)),
               light_id=torch.where(valid, light_id,
                                    torch.full_like(light_id, -1)))


def occluded(scene, p_from, p_to, mask):
    """Visibility over [eps, dist - eps] (ops/rays.py::segment_plain's
    segment); lanes with mask False report unoccluded."""
    delta = p_to - p_from
    dist = torch.sqrt(torch.clamp_min(dot(delta, delta), 1e-20))
    d = delta / dist[:, None]
    tmin = scene.ray_eps.expand(dist.shape)
    tmax = dist - scene.ray_eps
    occ = torch.zeros_like(mask)
    live = mask.nonzero().squeeze(1)
    if live.numel() == 0:
        return occ
    o, d, tmin, tmax = (x[live] for x in (p_from, d, tmin, tmax))
    flags = torch.zeros((live.numel(),), dtype=torch.bool, device=o.device)
    for _, h in _kind_hits(scene, o, d, tmin, tmax, True):
        flags = flags | h.valid
    occ[live] = flags
    return occ


def emitted(scene, hit: Hit):
    if scene.light_c.shape[0] == 0:
        return torch.zeros_like(hit.position)
    is_emitter = hit.light_id >= 0
    radiance = torch.index_select(
        scene.light_c, 0, torch.clamp(hit.light_id.to(torch.int64), 0,
                                      scene.light_c.shape[0] - 1))
    facing = dot(hit.normal, hit.wo) > 0.0
    return torch.where((is_emitter & facing & hit.valid)[:, None], radiance,
                       torch.zeros_like(radiance))


def gather_material(scene, mat_id):
    i = mat_id.to(torch.int64)
    return tuple(torch.index_select(t, 0, i) for t in (
        scene.mat_kind, scene.mat_c0, scene.mat_c1, scene.mat_s0,
        scene.mat_s1, scene.mat_remap, scene.mat_mf))


# --------------------------------------------------------------------------
# the integrator
# --------------------------------------------------------------------------

def li_path(scene, o, d, keys: rng.LaneKeys, max_depth: int, *,
            mis: bool = False, nee: bool = True):
    """Path-traced radiance [N, 3] of rays o, d with NEE at every
    non-delta vertex, emission at bounce 0 and after specular bounces,
    Russian roulette from bounce 3 on the sampled f (integrator.cc:316-403
    of the reference renderer), and the invalid-sample guard.

    mis=True (with NEE) also adds the emission of a BSDF-sampled hit on an
    area light, or of an escaped ray, after a non-specular bounce,
    weighted by power_heuristic(1, prev_pdf, 1, pdf_li), and weights each
    non-delta light's NEE by power_heuristic(1, pdf, 1, bsdf pdf).
    nee=False samples no light and credits emission at every bounce."""
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    nl = scene.n_lights
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_specular = torch.zeros((n,), dtype=torch.bool, device=dev)
    # pdf of the previous BSDF sample, for the MIS weight of emitter hits
    prev_pdf = torch.zeros((n,), dtype=dt, device=dev)
    ray_o, ray_d = o, d
    inf = torch.full((n,), math.inf, dtype=dt, device=dev)
    le_env = torch.zeros((n, 3), dtype=dt, device=dev)
    for i in scene.env_light_indices:
        le_env = le_env + scene.light_c[i][None, :]

    for bounce in range(max_depth + 1):
        # only live lanes are cast; the others miss
        live = active.nonzero().squeeze(1)
        hit_live = intersect(scene, ray_o[live].detach(), ray_d[live].detach(),
                             scene.ray_eps.expand(live.shape), inf[live])
        hit = Hit(*(_scatter(h, live, n, fill)
                    for h, fill in zip(hit_live, (False, math.inf, 0.0, 0.0,
                                                  0.0, 0, -1))))
        hit = hit._replace(wo=-ray_d)
        gate = (active if bounce == 0 else active & prev_specular) if nee \
            else active
        le = torch.where(hit.valid[:, None], emitted(scene, hit), le_env)
        L = L + torch.where(gate[:, None], beta * le, torch.zeros_like(le))
        if mis and bounce > 0:
            # the BSDF-sampled emitter hits that NEE alone drops
            w_area = torch.zeros((n,), dtype=dt, device=dev)
            for li_idx in range(nl):
                kind = scene.lights[li_idx].kind
                if kind not in (LIGHT_AREA, LIGHT_ENV):
                    continue
                pl = mis_ops.pdf_li(scene, li_idx, ray_o, ray_d)
                w = mis_ops.power_heuristic(1.0, prev_pdf, 1.0, pl)
                this = (hit.valid & (hit.light_id == li_idx)
                        if kind == LIGHT_AREA else ~hit.valid)
                w_area = torch.where(this, w, w_area)
            L = L + torch.where((active & ~prev_specular)[:, None],
                                beta * le * w_area.detach()[:, None],
                                torch.zeros_like(le))
        if bounce >= max_depth:
            break
        cont = active & hit.valid
        u = rng.vertex_uniforms(keys, bounce, nl, dt)
        mat_kind, c0, c1, s0, s1, remap, mf_kind = gather_material(
            scene, hit.mat_id)
        lobe = bsdf_ops.make_lobe(mat_kind, c0, c1, s0, s1, remap,
                                  rng.stream_lobe(u), mf_kind=mf_kind)
        delta = bsdf_ops.is_delta(lobe)
        frame = frame_from_z(hit.normal)
        wo_local = to_local(frame, hit.wo)

        # NEE over all lights
        for li_idx in range(nl if nee else 0):
            if scene.lights[li_idx].static_black:
                continue
            ls = light_ops.sample_li(scene, scene, li_idx, hit.position,
                                     rng.stream_nee(u, li_idx))
            wi, pdf = ls.wi.detach(), ls.pdf.detach()
            wi_local = to_local(frame, wi)
            f = bsdf_ops.eval_f(lobe, wo_local, wi_local,
                                lobes=scene.present_lobes,
                                mf_kinds=scene.present_mf_kinds)
            useful = (cont & ~delta & (pdf > 0.0) & ~is_black(ls.li)
                      & ~is_black(f))
            contrib = beta * f * ls.li * (
                absdot(wi, hit.normal) / torch.clamp_min(pdf, 1e-20))[:, None]
            if mis and scene.lights[li_idx].kind not in (LIGHT_POINT,
                                                         LIGHT_DIRECTIONAL):
                pb = bsdf_ops.pdf(lobe, wo_local, wi_local,
                                  lobes=scene.present_lobes,
                                  mf_kinds=scene.present_mf_kinds)
                contrib = contrib * mis_ops.power_heuristic(
                    1.0, pdf, 1.0, pb.detach())[:, None]
            occ = occluded(scene, hit.position.detach(), ls.pos.detach(),
                           useful)
            L = L + torch.where((useful & ~occ)[:, None], contrib,
                                torch.zeros_like(contrib))

        # BSDF sampling
        bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u, nl),
                             lobes=scene.present_lobes,
                             mf_kinds=scene.present_mf_kinds)
        wi_world = to_world(frame, bs.wi).detach()
        pdf_b = bs.pdf.detach()
        sample_ok = (pdf_b > 0.0) & ~is_black(bs.f)
        # Russian roulette
        if bounce >= 3:
            q = torch.clamp_min(1.0 - max_component(bs.f.detach()), 0.05)
            rr_die = rng.stream_rr(u, nl) < q
            rr_scale = 1.0 / torch.clamp_min(1.0 - q, 1e-6)
        else:
            rr_die = torch.zeros_like(active)
            rr_scale = torch.ones_like(pdf_b)
        active = cont & sample_ok & ~rr_die
        weight = (bs.f * (absdot(wi_world, hit.normal)
                          / torch.clamp_min(pdf_b, 1e-20))[:, None]
                  * rr_scale[:, None])
        beta = torch.where(active[:, None], beta * weight, beta)
        ray_o = torch.where(active[:, None], hit.position, ray_o)
        ray_d = torch.where(active[:, None], wi_world, ray_d)
        prev_specular = bs.is_specular
        prev_pdf = pdf_b
    return torch.where(torch.isfinite(L), L, torch.zeros_like(L))


def _scatter(x, live, n, fill):
    """x [M, ...] of the live lanes as [n, ...], fill elsewhere."""
    out = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[live] = x
    return out


def lanes(scene, cam: Camera, width: int, seed: int, sample, pixel,
          max_depth: int, **estimator):
    """Radiance [N, 3] of (sample, pixel) lanes, [N] int64 each; estimator:
    li_path's mis and nee."""
    keys = rng.lane_keys(seed, sample, pixel)
    jitter = rng.uniforms(keys, rng.PURPOSE_CAMERA, 2, scene.dtype)
    o, d = camera_rays(cam, pixel, width, jitter)
    return li_path(scene, o, d, keys, max_depth, **estimator)


# lanes a batch of the reference's frames (pixels) and gradient renders
# (image_fn): whole samples of the sampled pixels, or a 2^20-lane wave
PIXEL_LANES = 1 << 18
IMAGE_LANES = 1 << 20


def pixels(scene, cam: Camera, width: int, seed: int, pixel, spp: int,
           max_depth: int, clamp: bool = True, **estimator):
    """render()'s value [P, 3] float32 of pixel ids [P]: each sample's
    radiance added in float64 in sample order, the mean cast to float32,
    clamped to [0, 1] (or not, with clamp False). Lanes go in batches of
    whole samples; estimator: li_path's mis and nee."""
    film = torch.zeros((pixel.shape[0], 3), dtype=torch.float64,
                       device=pixel.device)
    per = max(1, PIXEL_LANES // max(pixel.shape[0], 1))
    for s0 in range(0, spp, per):
        ns = min(per, spp - s0)
        sample = torch.arange(s0, s0 + ns, device=pixel.device
                              ).repeat_interleave(pixel.shape[0])
        out = lanes(scene, cam, width, seed, sample, pixel.repeat(ns),
                    max_depth, **estimator).view(ns, -1, 3)
        for k in range(ns):
            film += out[k].to(torch.float64)
    img = (film / spp).to(torch.float32)
    return torch.clamp(img, 0.0, 1.0) if clamp else img


def image_fn(scene, cam: Camera, width: int, height: int, spp: int,
             seed: int, max_depth: int, **estimator):
    """render_fn's function: fn(scene) -> [H, W, 3], each sample's wave of
    the whole frame summed in the scene's dtype in sample order and divided
    by spp, unclamped; differentiable in the scene's material and light
    rows. A frame larger than IMAGE_LANES goes in pixel blocks; estimator:
    li_path's mis and nee."""
    n = width * height
    dev = cam.position.device

    def fn(sc):
        film = torch.zeros((n, 3), dtype=sc.dtype, device=dev)
        for s in range(spp):
            parts = []
            for p0 in range(0, n, IMAGE_LANES):
                pixel = torch.arange(p0, min(n, p0 + IMAGE_LANES), device=dev)
                sample = torch.full_like(pixel, s)
                parts.append(lanes(sc, cam, width, seed, sample, pixel,
                                   max_depth, **estimator))
            film = film + torch.cat(parts)
        return (film / spp).view(height, width, 3)

    return fn
