"""Light sampling: point, directional, area (triangle, rect, disk, sphere,
emissive instance) and constant environment lights.

PyTorch counterpart of jet_pbrt_tpu/ops/lights.py (reference:
src/light.h:50-311, src/shape.h:120-181, 549-656). Light kinds are static
(SceneMeta.lights), so dispatch is plain Python; radiance comes from the
pack. An emissive instance is one light over the whole instanced mesh: a
triangle of its raw mesh table picked uniformly by index, then a uniform
point on it, with the picked triangle's own area in the pdf.

Frozen copy of jet_pbrt_tpu_torch/ops/lights.py at commit 77f45ea, the
benchmark's plain reference: later changes to the program do not move it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg import PI, dot, normalize, distance2, frame_from_z, to_world, \
    cross, length
from .sampling import sample_uniform_sphere, sample_uniform_triangle, \
    sample_concentric_disk, pdf_uniform_cone


class LightSample(NamedTuple):
    wi: torch.Tensor   # [N,3] world
    pdf: torch.Tensor  # [N] solid-angle pdf
    li: torch.Tensor   # [N,3]
    pos: torch.Tensor  # [N,3] point on the light


def _area_convert_pdf(pdf_area, light_pos, light_n, shade_pos, wi):
    """Area -> solid-angle pdf; non-finite -> 0 (reference:
    src/shape.h:124-145)."""
    d2 = distance2(light_pos, shade_pos)
    cos_l = torch.abs(dot(light_n, -wi))
    pdf = pdf_area * d2 / torch.clamp_min(cos_l, 1e-12)
    ok = (d2 > 0.0) & (cos_l > 1e-9) & torch.isfinite(pdf)
    return torch.where(ok, pdf, torch.zeros_like(pdf))


def _sample_shape_position(pack, shape_kind, shape_idx, u):
    """SamplePosition of one static shape row -> (pos, n, pdf_area)."""
    from .consts import KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, \
        KIND_INST

    n_batch = u.shape[0]
    if shape_kind == KIND_TRI:
        p0 = pack.tri_p0[shape_idx]
        p1 = pack.tri_p1[shape_idx]
        p2 = pack.tri_p2[shape_idx]
        b = sample_uniform_triangle(u)
        pos = (b[:, 0:1] * p0[None, :] + b[:, 1:2] * p1[None, :]
               + (1.0 - b[:, 0:1] - b[:, 1:2]) * p2[None, :])
        nrm = pack.tri_n[shape_idx][None, :].expand(n_batch, 3)
        area = 0.5 * length(cross(p1 - p0, p2 - p0))
    elif shape_kind == KIND_RECT:
        q = pack.rect_q[shape_idx]
        pos = (q[1][None, :] + u[:, 0:1] * (q[0] - q[1])[None, :]
               + u[:, 1:2] * (q[2] - q[1])[None, :])
        nrm = pack.rect_n[shape_idx][None, :].expand(n_batch, 3)
        area = length(cross(q[0] - q[1], q[2] - q[1]))
    elif shape_kind == KIND_DISK:
        c = pack.disk_c[shape_idx]
        nd = pack.disk_n[shape_idx]
        r = pack.disk_r[shape_idx]
        s, t, _ = frame_from_z(nd[None, :])
        dpt = sample_concentric_disk(u)
        pos = c[None, :] + r * (s * dpt[:, 0:1] + t * dpt[:, 1:2])
        nrm = nd[None, :].expand(n_batch, 3)
        area = PI * r * r
    elif shape_kind == KIND_SPHERE:
        c = pack.sph_c[shape_idx]
        r = pack.sph_r[shape_idx]
        dirs = sample_uniform_sphere(u)
        pos = c[None, :] + r * dirs
        nrm = dirs
        area = 4.0 * PI * r * r
    elif shape_kind >= KIND_INST:
        # the raw mesh table: blas_tris pads leaves with duplicate rows,
        # which would cover their area twice
        mi = shape_kind - KIND_INST
        em = pack.inst_em_tris[mi]
        t_count = em.shape[0]
        off = pack.inst_off[mi][shape_idx]
        scl = pack.inst_scale[mi][shape_idx]
        u0 = torch.clamp(u[:, 0] * t_count, 0.0, t_count - 1e-3)
        ti = u0.to(torch.int64)
        u0r = u0 - ti.to(u0.dtype)
        rows = torch.cat([em, pack.inst_em_n[mi]], dim=1)[ti]
        p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        b = sample_uniform_triangle(torch.stack([u0r, u[:, 1]], dim=-1))
        pos_l = p0 + b[:, 1:2] * e1 + (1.0 - b[:, 0:1] - b[:, 1:2]) * e2
        pos = pos_l * scl + off[None, :]
        area_w = torch.clamp_min(0.5 * length(cross(e1, e2)) * scl * scl,
                                 1e-20)
        return pos, rows[:, 9:12], 1.0 / (t_count * area_w)
    else:
        raise ValueError(f"bad shape kind {shape_kind}")
    pdf_area = torch.ones((n_batch,), dtype=u.dtype,
                          device=u.device) / area
    return pos, nrm, pdf_area


def _sample_sphere_cone(pack, shape_idx, shade_pos, u):
    """Cone sampling toward a sphere seen from outside, with the Taylor
    small-cone fallback (reference: src/shape.h:564-644)."""
    c = pack.sph_c[shape_idx]
    r = pack.sph_r[shape_idx]
    delta = c[None, :] - shade_pos
    dist2 = torch.clamp_min(dot(delta, delta), 1e-20)
    dist = torch.sqrt(dist2)
    w = delta * (1.0 / dist)[:, None]
    sin2_max = torch.clamp(r * r / dist2, 0.0, 1.0)
    sin_max = torch.sqrt(sin2_max)
    inv_sin_max = 1.0 / torch.clamp_min(sin_max, 1e-12)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
    cos_t = (cos_max - 1.0) * u[:, 0] + 1.0
    sin2_t = 1.0 - cos_t * cos_t
    small = sin2_max < 0.00068523
    sin2_t = torch.where(small, sin2_max * u[:, 0], sin2_t)
    cos_t = torch.where(small, torch.sqrt(1.0 - sin2_t), cos_t)
    cos_alpha = sin2_t * inv_sin_max + cos_t * torch.sqrt(
        torch.clamp_min(1.0 - sin2_t * inv_sin_max * inv_sin_max, 0.0))
    sin_alpha = torch.sqrt(torch.clamp_min(1.0 - cos_alpha * cos_alpha, 0.0))
    phi = u[:, 1] * 2.0 * PI
    local = torch.stack([sin_alpha * torch.cos(phi), sin_alpha * torch.sin(phi),
                         cos_alpha], dim=-1)
    world_normal = -to_world(frame_from_z(w), local)
    pos = c[None, :] + r * world_normal
    return pos, world_normal, pdf_uniform_cone(cos_max), dist2, r


def sample_area_light(pack, light_index: int, shape_kind: int, shape_idx: int,
                      shade_pos, u) -> LightSample:
    """FAreaLight::Sample_Li (reference: src/light.h:199-216)."""
    from .consts import KIND_SPHERE

    radiance = pack.light_c[light_index]
    if shape_kind == KIND_SPHERE:
        pos_cone, n_cone, pdf_cone, dist2, r = _sample_sphere_cone(
            pack, shape_idx, shade_pos, u)
        pos_area, n_area, pdf_a = _sample_shape_position(
            pack, shape_kind, shape_idx, u)
        inside = dist2 <= (r * r)
        wi_area = normalize(pos_area - shade_pos)
        pdf_area_sa = _area_convert_pdf(pdf_a, pos_area, n_area, shade_pos,
                                        wi_area)
        pos = torch.where(inside[:, None], pos_area, pos_cone)
        nrm = torch.where(inside[:, None], n_area, n_cone)
        pdf = torch.where(inside, pdf_area_sa, pdf_cone)
    else:
        pos, nrm, pdf_a = _sample_shape_position(pack, shape_kind, shape_idx, u)
        pdf = _area_convert_pdf(pdf_a, pos, nrm, shade_pos,
                                normalize(pos - shade_pos))
    wi = normalize(pos - shade_pos)
    facing = dot(nrm, -wi) > 0.0
    d2 = distance2(pos, shade_pos)
    lit = (facing & (pdf > 0.0) & (d2 > 0.0))[:, None]
    li = torch.where(lit, radiance[None, :].expand_as(pos),
                     torch.zeros_like(pos))
    return LightSample(wi=wi, pdf=pdf, li=li, pos=pos)


def sample_li(meta, pack, light_index: int, shade_pos, u) -> LightSample:
    """Sample_Li of static light `light_index` over a shading batch;
    u: [N,2] uniforms of the NEE stream."""
    from .consts import LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_AREA, \
        LIGHT_ENV

    lm = meta.lights[light_index]
    n = shade_pos.shape[0]
    ones = torch.ones((n,), dtype=shade_pos.dtype, device=shade_pos.device)
    if lm.kind == LIGHT_POINT:
        lpos = pack.light_pos[light_index]
        delta = lpos[None, :] - shade_pos
        d2 = torch.clamp_min(dot(delta, delta), 1e-20)
        wi = delta / torch.sqrt(d2)[:, None]
        li = pack.light_c[light_index][None, :] / d2[:, None]
        return LightSample(wi=wi, pdf=ones, li=li,
                           pos=lpos[None, :].expand(n, 3))
    if lm.kind == LIGHT_DIRECTIONAL:
        wi = (-pack.light_dir[light_index])[None, :].expand(n, 3)
        pos = shade_pos + wi * (2.0 * pack.world_radius)
        li = pack.light_c[light_index][None, :].expand(n, 3)
        return LightSample(wi=wi, pdf=ones, li=li, pos=pos)
    if lm.kind == LIGHT_AREA:
        return sample_area_light(pack, light_index, lm.shape_kind,
                                 lm.shape_idx, shade_pos, u)
    if lm.kind == LIGHT_ENV:
        # lat-long direction sampling (reference: src/light.h:265-287)
        theta = u[:, 1] * PI
        phi = u[:, 0] * 2.0 * PI
        sin_t = torch.sin(theta)
        wi = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                          torch.cos(theta)], dim=-1)
        pos = shade_pos + wi * (2.0 * pack.world_radius)
        pdf = torch.where(sin_t != 0.0,
                          1.0 / (2.0 * PI * PI * torch.clamp_min(sin_t, 1e-12)),
                          torch.zeros_like(sin_t))
        li = pack.light_c[light_index][None, :].expand(n, 3)
        return LightSample(wi=wi, pdf=pdf, li=li, pos=pos)
    raise ValueError(f"bad light kind {lm.kind}")
