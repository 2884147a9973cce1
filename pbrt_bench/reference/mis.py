"""What multiple importance sampling adds to the plain reference: the power
heuristic, and `pdf_li`, the solid-angle pdf with which a light's
`sample_li` would pick a direction, for the constant environment and for
every area-light shape the reference's Layout builds (triangle, rect,
sphere, disk; it makes no emissive instance).

Frozen copy of jet_pbrt_tpu_torch/ops/sampling.py::power_heuristic and
ops/lights.py::pdf_li and _reintersect_pdf at commit 2b2268e (reference:
src/light.h:218-221, 289-298, src/shape.h:147-181, 646-656), in the
scene's dtype and through this package's own shape
tests, so that the same code computed in bfloat16 is the control.
"""
from __future__ import annotations

import torch

from . import intersect as isect_ops
from .consts import (KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, LIGHT_AREA,
                     LIGHT_ENV)
from .linalg import PI, cross, distance2, dot, length, normalize
from .sampling import pdf_uniform_cone


def power_heuristic(nf, f_pdf, ng, g_pdf) -> torch.Tensor:
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0, f * f / torch.clamp_min(denom, 1e-20),
                       torch.zeros_like(denom))


def _reintersect_pdf(h, shade_pos, wi, ln, area):
    """Solid-angle pdf dist^2 / (|cos| area) at the re-intersected point;
    0 where the ray misses."""
    t_safe = torch.where(h.valid, h.t, torch.ones_like(h.t))
    lp = shade_pos + t_safe[:, None] * wi
    pdf = distance2(shade_pos, lp) / torch.clamp_min(
        torch.abs(dot(ln, -wi)) * area, 1e-12)
    return torch.where(h.valid & torch.isfinite(pdf), pdf,
                       torch.zeros_like(pdf))


def pdf_li(scene, light_index: int, shade_pos, wi) -> torch.Tensor:
    """Pdf_Li of light `light_index` for directions wi [N, 3] from
    shade_pos [N, 3]; delta lights give 0."""
    lm = scene.lights[light_index]
    n = shade_pos.shape[0]
    dev, dt = shade_pos.device, shade_pos.dtype
    if lm.kind == LIGHT_ENV:
        cos_t = torch.clamp(wi[:, 2], -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        return torch.where(
            sin_t > 0.0, 1.0 / (2.0 * PI * PI * torch.clamp_min(sin_t, 1e-12)),
            torch.zeros_like(sin_t))
    if lm.kind != LIGHT_AREA:
        return torch.zeros((n,), dtype=dt, device=dev)

    sk, si = lm.shape_kind, lm.shape_idx
    tmin = torch.full((n,), 1e-3, dtype=dt, device=dev)
    tmax = torch.full((n,), float("inf"), dtype=dt, device=dev)
    if sk == KIND_SPHERE:
        c = scene.sph_c[si]
        r = scene.sph_r[si]
        d2 = distance2(shade_pos, c[None, :])
        sin2_max = torch.clamp(r * r / torch.clamp_min(d2, 1e-20), 0.0, 1.0)
        pdf_out = pdf_uniform_cone(
            torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0)))
        # inside: the re-intersection pdf
        h = isect_ops.intersect_spheres(shade_pos, wi, tmin, tmax,
                                        scene.sph_c[si:si + 1],
                                        scene.sph_r[si:si + 1])
        t_safe = torch.where(h.valid, h.t, torch.ones_like(h.t))
        lp = shade_pos + t_safe[:, None] * wi
        ln = normalize(lp - c[None, :])
        pdf_in = torch.where(
            h.valid, distance2(shade_pos, lp) / torch.clamp_min(
                torch.abs(dot(ln, -wi)) * (4.0 * PI * r * r), 1e-12),
            torch.zeros_like(d2))
        return torch.where(d2 <= r * r, pdf_in, pdf_out)
    if sk == KIND_TRI:
        p0, p1, p2 = scene.tri_p0[si], scene.tri_p1[si], scene.tri_p2[si]
        h = isect_ops.intersect_triangles(shade_pos, wi, tmin, tmax,
                                          p0[None], p1[None], p2[None])
        ln = scene.tri_n[si][None, :].expand(n, 3)
        area = 0.5 * length(cross(p1 - p0, p2 - p0))
    elif sk == KIND_RECT:
        q = scene.rect_q[si]
        h = isect_ops.intersect_rects(shade_pos, wi, tmin, tmax, q[None, 0],
                                      q[None, 1], q[None, 2], q[None, 3],
                                      scene.rect_n[si:si + 1])
        ln = scene.rect_n[si][None, :].expand(n, 3)
        area = length(cross(q[0] - q[1], q[2] - q[1]))
    elif sk == KIND_DISK:
        h = isect_ops.intersect_disks(shade_pos, wi, tmin, tmax,
                                      scene.disk_c[si:si + 1],
                                      scene.disk_n[si:si + 1],
                                      scene.disk_r[si:si + 1])
        ln = scene.disk_n[si][None, :].expand(n, 3)
        r = scene.disk_r[si]
        area = PI * r * r
    else:
        raise ValueError(f"pdf_li: the reference builds no area light of "
                         f"shape kind {sk}")
    return _reintersect_pdf(h, shade_pos, wi, ln, area)
