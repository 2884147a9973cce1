"""Microfacet normal distributions: Trowbridge-Reitz (GGX) and Beckmann.

PyTorch counterpart of jet_pbrt_tpu/ops/microfacet.py (reference:
src/microfacet.h, src/microfacet.cc): anisotropic (alpha_x, alpha_y), VNDF
sampling (Heitz 2018 spherical caps for GGX, the slope-space erf-CDF
inversion unrolled to 10 guarded Newton steps for Beckmann). `kinds` is the
static tuple of distributions present in the scene; a single-kind scene
computes only that branch. Directions are in the local frame (z = normal).

Frozen copy of jet_pbrt_tpu_torch/ops/microfacet.py at commit 77f45ea, the
benchmark's plain reference: later changes to the program do not move it.
"""
from __future__ import annotations

import torch

from .linalg import PI, dot, normalize, safe_sqrt, cross, unit

GGX = 0
BECKMANN = 1


def _where(c, a, b):
    return torch.where(c, a, b)


def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    """pbrt's log-polynomial remap (reference: src/microfacet.h:45-50)."""
    x = torch.log(torch.clamp_min(roughness, 1e-3))
    x2 = x * x
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * (x2 * x)
            + 0.000640711 * (x2 * x2))


def _trig(w):
    cos2 = torch.clamp(w[..., 2] * w[..., 2], 0.0, 1.0)
    sin2 = 1.0 - cos2
    sin_theta = torch.sqrt(sin2)
    safe_sin = torch.clamp_min(sin_theta, 1e-12)
    big = sin_theta > 1e-12
    cos_phi = _where(big, w[..., 0] / safe_sin, torch.ones_like(sin2))
    sin_phi = _where(big, w[..., 1] / safe_sin, torch.zeros_like(sin2))
    return (cos2, sin2, torch.clamp(cos_phi, -1, 1), torch.clamp(sin_phi, -1, 1))


def d_ggx(wh, ax, ay):
    cos2, sin2, cphi, sphi = _trig(wh)
    tan2 = sin2 / torch.clamp_min(cos2, 1e-12)
    e = (cphi * cphi / torch.clamp_min(ax * ax, 1e-12)
         + sphi * sphi / torch.clamp_min(ay * ay, 1e-12)) * tan2
    c2 = torch.clamp_min(cos2, 1e-12)
    ope = 1.0 + e
    d = 1.0 / (PI * ax * ay * (c2 * c2) * (ope * ope))
    return _where(cos2 > 0.0, d, torch.zeros_like(d))


def lambda_ggx(w, ax, ay):
    cos2, sin2, cphi, sphi = _trig(w)
    abs_tan = torch.sqrt(sin2 / torch.clamp_min(cos2, 1e-12))
    alpha = torch.sqrt(cphi * cphi * (ax * ax) + sphi * sphi * (ay * ay))
    at = alpha * abs_tan
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + at * at))
    return _where(cos2 > 1e-12, lam, torch.zeros_like(lam))


def d_beckmann(wh, ax, ay):
    cos2, sin2, cphi, sphi = _trig(wh)
    tan2 = sin2 / torch.clamp_min(cos2, 1e-12)
    c2 = torch.clamp_min(cos2, 1e-12)
    d = torch.exp(-tan2 * (cphi * cphi / torch.clamp_min(ax * ax, 1e-12)
                           + sphi * sphi / torch.clamp_min(ay * ay, 1e-12))
                  ) / (PI * ax * ay * (c2 * c2))
    return _where(cos2 > 0.0, d, torch.zeros_like(d))


def lambda_beckmann(w, ax, ay):
    cos2, sin2, cphi, sphi = _trig(w)
    abs_tan = torch.sqrt(sin2 / torch.clamp_min(cos2, 1e-12))
    alpha = torch.sqrt(cphi * cphi * (ax * ax) + sphi * sphi * (ay * ay))
    a = 1.0 / torch.clamp_min(alpha * abs_tan, 1e-12)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return _where((a >= 1.6) | (cos2 <= 1e-12), torch.zeros_like(lam), lam)


def _single(kinds):
    return None if kinds is None else tuple(kinds)


def d(kind, wh, ax, ay, kinds=None):
    k = _single(kinds)
    if k == (GGX,):
        return d_ggx(wh, ax, ay)
    if k == (BECKMANN,):
        return d_beckmann(wh, ax, ay)
    return _where(kind == GGX, d_ggx(wh, ax, ay), d_beckmann(wh, ax, ay))


def lam(kind, w, ax, ay, kinds=None):
    k = _single(kinds)
    if k == (GGX,):
        return lambda_ggx(w, ax, ay)
    if k == (BECKMANN,):
        return lambda_beckmann(w, ax, ay)
    return _where(kind == GGX, lambda_ggx(w, ax, ay),
                  lambda_beckmann(w, ax, ay))


def g1(kind, w, ax, ay, kinds=None):
    return 1.0 / (1.0 + lam(kind, w, ax, ay, kinds))


def g(kind, wo, wi, ax, ay, kinds=None):
    return 1.0 / (1.0 + lam(kind, wo, ax, ay, kinds)
                  + lam(kind, wi, ax, ay, kinds))


def _sample_ggx_vndf(wo_up, ax, ay, u):
    """Heitz 2018 spherical-cap VNDF sample; wo_up.z >= 0."""
    vh = normalize(torch.stack([ax * wo_up[..., 0], ay * wo_up[..., 1],
                                wo_up[..., 2]], dim=-1))
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    t1 = _where((lensq > 1e-20)[..., None],
                torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                             torch.zeros_like(inv)], dim=-1),
                unit(vh, 0))
    t2 = cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * PI * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    pz = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * vh
    return normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                  torch.clamp_min(nh[..., 2], 1e-6)], dim=-1))


def _beckmann_slope_sample(cos_theta, u1, u2):
    """Invert the Beckmann visible-slope CDF (reference:
    src/microfacet.cc:234-254), the early-exit Newton loop unrolled to 10
    guarded steps."""
    u1 = torch.clamp(u1, 1e-6, 1.0 - 1e-6)
    u2 = torch.clamp(u2, 1e-6, 1.0 - 1e-6)
    r_ni = torch.sqrt(-torch.log1p(-u1))
    sx_ni = r_ni * torch.cos(2.0 * PI * u2)
    sy_ni = r_ni * torch.sin(2.0 * PI * u2)

    ni = cos_theta > 0.9999
    cos_safe = _where(ni, torch.full_like(cos_theta, 0.5),
                      torch.clamp(cos_theta, -0.9999, 0.9999))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_safe * cos_safe, 0.0))
    tan_t = sin_t / cos_safe
    cot_t = 1.0 / tan_t

    a = torch.full_like(u1, -1.0)
    c = torch.erf(cot_t)
    theta = torch.arccos(cos_safe)
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    b = c - (1.0 + c) * torch.pow(1.0 - u1, fit)

    # rounded in float32 like the reference's weakly typed jnp.sqrt(PI)
    sqrt_pi_inv = 1.0 / torch.sqrt(torch.full((), PI, dtype=cos_theta.dtype,
                                              device=cos_theta.device))
    norm = 1.0 / (1.0 + c + sqrt_pi_inv * tan_t * torch.exp(-cot_t * cot_t))
    for _ in range(10):
        b = _where((b >= a) & (b <= c), b, 0.5 * (a + c))
        inv_erf = torch.erfinv(torch.clamp(b, -1.0 + 1e-7, 1.0 - 1e-7))
        value = norm * (1.0 + b + sqrt_pi_inv * tan_t
                        * torch.exp(-inv_erf * inv_erf)) - u1
        deriv = norm * (1.0 - inv_erf * tan_t)
        c = _where(value > 0.0, b, c)
        a = _where(value > 0.0, a, b)
        step = value / _where(torch.abs(deriv) > 1e-12, deriv,
                              torch.ones_like(deriv))
        b = b - _where(torch.abs(value) < 1e-6, torch.zeros_like(step), step)
    b = torch.clamp(b, -1.0 + 1e-7, 1.0 - 1e-7)
    sx_g = torch.erfinv(b)
    sy_g = torch.erfinv(2.0 * u2 - 1.0)
    return _where(ni, sx_ni, sx_g), _where(ni, sy_ni, sy_g)


def _sample_beckmann_vndf(wo_up, ax, ay, u):
    """Stretch / sample / rotate / unstretch (reference:
    src/microfacet.cc:212-254); wo_up.z >= 0."""
    w_s = normalize(torch.stack([ax * wo_up[..., 0], ay * wo_up[..., 1],
                                 wo_up[..., 2]], dim=-1))
    _, _, cphi, sphi = _trig(w_s)
    sx, sy = _beckmann_slope_sample(w_s[..., 2], u[..., 0], u[..., 1])
    rx = cphi * sx - sphi * sy
    ry = sphi * sx + cphi * sy
    return normalize(torch.stack([-ax * rx, -ay * ry, torch.ones_like(rx)],
                                 dim=-1))


def sample_wh(kind, wo, ax, ay, u, kinds=None):
    """Visible half-vector sample with the wo.z < 0 hemisphere flip
    (reference: src/microfacet.cc:212-254, 326-357)."""
    flip = wo[..., 2] < 0.0
    wo_up = _where(flip[..., None], -wo, wo)
    k = _single(kinds)
    if k == (GGX,):
        wh = _sample_ggx_vndf(wo_up, ax, ay, u)
    elif k == (BECKMANN,):
        wh = _sample_beckmann_vndf(wo_up, ax, ay, u)
    else:
        wh = _where((kind == GGX)[..., None], _sample_ggx_vndf(wo_up, ax, ay, u),
                    _sample_beckmann_vndf(wo_up, ax, ay, u))
    return _where(flip[..., None], -wh, wh)


def pdf_wh(kind, wo, wh, ax, ay, kinds=None):
    """D(wh) G1(wo) |wo.wh| / |cos wo| (reference: src/microfacet.cc:359-365)."""
    return (d(kind, wh, ax, ay, kinds) * g1(kind, wo, ax, ay, kinds)
            * torch.abs(dot(wo, wh))
            / torch.clamp_min(torch.abs(wo[..., 2]), 1e-12))
