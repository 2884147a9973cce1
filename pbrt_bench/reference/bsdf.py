"""BSDF lobes: resolution from material rows, evaluation, pdf and sampling.

PyTorch counterpart of jet_pbrt_tpu/ops/bsdf.py (reference:
src/material.h, src/material.cc, src/bsdf.h, src/bsdf.cc). Every lobe kind
present in the scene is computed on every lane and merged by its kind tag;
`lobes` / `mf_kinds` (SceneMeta.present_lobes / present_mf_kinds) prune the
kinds a scene cannot produce. Directions are in the local shading frame.

Frozen copy of jet_pbrt_tpu_torch/ops/bsdf.py at commit 77f45ea, the
benchmark's plain reference: later changes to the program do not move it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg import PI, INV_PI, INV_2PI, dot, normalize, luminance, \
    face_forward, refract, safe_sqrt, frame_from_z, to_world, unit
from . import microfacet as mf
from .fresnel import fresnel_dielectric, fresnel_conductor
from .sampling import sample_cosine_hemisphere

MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_PLASTIC = 3
MAT_METAL = 4
MAT_ROUGHGLASS = 5
MAT_PHONG = 6

LOBE_LAMBERT = 0
LOBE_SPECULAR = 1
LOBE_FRESNEL = 2
LOBE_MICROFACET = 3
LOBE_PHONG = 4
LOBE_MICROFACET_TRANS = 5

ALL_LOBES = (LOBE_LAMBERT, LOBE_SPECULAR, LOBE_FRESNEL, LOBE_MICROFACET,
             LOBE_PHONG, LOBE_MICROFACET_TRANS)


class Lobe(NamedTuple):
    kind: torch.Tensor          # [N] int32
    f0: torch.Tensor            # [N,3] albedo / R / Kr / microfacet R / Ks
    f1: torch.Tensor            # [N,3] Kt / conductor eta
    f2: torch.Tensor            # [N,3] conductor k
    a0: torch.Tensor            # [N] glass eta_t / alpha_x / phong exponent
    a1: torch.Tensor            # [N] alpha_y
    fr_conductor: torch.Tensor  # [N] bool
    fr_eta_i: torch.Tensor      # [N]
    fr_eta_t: torch.Tensor      # [N]
    mf_kind: torch.Tensor       # [N] int32


class BSDFSample(NamedTuple):
    wi: torch.Tensor           # [N,3] local
    f: torch.Tensor            # [N,3]
    pdf: torch.Tensor          # [N]
    is_specular: torch.Tensor  # [N] bool


def _w(c, a, b):
    """torch.where with python-scalar branches broadcast to the tensor's."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(c, a, b)


def is_delta(lobe: Lobe) -> torch.Tensor:
    return (lobe.kind == LOBE_SPECULAR) | (lobe.kind == LOBE_FRESNEL)


def _sanitize(lobe: Lobe) -> Lobe:
    """Clamp per-kind parameters so every branch is finite on every lane."""
    is_mf = (lobe.kind == LOBE_MICROFACET) | (lobe.kind == LOBE_MICROFACET_TRANS)
    is_fr = lobe.kind == LOBE_FRESNEL
    is_ph = lobe.kind == LOBE_PHONG
    alpha0 = _w(is_mf, torch.clamp_min(lobe.a0, 1e-4), 0.25)
    alpha1 = _w(is_mf, torch.clamp_min(lobe.a1, 1e-4), 0.25)
    eta_glass = _w(is_fr, torch.clamp_min(lobe.a0, 1.0001), 1.5)
    a0 = torch.where(is_fr, eta_glass, alpha0)
    a0 = torch.where(is_ph, torch.clamp_min(lobe.a0, 1e-3), a0)
    return lobe._replace(a0=a0, a1=alpha1,
                         fr_eta_i=torch.clamp_min(lobe.fr_eta_i, 1e-3),
                         fr_eta_t=torch.clamp_min(lobe.fr_eta_t, 1e-3))


def _same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0.0


def _flip_z(v):
    return torch.stack([-v[..., 0], -v[..., 1], v[..., 2]], dim=-1)


def _negate_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], dim=-1)


def make_lobe(mat_kind, c0, c1, s0, s1, remap, u_lobe, mf_kind=None) -> Lobe:
    """Resolve material rows into lobes; u_lobe is the plastic pick uniform
    (reference: src/material.cc:12-43)."""
    n = mat_kind.shape[0]
    zero3 = torch.zeros_like(c0)
    one = torch.ones_like(s0)

    ld = luminance(c0)
    ls = luminance(c1)
    qd = ld / torch.clamp_min(ld + ls, 1e-12)
    plastic_diffuse = u_lobe < qd
    remapped_s0 = torch.where(remap, mf.roughness_to_alpha(s0), s0)
    remapped_s1 = torch.where(remap, mf.roughness_to_alpha(s1), s1)
    rough_reflect = u_lobe < 0.5

    is_pl = mat_kind == MAT_PLASTIC
    is_rg = mat_kind == MAT_ROUGHGLASS
    conds = [
        (mat_kind == MAT_MATTE, LOBE_LAMBERT),
        (mat_kind == MAT_MIRROR, LOBE_SPECULAR),
        (mat_kind == MAT_GLASS, LOBE_FRESNEL),
        (is_pl & plastic_diffuse, LOBE_LAMBERT),
        (is_pl & ~plastic_diffuse, LOBE_MICROFACET),
        (mat_kind == MAT_METAL, LOBE_MICROFACET),
        (is_rg & rough_reflect, LOBE_MICROFACET),
        (is_rg & ~rough_reflect, LOBE_MICROFACET_TRANS),
        (mat_kind == MAT_PHONG, LOBE_PHONG),
    ]
    # jnp.select semantics: the first matching condition wins
    kind = torch.full((n,), LOBE_LAMBERT, dtype=torch.int32,
                      device=mat_kind.device)
    for cond, k in reversed(conds):
        kind = torch.where(cond, torch.full_like(kind, k), kind)

    f0 = torch.where((is_pl & plastic_diffuse)[..., None],
                     c0 / torch.clamp_min(qd, 1e-12)[..., None], c0)
    f0 = torch.where((is_pl & ~plastic_diffuse)[..., None],
                     c1 / torch.clamp_min(1.0 - qd, 1e-12)[..., None], f0)
    f0 = torch.where((mat_kind == MAT_METAL)[..., None], torch.ones_like(c0), f0)
    f0 = torch.where((is_rg & rough_reflect)[..., None], 2.0 * c0, f0)
    f0 = torch.where((is_rg & ~rough_reflect)[..., None], 2.0 * c1, f0)

    f1 = torch.where((mat_kind == MAT_GLASS)[..., None], c1, zero3)
    f1 = torch.where((mat_kind == MAT_METAL)[..., None], c0, f1)
    f2 = torch.where((mat_kind == MAT_METAL)[..., None], c1, zero3)

    a0 = _w(mat_kind == MAT_GLASS, s0, 0.0)
    a0 = torch.where(is_pl, remapped_s0, a0)
    a0 = torch.where(mat_kind == MAT_METAL, remapped_s0, a0)
    a0 = torch.where(is_rg, remapped_s0, a0)
    a0 = torch.where(mat_kind == MAT_PHONG, s0, a0)
    a1 = _w(is_pl, remapped_s0, 0.0)
    a1 = torch.where(mat_kind == MAT_METAL, remapped_s1, a1)
    a1 = torch.where(is_rg, remapped_s0, a1)

    if mf_kind is None:
        mf_kind = torch.full((n,), mf.GGX, dtype=torch.int32,
                             device=mat_kind.device)
    return Lobe(kind=kind, f0=f0, f1=f1, f2=f2, a0=a0, a1=a1,
                fr_conductor=(mat_kind == MAT_METAL),
                fr_eta_i=_w(is_pl, 1.5, one),
                fr_eta_t=_w(is_rg, torch.clamp_min(s1, 1.0001), one),
                mf_kind=mf_kind.to(torch.int32))


def _eval_lambert(lobe: Lobe, wo, wi):
    ok = _same_hemisphere(wo, wi)
    return _w(ok[..., None], lobe.f0 * INV_PI, 0.0)


def _pdf_lambert(wo, wi):
    ok = _same_hemisphere(wo, wi)
    return _w(ok, torch.abs(wi[..., 2]) * INV_PI, 0.0)


def _microfacet_fresnel(lobe: Lobe, cos_i):
    # dielectric lanes feed the conductor branch eta = k = 1, not their zero
    # f1, f2: its sqrt of 0 would turn the zero gradient of the unselected
    # branch into NaN (the values it selects are unchanged)
    cond = lobe.fr_conductor[..., None]
    f_cond = fresnel_conductor(cos_i, 1.0, _w(cond, lobe.f1, 1.0),
                               _w(cond, lobe.f2, 1.0))
    f_diel = fresnel_dielectric(cos_i, lobe.fr_eta_i, lobe.fr_eta_t)[..., None]
    return torch.where(cond, f_cond, f_diel)


def _eval_microfacet(lobe: Lobe, wo, wi, mf_kinds=None):
    """Torrance-Sparrow (reference: src/bsdf.cc:35-50)."""
    cos_o = torch.abs(wo[..., 2])
    cos_i = torch.abs(wi[..., 2])
    wh_raw = wo + wi
    degenerate = (cos_o < 1e-9) | (cos_i < 1e-9) | (dot(wh_raw, wh_raw) < 1e-18)
    wh = normalize(wh_raw)
    wh_ff = face_forward(wh, unit(wh, 2))
    fr = _microfacet_fresnel(lobe, dot(wi, wh_ff))
    d_term = mf.d(lobe.mf_kind, wh, lobe.a0, lobe.a1, mf_kinds)
    g_term = mf.g(lobe.mf_kind, wo, wi, lobe.a0, lobe.a1, mf_kinds)
    f = lobe.f0 * (d_term * g_term)[..., None] * fr / torch.clamp_min(
        4.0 * cos_i * cos_o, 1e-12)[..., None]
    return _w(degenerate[..., None], 0.0, f)


def _pdf_microfacet(lobe: Lobe, wo, wi, mf_kinds=None):
    ok = _same_hemisphere(wo, wi)
    wh = normalize(wo + wi)
    p = mf.pdf_wh(lobe.mf_kind, wo, wh, lobe.a0, lobe.a1, mf_kinds) \
        / torch.clamp_min(4.0 * dot(wo, wh), 1e-12)
    return _w(ok & (dot(wo, wh) > 0.0), p, 0.0)


def _trans_eta(lobe: Lobe, wo):
    eta_a = lobe.fr_eta_i
    eta_b = lobe.fr_eta_t
    return torch.where(wo[..., 2] > 0.0, eta_b / eta_a, eta_a / eta_b)


def _eval_microfacet_trans(lobe: Lobe, wo, wi, mf_kinds=None):
    """Walter-style transmissive microfacet (reference: src/bsdf.cc:85-110)."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    eta = _trans_eta(lobe, wo)
    wh = normalize(wo + wi * eta[..., None])
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    dot_o = dot(wo, wh)
    dot_i = dot(wi, wh)
    invalid = (_same_hemisphere(wo, wi) | (torch.abs(cos_o) < 1e-9)
               | (torch.abs(cos_i) < 1e-9) | (dot_o * dot_i > 0.0))
    fr = fresnel_dielectric(dot_o, lobe.fr_eta_i, lobe.fr_eta_t)
    sqrt_denom = dot_o + eta * dot_i
    d_term = mf.d(lobe.mf_kind, wh, lobe.a0, lobe.a1, mf_kinds)
    g_term = mf.g(lobe.mf_kind, wo, wi, lobe.a0, lobe.a1, mf_kinds)
    factor = 1.0 / torch.clamp_min(eta, 1e-6)
    mag = torch.abs(
        d_term * g_term * eta * eta * torch.abs(dot_i) * torch.abs(dot_o)
        * factor * factor
        / torch.clamp_min(torch.abs(cos_i * cos_o) * sqrt_denom * sqrt_denom,
                          1e-12))
    f = lobe.f0 * ((1.0 - fr) * mag)[..., None]
    return _w(invalid[..., None], 0.0, f)


def _pdf_microfacet_trans(lobe: Lobe, wo, wi, mf_kinds=None):
    eta = _trans_eta(lobe, wo)
    wh = normalize(wo + wi * eta[..., None])
    dot_o = dot(wo, wh)
    dot_i = dot(wi, wh)
    invalid = _same_hemisphere(wo, wi) | (dot_o * dot_i > 0.0)
    sqrt_denom = dot_o + eta * dot_i
    dwh_dwi = torch.abs(eta * eta * dot_i) / torch.clamp_min(
        sqrt_denom * sqrt_denom, 1e-12)
    wh_up = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    p = mf.pdf_wh(lobe.mf_kind, wo, wh_up, lobe.a0, lobe.a1, mf_kinds) * dwh_dwi
    return _w(invalid, 0.0, p)


def _sample_microfacet_trans(lobe: Lobe, wo, u, mf_kinds=None):
    """(reference: src/bsdf.cc:128-145)"""
    wh = mf.sample_wh(lobe.mf_kind, wo, lobe.a0, lobe.a1, u, mf_kinds)
    eta_s = torch.where(wo[..., 2] > 0.0, lobe.fr_eta_i / lobe.fr_eta_t,
                        lobe.fr_eta_t / lobe.fr_eta_i)
    wi, refr_ok = refract(wo, wh, eta_s)
    wi = normalize(wi)
    ok = (dot(wo, wh) >= 0.0) & refr_ok & (torch.abs(wo[..., 2]) > 1e-9)
    # the reference evaluates both distributions here and selects by kind;
    # pruning to mf_kinds gives every lane the same value
    f = _eval_microfacet_trans(lobe, wo, wi, mf_kinds)
    p = _pdf_microfacet_trans(lobe, wo, wi, mf_kinds)
    return wi, _w(ok[..., None], f, 0.0), _w(ok, p, 0.0)


def _eval_phong(lobe: Lobe, wo, wi):
    """Energy-conserving modified Phong (reference: src/bsdf.h:569-580)."""
    ok = _same_hemisphere(wo, wi)
    cos_alpha = dot(_flip_z(wo), wi)
    pos = cos_alpha > 0.0
    base = _w(pos, cos_alpha, 0.5)
    rho = lobe.f0 * ((lobe.a0 + 2.0) * INV_2PI)[..., None]
    f = rho * _w(pos, torch.pow(base, torch.clamp_min(lobe.a0, 1e-6)),
                 0.0)[..., None]
    return _w(ok[..., None], f, 0.0)


def _pdf_phong(lobe: Lobe, wo, wi):
    cos_t = dot(_flip_z(wo), wi)
    pos = cos_t > 0.0
    base = _w(pos, cos_t, 0.5)
    p = (lobe.a0 + 1.0) * torch.pow(base, torch.clamp_min(lobe.a0, 1e-6)) \
        * INV_2PI
    return _w(pos, p, 0.0)


def eval_f(lobe: Lobe, wo, wi, lobes=None, mf_kinds=None) -> torch.Tensor:
    """Local-frame f; delta lobes evaluate to 0."""
    lobes = ALL_LOBES if lobes is None else lobes
    lobe = _sanitize(lobe)
    out = torch.zeros_like(wo)
    if LOBE_LAMBERT in lobes:
        out = torch.where((lobe.kind == LOBE_LAMBERT)[..., None],
                          _eval_lambert(lobe, wo, wi), out)
    if LOBE_MICROFACET in lobes:
        out = torch.where((lobe.kind == LOBE_MICROFACET)[..., None],
                          _eval_microfacet(lobe, wo, wi, mf_kinds), out)
    if LOBE_PHONG in lobes:
        out = torch.where((lobe.kind == LOBE_PHONG)[..., None],
                          _eval_phong(lobe, wo, wi), out)
    if LOBE_MICROFACET_TRANS in lobes:
        out = torch.where((lobe.kind == LOBE_MICROFACET_TRANS)[..., None],
                          _eval_microfacet_trans(lobe, wo, wi, mf_kinds), out)
    return out


def pdf(lobe: Lobe, wo, wi, lobes=None, mf_kinds=None) -> torch.Tensor:
    lobes = ALL_LOBES if lobes is None else lobes
    lobe = _sanitize(lobe)
    out = torch.zeros_like(wo[..., 0])
    if LOBE_LAMBERT in lobes:
        out = torch.where(lobe.kind == LOBE_LAMBERT, _pdf_lambert(wo, wi), out)
    if LOBE_MICROFACET in lobes:
        out = torch.where(lobe.kind == LOBE_MICROFACET,
                          _pdf_microfacet(lobe, wo, wi, mf_kinds), out)
    if LOBE_PHONG in lobes:
        out = torch.where(lobe.kind == LOBE_PHONG, _pdf_phong(lobe, wo, wi), out)
    if LOBE_MICROFACET_TRANS in lobes:
        out = torch.where(lobe.kind == LOBE_MICROFACET_TRANS,
                          _pdf_microfacet_trans(lobe, wo, wi, mf_kinds), out)
    return out


def _sample_lambert(lobe: Lobe, wo, u):
    wi = sample_cosine_hemisphere(u)
    wi = torch.where((wo[..., 2] < 0.0)[..., None],
                     _negate_z(wi), wi)
    return wi, _eval_lambert(lobe, wo, wi), _pdf_lambert(wo, wi)


def _sample_specular(lobe: Lobe, wo):
    wi = _flip_z(wo)
    f = lobe.f0 / torch.clamp_min(torch.abs(wi[..., 2]), 1e-9)[..., None]
    return wi, f, torch.ones_like(wo[..., 0])


def _sample_fresnel(lobe: Lobe, wo, u):
    """Glass: pick reflection with probability F, else refraction
    (reference: src/bsdf.h:480-540)."""
    eta_i = torch.ones_like(lobe.a0)
    eta_t = lobe.a0
    cos_o = wo[..., 2]
    F = fresnel_dielectric(cos_o, eta_i, eta_t)
    pick_reflect = u[..., 0] < F

    wi_r = _flip_z(wo)
    f_r = lobe.f0 * F[..., None] / torch.clamp_min(
        torch.abs(wi_r[..., 2]), 1e-9)[..., None]

    entering = cos_o > 0.0
    one = torch.ones_like(cos_o)
    nz = torch.where(entering, one, -one)
    n_loc = torch.stack([torch.zeros_like(nz), torch.zeros_like(nz), nz],
                        dim=-1)
    e_i = torch.where(entering, eta_i, eta_t)
    e_t = torch.where(entering, eta_t, eta_i)
    eta = e_i / e_t
    wi_t, ok = refract(wo, n_loc, eta)
    ft = lobe.f1 * ((1.0 - F) * eta * eta)[..., None]
    f_t = _w(ok[..., None],
             ft / torch.clamp_min(torch.abs(wi_t[..., 2]), 1e-9)[..., None], 0.0)

    wi = torch.where(pick_reflect[..., None], wi_r, wi_t)
    f = torch.where(pick_reflect[..., None], f_r, f_t)
    p = torch.where(pick_reflect, F, _w(ok, 1.0 - F, 0.0))
    return wi, f, p


def _sample_microfacet(lobe: Lobe, wo, u, mf_kinds=None):
    """(reference: src/bsdf.cc:59-78)"""
    wh = mf.sample_wh(lobe.mf_kind, wo, lobe.a0, lobe.a1, u, mf_kinds)
    wi = -wo + 2.0 * dot(wo, wh)[..., None] * wh
    ok = ((dot(wo, wh) >= 0.0) & _same_hemisphere(wo, wi)
          & (torch.abs(wo[..., 2]) > 1e-9))
    f = _eval_microfacet(lobe, wo, wi, mf_kinds)
    p = mf.pdf_wh(lobe.mf_kind, wo, wh, lobe.a0, lobe.a1, mf_kinds) \
        / torch.clamp_min(4.0 * dot(wo, wh), 1e-12)
    return wi, _w(ok[..., None], f, 0.0), _w(ok, p, 0.0)


def _sample_phong(lobe: Lobe, wo, u):
    """Cosine lobe about the mirror direction (reference: src/bsdf.h:590-622)."""
    phi = 2.0 * PI * u[..., 0]
    ex = torch.clamp_min(lobe.a0, 1e-6)
    cos_t = torch.pow(torch.clamp_min(u[..., 1], 1e-12), 1.0 / (ex + 1.0))
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t],
                        dim=-1)
    wi = to_world(frame_from_z(_flip_z(wo)), local)
    wi = torch.where((wo[..., 2] < 0.0)[..., None],
                     _negate_z(wi), wi)
    return wi, _eval_phong(lobe, wo, wi), _pdf_phong(lobe, wo, wi)


def sample(lobe: Lobe, wo, u, lobes=None, mf_kinds=None) -> BSDFSample:
    """Sample every present lobe kind and select by tag; u: [N,2]."""
    lobes = ALL_LOBES if lobes is None else lobes
    lobe = _sanitize(lobe)
    samplers = {
        LOBE_LAMBERT: lambda: _sample_lambert(lobe, wo, u),
        LOBE_SPECULAR: lambda: _sample_specular(lobe, wo),
        LOBE_FRESNEL: lambda: _sample_fresnel(lobe, wo, u),
        LOBE_MICROFACET: lambda: _sample_microfacet(lobe, wo, u, mf_kinds),
        LOBE_PHONG: lambda: _sample_phong(lobe, wo, u),
        LOBE_MICROFACET_TRANS: lambda: _sample_microfacet_trans(lobe, wo, u,
                                                                mf_kinds),
    }
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(wo)
    p = torch.zeros_like(wo[..., 0])
    for k in lobes:
        wi_k, f_k, p_k = samplers[k]()
        sel = lobe.kind == k
        wi = torch.where(sel[..., None], wi_k, wi)
        f = torch.where(sel[..., None], f_k, f)
        p = torch.where(sel, p_k, p)
    return BSDFSample(wi=wi, f=f, pdf=p, is_specular=is_delta(lobe))
