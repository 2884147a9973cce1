"""Fresnel reflectance terms, batched.

PyTorch counterpart of jet_pbrt_tpu/ops/fresnel.py
(reference: src/bsdf.h:91-197, src/bsdf.cc:15-24).

Frozen copy of jet_pbrt_tpu_torch/ops/fresnel.py at commit 77f45ea, the
benchmark's plain reference: later changes to the program do not move it.
"""
from __future__ import annotations

import torch

from .linalg import safe_sqrt


def fresnel_dielectric(cos_theta_i: torch.Tensor, eta_i, eta_t) -> torch.Tensor:
    """Unpolarized dielectric Fresnel; a negative cosine swaps the etas
    (reference: src/bsdf.h:91-122)."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    eta_i = torch.as_tensor(eta_i, dtype=ci.dtype, device=ci.device)
    eta_t = torch.as_tensor(eta_t, dtype=ci.dtype, device=ci.device)
    e_i = torch.where(entering, eta_i, eta_t)
    e_t = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(ci)
    sin_t = e_i / e_t * safe_sqrt(1.0 - ci * ci)
    tir = sin_t >= 1.0
    ct = safe_sqrt(1.0 - sin_t * sin_t)
    r_parl = (e_t * ci - e_i * ct) / torch.clamp_min(e_t * ci + e_i * ct, 1e-20)
    r_perp = (e_i * ci - e_t * ct) / torch.clamp_min(e_i * ci + e_t * ct, 1e-20)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(f), f)


def fresnel_conductor(cos_theta_i: torch.Tensor, eta_i, eta_t, k) -> torch.Tensor:
    """Complex-IOR conductor Fresnel per channel; eta_t, k are [..., 3]
    (reference: src/bsdf.h:174-197)."""
    c = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    eta = eta_t / eta_i
    etak = k / eta_i
    c2 = c * c
    s2 = 1.0 - c2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - s2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * eta2 * etak2, 0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-20)
    return 0.5 * (rp + rs)
