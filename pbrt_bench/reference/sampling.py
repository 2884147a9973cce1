"""Sampling warps, their pdfs, and MIS heuristics over [..., 2] uniforms.

PyTorch counterpart of jet_pbrt_tpu/ops/sampling.py
(reference: src/sampling.h:17-137).

Frozen copy of jet_pbrt_tpu_torch/ops/sampling.py at commit 77f45ea, the
benchmark's plain reference: later changes to the program do not move it.
"""
from __future__ import annotations

import torch

from .linalg import PI, PI_OVER_2, PI_OVER_4


def sample_concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric mapping, both quadrant cases computed and
    selected per lane (reference: src/sampling.h:25-50)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    degenerate = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)

    def safe(v):
        return torch.where(v == 0.0, torch.ones_like(v), v)

    theta = torch.where(use_x, PI_OVER_4 * (oy / safe(ox)),
                        PI_OVER_2 - PI_OVER_4 * (ox / safe(oy)))
    pt = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(degenerate[..., None], torch.zeros_like(pt), pt)


def sample_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Malley's method (reference: src/sampling.h:53-59)."""
    d = sample_concentric_disk(u)
    z = torch.sqrt(torch.clamp_min(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, 0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def sample_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def pdf_uniform_cone(cos_theta_max: torch.Tensor) -> torch.Tensor:
    return 1.0 / (2.0 * PI * torch.clamp_min(1.0 - cos_theta_max, 1e-12))


def sample_uniform_triangle(u: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics (b0, b1) (reference: src/sampling.h:121-125)."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)
