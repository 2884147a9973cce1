"""Batched 3-vector math on `[..., 3]` float32 tensors.

PyTorch counterpart of jet_pbrt_tpu/ops/linalg.py. Every function keeps the
reference's operation order (products summed left to right, crosses through
`torch.linalg.cross`, which rounds like `jnp.cross`), so the two packages
agree to the last bit on the CPU wherever XLA does not fuse.

Frozen copy of jet_pbrt_tpu_torch/ops/linalg.py at commit 77f45ea, the
benchmark's plain reference: later changes to the program do not move it.
"""
from __future__ import annotations

import math

import torch

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_2PI = 1.0 / (2.0 * PI)
INV_4PI = 1.0 / (4.0 * PI)
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
EPSILON = 1e-4
INFINITY = math.inf
# the reference renderer's fixed ray t_min and shadow epsilon (reference:
# src/geometry.h:395); scenes use the scale-relative ScenePack.ray_eps =
# RAY_EPS_REL x diameter
RAY_EPS = 1e-3
RAY_EPS_REL = 1.25e-6


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of [..., 3] tensors -> [...]."""
    return torch.sum(a * b, dim=-1)


def absdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(dot(a, b))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length2(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length2(a))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)), with the double-where form of the reference."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors stay (near) zero instead of NaN."""
    return a * torch.reciprocal(torch.clamp_min(length(a), eps))[..., None]


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length(a - b)


def distance2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length2(a - b)


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into v's hemisphere (reference: src/bsdf.h:23-26)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def refract(wi: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction; returns (wt, ok), ok=False on total internal
    reflection (reference: src/bsdf.h:70-88). eta = eta_i / eta_t."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = eta[..., None] * (-wi) + (eta * cos_i - cos_t)[..., None] * n
    return wt, ok


def unit(like: torch.Tensor, i: int) -> torch.Tensor:
    """The unit axis e_i broadcast to like's [..., 3] shape, made on like's
    device by a kernel (torch.eye): a tensor copied from host data would
    synchronise with the card, which a CUDA graph's capture refuses."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i].expand(
        like.shape)


def frame_from_z(n: torch.Tensor):
    """Orthonormal basis (s, t, n) around unit normal n, with the per-lane
    |x| > 0.99 helper-axis pick (reference: src/geometry.h:372-377)."""
    nx = torch.abs(n[..., 0])
    helper = torch.where((nx > 0.99)[..., None], unit(n, 1), unit(n, 0))
    t = normalize(cross(n, helper))
    s = normalize(cross(t, n))
    return s, t, n


def to_local(frame, v: torch.Tensor) -> torch.Tensor:
    s, t, n = frame
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(frame, v: torch.Tensor) -> torch.Tensor:
    s, t, n = frame
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def spherical_direction(sin_theta, cos_theta, phi) -> torch.Tensor:
    """z-up spherical to cartesian (reference: src/geometry.h:203-208)."""
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma (reference: src/color.h:47-50)."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def max_component(c: torch.Tensor) -> torch.Tensor:
    return torch.amax(c, dim=-1)


def is_black(c: torch.Tensor) -> torch.Tensor:
    return torch.all(c == 0.0, dim=-1)
