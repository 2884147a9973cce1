"""Pinhole camera: a small tuple of tensors and a batched ray generator.

PyTorch counterpart of jet_pbrt_tpu/models/camera.py (reference:
src/camera.h:36-58), with the reference package's [-1, 1] film span so
vfov is the true vertical field of view.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg


class Camera(NamedTuple):
    position: torch.Tensor    # [3]
    front: torch.Tensor       # [3] unit
    right: torch.Tensor       # [3] scaled by tan(fov/2) * aspect
    up: torch.Tensor          # [3] scaled by tan(fov/2)
    resolution: torch.Tensor  # [2] (width, height)


def resolve_device(device) -> torch.device:
    """`device`, or the card when it is None. Asking for the card where
    there is none raises: nothing falls back to the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return device


def make_camera(lookfrom, front, vup, vfov_degrees, resolution,
                device=None) -> Camera:
    """Scaled basis (reference: src/camera.h:44-48), derived in float64, on
    `device` (default: the card)."""
    device = resolve_device(device)
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
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Camera(position=t(lookfrom), front=t(front), right=t(right),
                  up=t(up), resolution=t([w, h]))


def generate_rays(camera: Camera, film_xy: torch.Tensor):
    """Batched GenerateRay (reference: src/camera.h:52-58); film_xy [N,2]
    is pixel + jitter. Returns origins and unit directions, both [N,3]."""
    w = camera.resolution[0]
    h = camera.resolution[1]
    sx = 2.0 * (film_xy[:, 0] / w - 0.5)
    sy = 2.0 * (0.5 - film_xy[:, 1] / h)
    d = (camera.front[None, :] + camera.right[None, :] * sx[:, None]
         + camera.up[None, :] * sy[:, None])
    d = linalg.normalize(d)
    o = camera.position[None, :].expand(d.shape).contiguous()
    return o, d
