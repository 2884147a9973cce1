"""Film: a float64 [H, W, 3] radiance accumulator on the device.

PyTorch counterpart of jet_pbrt_tpu/models/film.py (reference:
src/film.h:27-136), accumulating as the reference package's `render` does
(render.py:76-87): each sample's float32 colours are added in float64, in
sample order, and the mean is cast to float32 before the optional clamp.
The film is updated in place (one [H, W, 3] float64 tensor per frame).
"""
from __future__ import annotations

import torch

from ..utils import image as image_io


def new_film(width: int, height: int, device=None) -> torch.Tensor:
    return torch.zeros((height, width, 3), dtype=torch.float64, device=device)


def add_samples(film: torch.Tensor, colors: torch.Tensor,
                first_pixel: int = 0) -> torch.Tensor:
    """Add one sample's colours [n, 3] (row-major pixels from first_pixel)
    to the film in float64, in place; returns the film."""
    flat = film.view(-1, 3)
    flat[first_pixel:first_pixel + colors.shape[0]] += colors.to(torch.float64)
    return film


def finalize(film: torch.Tensor, spp: int, clamp: bool = True) -> torch.Tensor:
    """The mean over spp in float64, cast to float32, optionally clamped to
    [0, 1] like the reference's film write (reference:
    src/integrator.cc:108)."""
    img = (film / spp).to(torch.float32)
    if clamp:
        img = torch.clamp(img, 0.0, 1.0)
    return img


def save(film_or_img, path_base: str, fmt: str = "bmp") -> str:
    """Write an [H, W, 3] image (a tensor on any device, or numpy) as
    path_base.<fmt>; returns the path."""
    if isinstance(film_or_img, torch.Tensor):
        film_or_img = film_or_img.detach().cpu().numpy()
    return image_io.save_image(path_base, film_or_img, fmt)
