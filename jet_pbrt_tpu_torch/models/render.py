"""Render orchestration: drive waves of (sample, pixel) lanes through the
path integrator and accumulate the film on the device.

PyTorch counterpart of jet_pbrt_tpu/models/render.py::render. A wave holds
whole samples of the frame (or, for frames larger than a wave, a pixel
range of one sample), so the film is summed without atomics and the image
does not depend on the wave size: every uniform is keyed by (seed, sample,
pixel) alone.
"""
from __future__ import annotations

import torch

from ..ops import rng
from . import camera as camera_mod
from .integrators import li_path

DEFAULT_CHUNK = 1 << 20


def _waves(n_pixels: int, spp: int, chunk: int):
    """(first sample, n samples, first pixel, n pixels) per wave."""
    if chunk >= n_pixels:
        per = max(1, chunk // n_pixels)
        for s0 in range(0, spp, per):
            yield s0, min(per, spp - s0), 0, n_pixels
    else:
        for s in range(spp):
            for p0 in range(0, n_pixels, chunk):
                yield s, 1, p0, min(chunk, n_pixels - p0)


def n_waves(width: int, height: int, spp: int, chunk: int = DEFAULT_CHUNK):
    """How many integrator waves `render` runs for this frame."""
    return sum(1 for _ in _waves(width * height, spp, chunk))


def render(scene, width: int, height: int, spp: int, seed: int = 0,
           max_depth: int = 5, chunk: int = DEFAULT_CHUNK, clamp: bool = True,
           device=None, with_stats: bool = False,
           sort_rays: bool | None = None):
    """Full-frame render -> linear [H,W,3] float32 tensor on `device`
    (averaged over spp, optionally clamped like the reference's film write,
    reference: src/integrator.cc:108). with_stats also returns the counts
    of `li_path` (rays by class, the sweep kernel's counters), summed over
    the frame, as Python ints. sort_rays is li_path's (default: on for
    kernel-routed scenes). device defaults to the card and raises where
    there is none; the CPU runs only when asked (device="cpu")."""
    device = camera_mod.resolve_device(device)
    pack = scene.pack.to(device)
    cam = camera_mod.make_camera(scene.camera.lookfrom, scene.camera.front,
                                 scene.camera.vup, scene.camera.vfov,
                                 (width, height), device=device)
    n_pixels = width * height
    film = torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)
    stats = {}
    for s0, ns, p0, npx in _waves(n_pixels, spp, chunk):
        sample = torch.arange(s0, s0 + ns, device=device).repeat_interleave(npx)
        pixel = torch.arange(p0, p0 + npx, device=device).repeat(ns)
        keys = rng.lane_keys(seed, sample, pixel)
        jitter = rng.camera_jitter(keys)
        x = (pixel % width).to(torch.float32) + jitter[:, 0]
        y = (pixel // width).to(torch.float32) + jitter[:, 1]
        o, d = camera_mod.generate_rays(cam, torch.stack([x, y], dim=-1))
        out = li_path(scene.meta, pack, o, d, keys, max_depth,
                      with_stats=with_stats, sort_rays=sort_rays)
        if with_stats:
            out, st = out
            for k, v in st.items():
                stats[k] = stats.get(k, 0) + v
        film[p0:p0 + npx] += out.view(ns, npx, 3).sum(0)
    img = (film / spp).view(height, width, 3)
    if clamp:
        img = torch.clamp(img, 0.0, 1.0)
    if with_stats:
        return img, {k: int(v) for k, v in stats.items()}
    return img
