"""Texture taps: solid, 3D sine checker, and image (nearest and bilinear).

PyTorch counterpart of jet_pbrt_tpu/ops/texture.py (the reference's
FTexture hierarchy, src/texture.h and src/texture.cc, wired into
materials). All textures live in one padded [K, TH, TW, 3] table; a tap is
plain indexing and lerps, so the texels stay on the autograd tape.
"""
from __future__ import annotations

import torch

from . import linalg

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2           # nearest texel (reference: src/texture.cc:38-74)
TEX_IMAGE_BILINEAR = 3


def _sample_checker(c0, c1, scale, p):
    """3D sine checker at the world position (reference:
    src/texture.cc:26-35)."""
    s = (torch.sin(scale * p[..., 0]) * torch.sin(scale * p[..., 1])
         * torch.sin(scale * p[..., 2]))
    return torch.where((s < 0.0)[..., None], c0, c1)


def _wrap_uv(uv):
    """Clamped lookup (reference: src/texture.cc:55-60)."""
    return torch.clamp(uv, 0.0, 1.0)


def _texel(images, wh, tex_id, xi, yi):
    """images[tex_id, yi, xi] with both indices clamped into the texture's
    own (w, h)."""
    xi = torch.minimum(torch.clamp_min(xi, 0), wh[tex_id, 0] - 1)
    yi = torch.minimum(torch.clamp_min(yi, 0), wh[tex_id, 1] - 1)
    _, th, tw, _ = images.shape
    flat = (tex_id * th + yi.to(torch.int64)) * tw + xi.to(torch.int64)
    return linalg.gather_rows(images.reshape(-1, 3), flat)


def _sample_image_nearest(images, wh, tex_id, uv):
    uv = _wrap_uv(uv)
    w = wh[tex_id, 0].to(torch.float32)
    h = wh[tex_id, 1].to(torch.float32)
    # v-flip (reference: src/texture.cc:63)
    x = (uv[..., 0] * w).to(torch.int32)
    y = ((1.0 - uv[..., 1]) * h).to(torch.int32)
    return _texel(images, wh, tex_id, x, y)


def _sample_image_bilinear(images, wh, tex_id, uv):
    uv = _wrap_uv(uv)
    w = wh[tex_id, 0].to(torch.float32)
    h = wh[tex_id, 1].to(torch.float32)
    fx = uv[..., 0] * w - 0.5
    fy = (1.0 - uv[..., 1]) * h - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = (fx - x0.to(torch.float32))[..., None]
    ty = (fy - y0.to(torch.float32))[..., None]
    a = _texel(images, wh, tex_id, x0, y0)
    b = _texel(images, wh, tex_id, x0 + 1, y0)
    c = _texel(images, wh, tex_id, x0, y0 + 1)
    d = _texel(images, wh, tex_id, x0 + 1, y0 + 1)
    return (a * (1 - tx) + b * tx) * (1 - ty) + (c * (1 - tx) + d * tx) * ty


def sample(pack, tex_id, uv, p):
    """Texture `tex_id` [N] at hit uv [N,2] and position p [N,3] -> [N,3].
    tex_id must be a valid row (callers select -1 away outside)."""
    tex_id = tex_id.to(torch.int64)
    kind, c0, c1, scale = (linalg.gather_rows(t, tex_id) for t in (
        pack.tex_kind, pack.tex_c0, pack.tex_c1, pack.tex_scale))
    out = torch.where((kind == TEX_CHECKER)[..., None],
                      _sample_checker(c0, c1, scale, p), c0)
    if pack.tex_image.shape[0]:
        out = torch.where((kind == TEX_IMAGE)[..., None],
                          _sample_image_nearest(pack.tex_image, pack.tex_wh,
                                                tex_id, uv), out)
        out = torch.where((kind == TEX_IMAGE_BILINEAR)[..., None],
                          _sample_image_bilinear(pack.tex_image, pack.tex_wh,
                                                 tex_id, uv), out)
    return out
