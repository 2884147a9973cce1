"""The program's random streams, in int64 tensor ops.

Frozen copy of the plain versions in jet_pbrt_tpu_torch/ops/rng.py at
commit 77f45ea (jax.random's threefry derivation, bit for bit). Every
uniform is a pure function of (seed, global sample index, pixel id,
purpose, slot):

    key(seed)        = (0, seed)
    fold_in(k, x)    = T(k, (0, x)), both output words
    lane key         = fold_in(fold_in(key(seed), sample), pixel)
    uniform(k, (S,)) : (x0, x1) = T(k, (0, i)) for slot i,
                       u_i = bitcast_f32(((x0 ^ x1) >> 9) | 0x3F800000) - 1
    a purpose's draw = uniform(fold_in(lane key, purpose), (S,))

Stream layout per path vertex: [0] lobe pick, [1 : 1+2L] two uniforms per
scene light for NEE, [1+2L : 3+2L] BSDF sampling, [3+2L] the roulette coin.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PURPOSE_CAMERA = 0
PURPOSE_PATH_BASE = 16

_MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000


class LaneKeys(NamedTuple):
    k0: torch.Tensor       # [N] int64 holding a 32-bit word
    k1: torch.Tensor       # [N] int64


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 on int64 tensors holding 32-bit words."""
    k0 = k0 & _MASK
    k1 = k1 & _MASK
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for i in range(20):
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, _ROT[i % 8]) ^ x0
        if i % 4 == 3:
            s = (i + 1) // 4
            x0 = (x0 + ks[s % 3]) & _MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & _MASK
    return x0, x1


def lane_keys(seed: int, sample: torch.Tensor,
              pixel: torch.Tensor) -> LaneKeys:
    """fold_in(fold_in(key(seed), sample), pixel) of [N] int64 tensors."""
    zero = torch.zeros_like(pixel)
    b0, b1 = threefry2x32(zero, zero + (int(seed) & _MASK), zero,
                          sample & _MASK)
    k0, k1 = threefry2x32(b0, b1, zero, pixel & _MASK)
    return LaneKeys(k0, k1)


def uniforms(keys: LaneKeys, purpose: int, n: int,
             dtype=torch.float32) -> torch.Tensor:
    """[N, n] uniforms in [0, 1): jax.random.uniform(fold_in(key, purpose),
    (n,)) of every lane, made in float32 and cast to dtype."""
    zero = torch.zeros_like(keys.k0)
    f0, f1 = threefry2x32(keys.k0, keys.k1, zero,
                          zero + (int(purpose) & _MASK))
    slot = torch.arange(n, dtype=torch.int64, device=keys.k0.device)[None, :]
    x0, x1 = threefry2x32(f0[:, None], f1[:, None], torch.zeros_like(slot),
                          slot)
    bits = ((x0 ^ x1) >> 9) | _ONE_BITS
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u.to(dtype)


def vertex_uniforms(keys: LaneKeys, bounce: int, n_lights: int,
                    dtype=torch.float32) -> torch.Tensor:
    return uniforms(keys, PURPOSE_PATH_BASE + bounce, 4 + 2 * n_lights, dtype)


def stream_lobe(u):
    return u[..., 0]


def stream_nee(u, light_index: int):
    return u[..., 1 + 2 * light_index: 3 + 2 * light_index]


def stream_bsdf(u, n_lights: int):
    base = 1 + 2 * n_lights
    return u[..., base: base + 2]


def stream_rr(u, n_lights: int):
    return u[..., 3 + 2 * n_lights]
