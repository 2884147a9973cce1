"""Counter-based random streams for path tracing: jax.random's, bit for bit.

PyTorch counterpart of jet_pbrt_tpu/ops/rng.py. Every uniform is a pure
function of (seed, global sample index, global pixel id, purpose, slot),
drawn as the reference draws it through jax.random (JAX 0.9.0, threefry
keys with `jax_threefry_partitionable` on, its default), so a port render
equals the reference's for the same seed. With T = Threefry-2x32-20
(Salmon et al. 2011) of a key (k0, k1) and a counter (c0, c1):

    key(seed)        = (0, seed)
    fold_in(k, x)    = T(k, (0, x)), both output words
    lane key         = fold_in(fold_in(key(seed), sample), pixel)
    uniform(k, (S,)) : (x0, x1) = T(k, (0, i)) for slot i,
                       bits = x0 ^ x1,
                       u_i = bitcast_f32((bits >> 9) | 0x3F800000) - 1
    a purpose's draw = uniform(fold_in(lane key, purpose), (S,))

The card's machine has no JAX: this derivation is checked against
jax.random only by the CPU tests (tests/test_torch_rng.py).

Two routes, chosen by the device of the tensors: on the CPU the plain
version (the hash in int64 tensor ops, 32-bit words in the low half); on
the card one launch of csrc/threefry.cu per `lane_keys` and per
`uniforms` call (so per `camera_jitter` and `vertex_uniforms`). A failure
to build or launch there raises.

Stream layout per path vertex (rng.py:21-28 of the reference package):

    [0]              lobe pick
    [1 : 1+2L]       2 uniforms per scene light for NEE
    [1+2L : 3+2L]    2 uniforms for BSDF sampling
    [3+2L]           russian-roulette coin

A path tracer takes either `LaneKeys` or a pregenerated uniform tensor
u: [N, max_depth+1, S] (the debug sampler's, or a test's injected draws).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import kernels
from .kernels import INT, PTR, U32

PURPOSE_CAMERA = 0
PURPOSE_PATH_BASE = 16

_MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000


class LaneKeys(NamedTuple):
    """Per-lane stream keys: the two key words (uint32 bits in int32) and
    the lane's global sample index (the stratified sampler's stratum)."""
    k0: torch.Tensor       # [N] int32
    k1: torch.Tensor       # [N] int32
    sample: torch.Tensor   # [N] int64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 key words -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _MASK


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


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


_LIB = kernels.Library("threefry", ["threefry.cu"], {
    "threefry_lane_keys": [U32, PTR, PTR, INT, PTR, PTR, PTR],
    "threefry_uniforms": [PTR, PTR, INT, U32, INT, PTR, PTR]})


@kernels.wrapper("lane_keys_kernel")
def lane_keys(seed: int, sample, pixel_ids: torch.Tensor) -> LaneKeys:
    """One key per lane, fold_in(fold_in(key(seed), sample), pixel).
    sample: an int or an [N] tensor of global sample indices; pixel_ids:
    [N] global pixel ids (y * width + x). The kernel for CUDA tensors,
    `lane_keys_plain` for CPU tensors."""
    pixel = pixel_ids.to(torch.int64).contiguous()
    if torch.is_tensor(sample):
        sample = sample.to(pixel.device, torch.int64).expand(
            pixel.shape).contiguous()
    else:   # made on the device: a host copy would break a CUDA graph
        sample = torch.full_like(pixel, int(sample))
    # the refusal of an input that requires grad is moot: integer inputs
    if not kernels.route("lane_keys", pixel.device):
        return lane_keys_plain(seed, sample, pixel)
    if pixel.dim() != 1:
        raise ValueError("pixel_ids: expected a [N] tensor")
    n = pixel.shape[0]
    k0 = torch.empty((n,), dtype=torch.int32, device=pixel.device)
    k1 = torch.empty_like(k0)
    if n:
        kernels.launch(lane_keys, pixel.device, _LIB.load().threefry_lane_keys,
                       int(seed) & _MASK, sample.data_ptr(), pixel.data_ptr(),
                       n, k0.data_ptr(), k1.data_ptr())
    return LaneKeys(k0, k1, sample)


def lane_keys_plain(seed: int, sample: torch.Tensor,
                    pixel: torch.Tensor) -> LaneKeys:
    """`lane_keys` in int64 tensor ops."""
    zero = torch.zeros_like(pixel)
    b0, b1 = threefry2x32(zero, zero + (int(seed) & _MASK), zero,
                          sample & _MASK)
    k0, k1 = threefry2x32(b0, b1, zero, pixel & _MASK)
    return LaneKeys(_i32(k0), _i32(k1), sample)


@kernels.wrapper("uniforms_kernel")
def uniforms(keys: LaneKeys, purpose: int, n: int) -> torch.Tensor:
    """[N, n] float32 uniforms in [0, 1): jax.random.uniform(fold_in(key,
    purpose), (n,)) of every lane. The kernel for CUDA tensors,
    `uniforms_plain` for CPU tensors."""
    dev = keys.k0.device
    if not kernels.route("uniforms", dev):
        return uniforms_plain(keys, purpose, n)
    lanes = keys.k0.shape[0]
    kernels.check("k0", keys.k0, torch.int32, (lanes,), dev)
    kernels.check("k1", keys.k1, torch.int32, (lanes,), dev)
    out = torch.empty((lanes, n), dtype=torch.float32, device=dev)
    if lanes and n:
        kernels.launch(uniforms, dev, _LIB.load().threefry_uniforms,
                       keys.k0.data_ptr(), keys.k1.data_ptr(), lanes,
                       int(purpose) & _MASK, n, out.data_ptr())
    return out


def uniforms_plain(keys: LaneKeys, purpose: int, n: int) -> torch.Tensor:
    """`uniforms` in int64 tensor ops."""
    k0, k1 = _u32(keys.k0), _u32(keys.k1)
    zero = torch.zeros_like(k0)
    f0, f1 = threefry2x32(k0, k1, zero, zero + (int(purpose) & _MASK))
    slot = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    x0, x1 = threefry2x32(f0[:, None], f1[:, None], torch.zeros_like(slot),
                          slot)
    bits = ((x0 ^ x1) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def camera_jitter(keys: LaneKeys, sampler: str = "random",
                  spp: int | None = None) -> torch.Tensor:
    """In-pixel jitter [N, 2] (reference: src/sampler.h:148-155).

    sampler: "random" i.i.d. uniforms; "stratified" jittered strata of the
    ceil(sqrt(spp))^2 grid, the stratum of a lane being its sample index
    modulo g^2 (reference package rng.py:78-84); "debug" the constant
    0.5."""
    n = keys.k0.shape[0]
    if sampler == "debug":
        return torch.full((n, 2), 0.5, dtype=torch.float32,
                          device=keys.k0.device)
    u = uniforms(keys, PURPOSE_CAMERA, 2)
    if sampler == "stratified":
        if spp is None:
            raise ValueError("the stratified sampler needs spp")
        g = math.isqrt(spp - 1) + 1 if spp > 0 else 1
        stratum = keys.sample % (g * g)
        s = torch.stack([stratum % g, stratum // g], dim=-1).to(torch.float32)
        return (s + u) / g
    if sampler != "random":
        raise ValueError(f"unknown sampler {sampler!r}")
    return u


def debug_path_uniforms(n: int, max_depth: int, n_lights: int,
                        device=None) -> torch.Tensor:
    """All-0.5 path uniforms [n, max_depth+1, S]: the debug sampler's
    transport streams, taken by the integrators in place of LaneKeys."""
    return torch.full((n, max_depth + 1, 4 + 2 * n_lights), 0.5,
                      dtype=torch.float32, device=device)


def vertex_uniforms(u, bounce: int, n_lights: int) -> torch.Tensor:
    """Per-vertex uniforms [N, S], S = 4 + 2 * n_lights, from LaneKeys or a
    pregenerated [N, max_depth+1, S] tensor."""
    if isinstance(u, LaneKeys):
        return uniforms(u, PURPOSE_PATH_BASE + bounce, 4 + 2 * n_lights)
    return u[:, bounce, :]


def stream_lobe(u_vertex: torch.Tensor) -> torch.Tensor:
    return u_vertex[..., 0]


def stream_nee(u_vertex: torch.Tensor, light_index: int) -> torch.Tensor:
    return u_vertex[..., 1 + 2 * light_index: 3 + 2 * light_index]


def stream_bsdf(u_vertex: torch.Tensor, n_lights: int) -> torch.Tensor:
    base = 1 + 2 * n_lights
    return u_vertex[..., base: base + 2]


def stream_rr(u_vertex: torch.Tensor, n_lights: int) -> torch.Tensor:
    return u_vertex[..., 3 + 2 * n_lights]
