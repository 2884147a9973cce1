"""Ray reordering between bounces: liveness compaction and coherence sorting.

PyTorch counterpart of jet_pbrt_tpu/ops/sort.py. Lanes are permuted (never
removed) so that dead lanes cluster at the tail, where the sweep kernel
retires an all-dead 128-ray packet after one test, and live lanes sort by
origin Morton code and direction octant, so that a packet's rays cull to
nearly the same groups. Keys are int32 tensors equal to the reference's;
callers sort them with `torch.argsort(..., stable=True)`, which gives
`jnp.argsort`'s permutation. The permutation never changes the estimate.
These are the plain versions of ops/rays.py::shadow_key, whose kernel
computes the shadow and between-bounce keys on the card.
"""
from __future__ import annotations

import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 7 bits of x so there are 2 zero bits between each."""
    x = x & 0x7F
    x = (x | (x << 8)) & 0x0700F
    x = (x | (x << 4)) & 0x430C3
    x = (x | (x << 2)) & 0x49249
    return x


def morton3(q: torch.Tensor) -> torch.Tensor:
    """21-bit Morton code from [N,3] integer coords in [0, 127]."""
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))


def _cells(o, world_lo, world_inv) -> torch.Tensor:
    """[N,3] int32 cells of a 128^3 grid over the world box (clamped
    before the cast, which for finite values equals the reference's
    truncate-then-clip)."""
    x = (o - world_lo) * world_inv * 128.0
    return torch.clamp(x, 0.0, 127.0).to(torch.int32)


def _octant(d) -> torch.Tensor:
    return ((d[:, 0] > 0).to(torch.int32) | ((d[:, 1] > 0).to(torch.int32) << 1)
            | ((d[:, 2] > 0).to(torch.int32) << 2))


def ray_sort_key(active, o, d, world_lo, world_inv,
                 needs_bvh=None) -> torch.Tensor:
    """Sort key per lane: (dead, [no-BVH-work], origin Morton, octant).

    world_lo: [3] scene box min; world_inv: [3] 1/extent. Dead lanes get
    the largest key; live lanes whose ray cannot touch any BVH root sphere
    (needs_bvh False) sort behind those that can."""
    key = (morton3(_cells(o, world_lo, world_inv)) << 3) | _octant(d)
    if needs_bvh is not None:
        key = key | torch.where(needs_bvh, 0, 1 << 25).to(torch.int32)
    return torch.where(active, key, torch.full_like(key, 1 << 26))


def bvh_needed(meta, pack, o, d, tmin, tmax) -> torch.Tensor:
    """[N] bool: could the ray segment touch any BVH root sphere (the soup's
    and every instance's)? Conservative: the slack over-includes only."""
    need = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)

    def seg_hits_sphere(c, r):
        oc = c[None, :] - o
        tc = (oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1]) + oc[:, 2] * d[:, 2]
        m2 = ((oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1])
              + oc[:, 2] * oc[:, 2]) - tc * tc
        return ((m2 <= r * r * 1.0001 + 1e-5) & (tc + r >= tmin)
                & (tc - r <= tmax) & (tmax >= tmin))

    if meta.use_bvh and meta.n_tri:
        root = pack.bvh_s_root
        need = need | seg_hits_sphere(root[0:3], root[5])
    for mi in range(len(meta.n_inst)):
        root = pack.inst_s_root[mi]
        for i in range(meta.n_inst[mi]):
            scale = pack.inst_scale[mi][i]
            need = need | seg_hits_sphere(
                root[0:3] * scale + pack.inst_off[mi][i], root[5] * scale)
    return need


def shadow_sort_key(meta, pack, alive, o, d, tmin, tmax) -> torch.Tensor:
    """Shadow-batch key: (dead, no-BVH-work, direction octant, origin
    Morton): octant-major, since shadow origins are already coherent from
    the parent sort."""
    need = bvh_needed(meta, pack, o, d, tmin, tmax)
    world_lo = pack.world_center - pack.world_radius
    world_inv = 1.0 / torch.clamp_min(2.0 * pack.world_radius, 1e-12)
    key = (morton3(_cells(o, world_lo, world_inv)) | (_octant(d) << 21)
           | torch.where(need, 0, 1 << 24).to(torch.int32))
    return torch.where(alive, key, torch.full_like(key, 1 << 30))
