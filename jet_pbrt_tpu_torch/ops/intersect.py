"""Brute-force ray / shape intersection over whole shape batches.

PyTorch counterpart of jet_pbrt_tpu/ops/intersect.py (reference:
src/shape.h). Candidate math is shape-major [M, N]; a "kind hit" is the
per-ray closest (t, index, valid) among the shapes of one kind, and
`merge_hits` min-merges kinds. `brute_hits_plain` is the plain version of
the brute-force kernel (ops/brute.py): every brute-force kind of a scene
in one call.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .linalg import RAY_EPS, cross, dot, normalize

NO_HIT_T = math.inf


class KindHit(NamedTuple):
    t: torch.Tensor      # [N] hit distance (inf if none)
    index: torch.Tensor  # [N] int32 index into the kind's shape arrays
    valid: torch.Tensor  # [N] bool


def check_hit_out(out, n: int, dev) -> None:
    """Raise unless out is None or (t, index, valid): contiguous float32,
    int32 and bool [N] tensors on dev (rows of a cast's slabs)."""
    if out is None:
        return
    for name, x, dtype in zip(("t", "index", "valid"), out,
                              (torch.float32, torch.int32, torch.bool)):
        if x.dtype != dtype or tuple(x.shape) != (n,) \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"out {name}: expected a contiguous {dtype} "
                             f"[{n}] tensor on {dev}")


def _closest_mn(t_mn: torch.Tensor, valid_mn: torch.Tensor) -> KindHit:
    """Reduce [M, N] candidates to the per-ray closest; ties go to the
    lowest shape index, like jnp.argmin."""
    t_masked = torch.where(valid_mn, t_mn, torch.full_like(t_mn, math.inf))
    t = torch.amin(t_masked, dim=0)
    # torch.min's index on ties is unspecified on CUDA: take the first
    first = torch.argmax((t_masked == t[None, :]).to(torch.uint8), dim=0)
    idx = torch.where(torch.isfinite(t), first, torch.zeros_like(first))
    return KindHit(t=t, index=idx.to(torch.int32), valid=torch.isfinite(t))


def _c3(a):
    return a[..., 0], a[..., 1], a[..., 2]


def empty_hit(n: int, device=None) -> KindHit:
    """n misses: t = NO_HIT_T, index 0, not valid."""
    return KindHit(t=torch.full((n,), NO_HIT_T, device=device),
                   index=torch.zeros((n,), dtype=torch.int32, device=device),
                   valid=torch.zeros((n,), dtype=torch.bool, device=device))


def intersect_triangles(o, d, tmin, tmax, p0, p1, p2) -> KindHit:
    """Moller-Trumbore; o, d: [N,3]; p0, p1, p2: [T,3]."""
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))
    p0x, p0y, p0z = (c[:, None] for c in _c3(p0))
    e1x, e1y, e1z = (c[:, None] for c in _c3(p1 - p0))
    e2x, e2y, e2z = (c[:, None] for c in _c3(p2 - p0))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = torch.abs(det) > 1e-12
    inv_det = torch.where(big, 1.0 / det, torch.zeros_like(det))
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin[None, :]) & (t < tmax[None, :]))
    return _closest_mn(t, valid)


def triangle_normal(p0, p1, p2, flip=None) -> torch.Tensor:
    """Face normal per triangle, flipped where `flip` (reference:
    src/shape.h:284-286): one normal per face, as the reference discards
    an OBJ's normals."""
    n = normalize(cross(p1 - p0, p2 - p0))
    if flip is not None:
        n = torch.where(flip[:, None], -n, n)
    return n


def intersect_spheres(o, d, tmin, tmax, center, radius) -> KindHit:
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))
    cx, cy, cz = (c[:, None] for c in _c3(center))
    r = radius[:, None]
    ocx = cx - ox
    ocy = cy - oy
    ocz = cz - oz
    b = ocx * dx + ocy * dy + ocz * dz
    det = b * b - (ocx * ocx + ocy * ocy + ocz * ocz) + r * r
    sq = torch.sqrt(torch.clamp_min(det, 0.0))
    t_near = b - sq
    t_far = b + sq
    in_near = (t_near > tmin[None, :]) & (t_near < tmax[None, :])
    in_far = (t_far > tmin[None, :]) & (t_far < tmax[None, :])
    t = torch.where(in_near, t_near, t_far)
    valid = (det >= 0.0) & (in_near | in_far)
    return _closest_mn(t, valid)


def intersect_rects(o, d, tmin, tmax, q0, q1, q2, q3, n) -> KindHit:
    """Convex-quad sign test (reference: src/shape.h:399-435)."""
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))

    def corner(q):
        qx, qy, qz = (c[:, None] for c in _c3(q))
        return qx - ox, qy - oy, qz - oz

    ax, ay, az = corner(q0)
    bx, by, bz = corner(q1)
    cx, cy, cz = corner(q2)
    ex, ey, ez = corner(q3)

    def cross_dot_d(ux, uy, uz, vx, vy, vz):
        return ((uy * vz - uz * vy) * dx + (uz * vx - ux * vz) * dy
                + (ux * vy - uy * vx) * dz)

    v0d = cross_dot_d(cx, cy, cz, bx, by, bz)
    v1d = cross_dot_d(bx, by, bz, ax, ay, az)
    v2d = cross_dot_d(ax, ay, az, ex, ey, ez)
    v3d = cross_dot_d(ex, ey, ez, cx, cy, cz)
    same_neg = (v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)
    same_pos = (v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0)
    inside = same_neg | same_pos
    nx, ny, nz = (c[:, None] for c in _c3(n))
    denom = nx * dx + ny * dy + nz * dz
    t = torch.where(torch.abs(denom) > 1e-12,
                    (nx * ax + ny * ay + nz * az) / denom,
                    torch.full_like(denom, math.inf))
    valid = inside & (t > tmin[None, :]) & (t < tmax[None, :])
    return _closest_mn(t, valid)


def rect_hit_normal(n_gathered: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Rect normals face the ray (reference: src/shape.h:427)."""
    return torch.where(dot(n_gathered, d)[:, None] <= 0.0, n_gathered,
                       -n_gathered)


def intersect_disks(o, d, tmin, tmax, center, n, radius) -> KindHit:
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))
    cx, cy, cz = (c[:, None] for c in _c3(center))
    nx, ny, nz = (c[:, None] for c in _c3(n))
    denom = nx * dx + ny * dy + nz * dz
    opx = cx - ox
    opy = cy - oy
    opz = cz - oz
    par = torch.abs(denom) > 1e-9
    t = torch.where(par, (nx * opx + ny * opy + nz * opz) / denom,
                    torch.full_like(denom, math.inf))
    hx = ox + t * dx - cx
    hy = oy + t * dy - cy
    hz = oz + t * dz - cz
    r2 = hx * hx + hy * hy + hz * hz
    valid = (par & (t > tmin[None, :]) & (t < tmax[None, :])
             & (r2 <= (radius[:, None] * radius[:, None])))
    return _closest_mn(t, valid)


class BruteShapes(NamedTuple):
    """A scene's brute-force shapes, each kind None where the scene has
    none (or, for triangles, where a BVH kernel takes them)."""
    tri: tuple | None    # (p0, p1, p2), each [T,3]
    sph: tuple | None    # (center [S,3], radius [S])
    rect: tuple | None   # (corners [R,4,3], normal [R,3])
    disk: tuple | None   # (center [D,3], normal [D,3], radius [D])

    @property
    def present(self) -> tuple:
        """The fields of the kinds present, in `_kind_hits` order."""
        return tuple(f for f in self._fields if getattr(self, f) is not None)


def brute_hits_plain(o, d, tmin, tmax, shapes: BruteShapes,
                     any_hit: bool):
    """Every brute-force kind of `shapes` against rays o, d [N,3] in (tmin,
    tmax) [N]: closest mode, one KindHit per kind present in
    `shapes.present` order (the intersect_* functions above); any-hit mode,
    the [N] bool OR of their valid."""
    hits = []
    if shapes.tri is not None:
        hits.append(intersect_triangles(o, d, tmin, tmax, *shapes.tri))
    if shapes.sph is not None:
        hits.append(intersect_spheres(o, d, tmin, tmax, *shapes.sph))
    if shapes.rect is not None:
        q, n = shapes.rect
        hits.append(intersect_rects(o, d, tmin, tmax, q[:, 0], q[:, 1],
                                    q[:, 2], q[:, 3], n))
    if shapes.disk is not None:
        hits.append(intersect_disks(o, d, tmin, tmax, *shapes.disk))
    if not any_hit:
        return hits
    occ = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    for h in hits:
        occ = occ | h.valid
    return occ


def merge_hits(hits: list[KindHit], kinds: list[int]):
    """Min-merge per-kind closest hits -> (t, kind, index, valid); an
    earlier kind keeps a tie."""
    t = hits[0].t
    kind = torch.full_like(hits[0].index, kinds[0])
    index = hits[0].index
    for h, k in zip(hits[1:], kinds[1:]):
        closer = h.t < t
        t = torch.where(closer, h.t, t)
        kind = torch.where(closer, torch.full_like(kind, k), kind)
        index = torch.where(closer, h.index, index)
    return t, kind, index, torch.isfinite(t)


def offset_ray_origin(p: torch.Tensor) -> tuple[torch.Tensor, float]:
    """A spawned ray's origin and tmin: the hit point and RAY_EPS, the
    reference's shadow epsilon (reference: src/geometry.h:395-396)."""
    return p, RAY_EPS
