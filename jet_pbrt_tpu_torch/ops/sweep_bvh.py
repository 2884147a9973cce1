"""Cull-sweep triangle intersection: host-side tables, the Hopper kernel's
wrapper, and its plain PyTorch version.

Replaces the TPU kernel jet_pbrt_tpu/ops/sweep_bvh.py (`_sweep_kernel` /
`_sweep_step`, entered through `intersect_sweep`), the traversal the
reference sends meshes too big for the wide kernel's budget. The work is the
same: triangles in BVH-DFS order are cut into groups of GROUP consecutive
rows, each group with a bounding sphere; a 128-ray packet culls every group
by its sphere, then tests the culled groups near to far with precomputed
Baldwin-Weber rows, and stops when the nearest remaining group lies beyond
every live ray's bound. Instancing is uniform scale + translation, one
instance after another in table order, each behind a root-sphere pre-test.

Tables (`SweepTables`, built by `build_sweep_tables` exactly as the
reference builds them):
  sph  [8, Gp]        f32  per group: cx, cy, cz, |c|^2, r^2, r, 0, 0
                           (Gp = n_groups rounded up to 128; padding zero)
  bw   [12, Tp]       f32  per triangle (Tp = 128 * n_groups):
                           rows 0:4   n = e1 x e2, -n.p0
                           rows 4:8   A1, b1 (barycentric u = A1.p + b1)
                           rows 8:12  A2, b2 (barycentric v)
                           all zero for padding and degenerate rows
  inst [(I+1)*4]      f32  (offset.xyz, scale) rows; row 0 the identity
  root [8]            f32  the mesh's bounding sphere, as a group's row
The CUDA kernel is csrc/sweep_bvh.cu; the BW table stays in global memory
(the TPU kernel's resident and streamed modes are one function).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .intersect import KindHit
from .linalg import fma32

GROUP = 128          # triangles per cull group
RAYS = 128           # rays per packet (one CUDA thread block)
# a culled-out group's key distance, and the packed group key (the
# reference's): (entry-distance bits & ~GMASK) | group; csrc/sweep_bvh.cu
# holds the same values
FAR = np.float32(3.0e37)
GMASK = 8191
# the reference TPU route's resident-sweep budget (sweep_bvh.py:77)
_VMEM_BUDGET = 12 * 1024 * 1024
# intersect_sweep_plain's chunks: (ray, group) pairs culled at a time, and
# surviving pairs tested at a time
_CULL_ELEMS = 1 << 22
_PAIR_CHUNK = 1 << 15


def fits_vmem(n_tris: int) -> bool:
    """The reference's resident-sweep test (BW rows and spheres in 12 MiB
    of VMEM); beyond it the TPU streamed the BW table. The port has one
    mode and keeps the test only as the reference's predicate."""
    tp = ((max(n_tris, 1) + GROUP - 1) // GROUP) * GROUP
    return tp * 12 * 4 + (tp // GROUP) * 8 * 4 <= _VMEM_BUDGET


def max_groups() -> int:
    """Groups a packed key can name (13 id bits: 1M triangles)."""
    return GMASK + 1


class SweepTables(NamedTuple):
    sph: torch.Tensor    # [8, Gp] f32 group spheres
    bw: torch.Tensor     # [12, Tp] f32 Baldwin-Weber rows
    inst: torch.Tensor   # [(I+1)*4] f32 flat (offset, scale) rows
    root: torch.Tensor   # [8] f32 mesh sphere
    n_groups: int
    n_inst: int          # 0 for a single-level soup

    def to(self, device) -> "SweepTables":
        return self._replace(sph=self.sph.to(device), bw=self.bw.to(device),
                             inst=self.inst.to(device),
                             root=self.root.to(device))


# ---------------------------------------------------------------------------
# host-side tables (jax-free rewrite of sweep_bvh.py:97-185)
# ---------------------------------------------------------------------------

def _sphere(p0, e1, e2, ok):
    """[8] f32 bounding sphere of the valid triangles' vertices."""
    v = np.concatenate([p0[ok], (p0 + e1)[ok], (p0 + e2)[ok]], axis=0)
    if len(v) == 0:
        return np.zeros(8, np.float32)
    c = 0.5 * (v.min(axis=0) + v.max(axis=0))
    r = float(np.sqrt(((v - c) ** 2).sum(axis=1).max())) * (1 + 1e-6)
    return np.array([c[0], c[1], c[2], float(c @ c), r * r, r, 0, 0],
                    np.float32)


def build_sweep_tables(tris_mt: np.ndarray):
    """Triangle rows [T,9] (p0, e1, e2) in BVH-DFS order -> (bw [12, Tp],
    sph [8, Gp], root [8], n_groups), bit for bit the reference's."""
    a = np.asarray(tris_mt, np.float64)
    t = a.shape[0]
    tp = ((max(t, 1) + GROUP - 1) // GROUP) * GROUP
    a = np.pad(a, ((0, tp - t), (0, 0)))
    p0, e1, e2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    n = np.cross(e1, e2)
    d0 = np.einsum("ij,ij->i", n, p0)
    # barycentric rows: [u, v, w]^T = M^{-1} (p - p0), M columns (e1, e2, n)
    m = np.stack([e1, e2, n], axis=2)
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-18
    minv = np.zeros((tp, 3, 3))
    if ok.any():
        minv[ok] = np.linalg.inv(m[ok])
    a1 = minv[:, 0, :]
    a2 = minv[:, 1, :]
    b1 = -np.einsum("ij,ij->i", a1, p0)
    b2 = -np.einsum("ij,ij->i", a2, p0)
    n = np.where(ok[:, None], n, 0.0)
    d0 = np.where(ok, d0, 0.0)
    a1 = np.where(ok[:, None], a1, 0.0)
    a2 = np.where(ok[:, None], a2, 0.0)
    b1 = np.where(ok, b1, 0.0)
    b2 = np.where(ok, b2, 0.0)
    bw = np.stack([n[:, 0], n[:, 1], n[:, 2], -d0,
                   a1[:, 0], a1[:, 1], a1[:, 2], b1,
                   a2[:, 0], a2[:, 1], a2[:, 2], b2]).astype(np.float32)
    n_groups = tp // GROUP
    gp = ((n_groups + RAYS - 1) // RAYS) * RAYS
    sph = np.zeros((8, gp), np.float32)
    for g in range(n_groups):
        s = slice(g * GROUP, (g + 1) * GROUP)
        sph[:, g] = _sphere(p0[s], e1[s], e2[s], ok[s])
    root = _sphere(p0, e1, e2, ok)
    return bw, sph, root, n_groups


def mesh_root_sphere(tris_mt: np.ndarray) -> np.ndarray:
    """[8] f32 bounding sphere of a [T,9] triangle table; the sort's
    needs-BVH pre-test reads it for every mesh, whatever its route."""
    a = np.asarray(tris_mt, np.float64)
    if len(a) == 0:
        return np.zeros(8, np.float32)
    return _sphere(a[:, 0:3], a[:, 3:6], a[:, 6:9], np.ones(len(a), bool))


def flat_inst(inst_off, inst_scale) -> np.ndarray:
    """Instance table [(I+1)*4]: identity row + (off.xyz, scale)."""
    n = len(inst_scale)
    t = np.zeros((n + 1, 4), np.float32)
    t[0, 3] = 1.0
    if n:
        t[1:, :3] = np.asarray(inst_off, np.float32)
        t[1:, 3] = np.asarray(inst_scale, np.float32)
    return np.ascontiguousarray(t.reshape(-1))


def sweep_tables(tris_mt: np.ndarray, inst_off=None,
                 inst_scale=None) -> SweepTables:
    """SweepTables over [T,9] rows; with inst_off/inst_scale the rows are a
    shared BLAS in local space, else a single-level soup."""
    bw, sph, root, n_groups = build_sweep_tables(tris_mt)
    if inst_scale is None:
        inst, n_inst = flat_inst(np.zeros((0, 3)), np.zeros(0)), 0
    else:
        inst, n_inst = flat_inst(inst_off, inst_scale), len(inst_scale)
    return SweepTables(sph=torch.from_numpy(sph), bw=torch.from_numpy(bw),
                       inst=torch.from_numpy(inst),
                       root=torch.from_numpy(root), n_groups=int(n_groups),
                       n_inst=int(n_inst))


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _check(tables: SweepTables, o, d, tmin, tmax, n_tris):
    n = o.shape[0]
    dev = o.device
    ng = tables.n_groups
    gp = ((ng + RAYS - 1) // RAYS) * RAYS
    for name, x, shape in (
            ("o", o, (n, 3)), ("d", d, (n, 3)), ("tmin", tmin, (n,)),
            ("tmax", tmax, (n,)), ("sph", tables.sph, (8, gp)),
            ("bw", tables.bw, (12, ng * GROUP)),
            ("inst", tables.inst, ((tables.n_inst + 1) * 4,)),
            ("root", tables.root, (8,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < ng <= max_groups():
        raise ValueError(f"{ng} groups: the packed key names 1 to "
                         f"{max_groups()}")
    if not (ng - 1) * GROUP < n_tris <= ng * GROUP:
        raise ValueError(f"{n_tris} triangle rows do not fill {ng} groups")
    if max(tables.n_inst, 1) * n_tris >= 2 ** 31:
        raise ValueError("hit indices overflow int32")


def intersect_sweep(tables: SweepTables, o, d, tmin, tmax, *, any_hit: bool,
                    n_tris: int, with_stats: bool = False):
    """Closest hit (or any hit) of rays o, d [N,3] in (tmin, tmax) [N].

    Index = inst * n_tris + triangle row (inst 0 for a soup); an any-hit
    reports t = 0 when occluded. with_stats also returns per-packet
    counters [ceil(N/128), 4] int32: instances culled (root test passed),
    groups tested, the rays past the root test summed over the culled
    instances, and the rays that test a group summed over the groups
    tested. CUDA tensors launch the kernel of
    csrc/sweep_bvh.cu; CPU tensors take `intersect_sweep_plain` (whose
    counters are not the kernel's: it has no packets, so it returns
    zeros)."""
    _check(tables, o, d, tmin, tmax, n_tris)
    n = o.shape[0]
    n_packets = (n + RAYS - 1) // RAYS
    if o.device.type == "cpu":
        hit = intersect_sweep_plain(tables, o, d, tmin, tmax,
                                    any_hit=any_hit, n_tris=n_tris)
        if with_stats:
            return hit, torch.zeros((n_packets, 4), dtype=torch.int32)
        return hit
    if o.device.type != "cuda":
        raise ValueError(f"no sweep route for device {o.device}")
    from ..utils.cuda_build import load_library

    lib = load_library("sweep_bvh", ["sweep_bvh.cu"], _declare)
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    idx = torch.empty((n,), dtype=torch.int32, device=o.device)
    stats = (torch.empty((n_packets, 4), dtype=torch.int32, device=o.device)
             if with_stats else None)
    with torch.cuda.device(o.device):
        err = lib.sweep_bvh_launch(
            tables.sph.data_ptr(), tables.sph.shape[1], tables.bw.data_ptr(),
            tables.inst.data_ptr(), tables.n_inst, tables.root.data_ptr(),
            tables.n_groups, n_tris, o.data_ptr(), d.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), n, int(any_hit),
            t.data_ptr(), idx.data_ptr(),
            stats.data_ptr() if with_stats else None,
            torch.cuda.current_stream(o.device).cuda_stream)
    intersect_sweep.launches += 1
    if err != 0:
        raise RuntimeError(f"sweep_bvh kernel launch failed: CUDA error {err}")
    hit = KindHit(t=t, index=idx, valid=torch.isfinite(t))
    return (hit, stats) if with_stats else hit


intersect_sweep.launches = 0


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sweep_bvh_launch.argtypes = [vp, ci, vp, vp, ci, vp, ci, ci, vp, vp,
                                     vp, vp, ci, ci, vp, vp, vp, vp]
    lib.sweep_bvh_launch.restype = ci


def _dot3(w, x, y, z):
    """w[0] x + w[1] y + w[2] z as the chain of fused multiply-adds that
    the kernel and the reference's float32 contraction evaluate."""
    return fma32(w[2], z, fma32(w[1], y, w[0] * x))


def intersect_sweep_plain(tables: SweepTables, o, d, tmin, tmax, *,
                          any_hit: bool, n_tris: int) -> KindHit:
    """The kernel's plain PyTorch version, by another route: per instance,
    cull every (ray, group) pair with the kernel's sphere test (cap = tmax:
    there is no sequential best here), test the 128 triangles of every
    surviving pair with the same Baldwin-Weber arithmetic, and keep the
    minimum t with the lowest index on exact ties. Each contraction is the
    kernel's chain of float32 fused multiply-adds, evaluated elementwise
    (never a matrix product, so never TF32). Chunked over rays (_CULL_ELEMS
    (ray, group) pairs at a time) and over surviving pairs (_PAIR_CHUNK at
    a time), so memory stays bounded at 2^20 rays on a mesh of a million
    rows."""
    n = o.shape[0]
    dev = o.device
    ng = tables.n_groups
    sph = tables.sph[:, :ng]
    cx, cy, cz, cc, r2, rad = (sph[k][None, :] for k in range(6))
    bw = tables.bw.view(12, ng, GROUP)
    inst = tables.inst.view(-1, 4)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    best = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    sub = torch.arange(GROUP, device=dev)
    ray_chunk = max(1, _CULL_ELEMS // max(ng, 1))

    for i in range(max(tables.n_inst, 1)):
        row = inst[i + 1] if tables.n_inst else inst[0]
        scl = row[3]
        inv = 1.0 / scl
        ox = (o[:, 0] - row[0]) * inv
        oy = (o[:, 1] - row[1]) * inv
        oz = (o[:, 2] - row[2]) * inv
        tminl = tmin * inv
        capl = tmax * inv
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        for r0 in range(0, n, ray_chunk):
            s = slice(r0, r0 + ray_chunk)
            c = lambda x: x[s, None]
            cd = c(dx) * cx + c(dy) * cy + c(dz) * cz
            co = c(ox) * cx + c(oy) * cy + c(oz) * cz
            tc = cd - c(od)
            m2 = cc - 2.0 * co + c(oo) - tc * tc
            # rounding slack: over-cull only, never under-cull
            slack = (cc + 2.0 * torch.abs(co) + c(oo) + tc * tc) * 1e-6
            hit = ((m2 <= r2 + slack) & (tc + rad >= c(tminl))
                   & (tc - rad <= c(capl)) & (c(capl) >= c(tminl)))
            ray, grp = torch.nonzero(hit, as_tuple=True)
            ray = ray + r0
            for p0 in range(0, ray.shape[0], _PAIR_CHUNK):
                rr = ray[p0:p0 + _PAIR_CHUNK]
                gg = grp[p0:p0 + _PAIR_CHUNK]
                b = [bw[k][gg] for k in range(12)]              # [P, 128]
                ddx, ddy, ddz = dx[rr, None], dy[rr, None], dz[rr, None]
                lox, loy, loz = ox[rr, None], oy[rr, None], oz[rr, None]
                nd = _dot3(b[0:3], ddx, ddy, ddz)
                no = _dot3(b[0:3], lox, loy, loz) + b[3]
                ud = _dot3(b[4:7], ddx, ddy, ddz)
                uo = _dot3(b[4:7], lox, loy, loz) + b[7]
                vd = _dot3(b[8:11], ddx, ddy, ddz)
                vo = _dot3(b[8:11], lox, loy, loz) + b[11]
                ok_nd = torch.abs(nd) > 1e-20
                r_nd = torch.where(ok_nd, 1.0 / nd, torch.zeros_like(nd))
                t = -no * r_nd
                u = fma32(t, ud, uo)
                v = fma32(t, vd, vo)
                t_w = t * scl
                ok = (ok_nd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                      & (t > tminl[rr, None]) & (t_w < tmax[rr, None]))
                if any_hit:
                    occ[rr[ok.any(1)]] = True
                    continue
                t_w = torch.where(ok, t_w, torch.full_like(t_w, math.inf))
                pt = torch.amin(t_w, dim=1)
                # lowest sublane among the exact minima of each pair
                k = torch.where(t_w == pt[:, None], sub,
                                torch.full_like(sub, GROUP)).amin(1)
                pidx = i * n_tris + gg.to(torch.int64) * GROUP + k
                # per ray: min t over its pairs, then the lowest index there
                ct = torch.full((n,), math.inf, dtype=torch.float32,
                                device=dev).scatter_reduce(0, rr, pt, "amin")
                at_min = torch.isfinite(pt) & (pt == ct[rr])
                ci = torch.full((n,), 2 ** 62, dtype=torch.int64,
                                device=dev).scatter_reduce(
                    0, rr[at_min], pidx[at_min], "amin")
                better = (ct < best) | ((ct == best) & (ci < best_idx)
                                        & torch.isfinite(ct))
                best = torch.where(better, ct, best)
                best_idx = torch.where(better, ci, best_idx)
    if any_hit:
        t = torch.where(occ, torch.zeros_like(best), best)
        return KindHit(t=t, index=torch.zeros((n,), dtype=torch.int32,
                                              device=dev), valid=occ)
    return KindHit(t=best, index=best_idx.to(torch.int32),
                   valid=torch.isfinite(best))
