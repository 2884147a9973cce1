"""Cull-sweep triangle intersection: host-side tables, the Hopper kernel's
wrapper, and its plain PyTorch version.

Replaces the TPU kernel jet_pbrt_tpu/ops/sweep_bvh.py (`_sweep_kernel` /
`_sweep_step`, entered through `intersect_sweep`), the traversal the
reference sends meshes too big for the wide kernel's budget. The work is the
same: triangles in BVH-DFS order are cut into groups of GROUP consecutive
rows, each group with a bounding sphere; a 128-ray packet culls every group
by its sphere, then tests the culled groups near to far, and stops when the
nearest remaining group lies beyond every live ray's bound. Instancing is
uniform scale + translation, one instance after another in table order,
each behind a root-sphere pre-test. The cull goes through two levels: a
ray is tested against a group's sphere only where it passes the
super-sphere of the group's run of SUPER groups; the super-spheres are
wide enough that this never drops a (ray, group) pair that the group test
passes, so the keys, and every hit, are the flat cull's.

The triangle test is the wide route's Moller-Trumbore, rounded as
`wide_bvh.intersect_wide_plain` rounds it (one rounding an operation, no
fused multiply-add), not the reference kernel's precomputed Baldwin-Weber
rows: so a mesh's hits, and the frame, do not depend on which route its
triangle count sends it to. Both tests are sound; they round differently,
and at 481k triangles a bunny's hits by the two lay a few float32 ulps of
t apart, which a path tracer turns into other paths at grazing shadow rays
and silhouettes.

Tables (`SweepTables`; the spheres built by `build_sweep_tables` as the
reference builds them, over the rows the triangle test can accept):
  sph  [8, Gp]        f32  per group: cx, cy, cz, |c|^2, r^2, r, 0, 0
                           (Gp = n_groups rounded up to 128; padding zero)
  mt   [9, Tp]        f32  per triangle (Tp = 128 * n_groups): p0, e1, e2
                           (the wide route's rows), zero for padding
  inst [(I+1)*4]      f32  (offset.xyz, scale) rows; row 0 the identity
  root [8]            f32  the mesh's bounding sphere, as a group's row
  sup  [8, Gp/32]     f32  per run of SUPER groups: cx, cy, cz, |c|^2, the
                           test's r^2 and r, its slack k1 and the factor F
                           (`super_spheres`; zero past the last group)
The CUDA kernel is csrc/sweep_bvh.cu; the row table stays in global memory
(the TPU kernel's resident and streamed modes are one function).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .intersect import KindHit, check_hit_out
from .kernels import INT, PTR
from .linalg import fma32
from .wide_bvh import mt_test

GROUP = 128          # triangles per cull group
RAYS = 128           # rays per packet (one CUDA thread block)
SUPER = 32           # groups per super-sphere (a warp's width in the kernel)
STATS_COLS = 10      # the kernel's counters a packet (intersect_sweep)
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
    mt: torch.Tensor     # [9, Tp] f32 (p0, e1, e2) rows
    inst: torch.Tensor   # [(I+1)*4] f32 flat (offset, scale) rows
    root: torch.Tensor   # [8] f32 mesh sphere
    n_groups: int
    n_inst: int          # 0 for a single-level soup
    sup: torch.Tensor    # [8, Gp/32] f32 super-spheres (`super_spheres`)

    def to(self, device) -> "SweepTables":
        return self._replace(sph=self.sph.to(device), mt=self.mt.to(device),
                             inst=self.inst.to(device),
                             root=self.root.to(device),
                             sup=self.sup.to(device))


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
    """Triangle rows [T,9] (p0, e1, e2) in BVH-DFS order -> (mt [9, Tp],
    sph [8, Gp], root [8], n_groups): the rows transposed and padded with
    zeros, and the spheres built as the reference builds them, each over
    its group's rows that `wide_bvh.mt_test` can accept: every row whose e1
    and e2 are both non-zero. The reference leaves out its Baldwin-Weber
    degenerate rows, |e1 x e2|^2 <= 1e-18, which its test never hits; the
    port's test can hit such a sliver, so only where a group holds one do
    the two spheres differ."""
    a = np.asarray(tris_mt, np.float64)
    t = a.shape[0]
    tp = ((max(t, 1) + GROUP - 1) // GROUP) * GROUP
    a = np.pad(a, ((0, tp - t), (0, 0)))
    p0, e1, e2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    # a row with a zero edge gets det = 0, so t = 0, and never passes
    ok = e1.any(axis=1) & e2.any(axis=1)
    mt = np.ascontiguousarray(a.T.astype(np.float32))
    n_groups = tp // GROUP
    gp = ((n_groups + RAYS - 1) // RAYS) * RAYS
    sph = np.zeros((8, gp), np.float32)
    for g in range(n_groups):
        s = slice(g * GROUP, (g + 1) * GROUP)
        sph[:, g] = _sphere(p0[s], e1[s], e2[s], ok[s])
    root = _sphere(p0, e1, e2, ok)
    return mt, sph, root, n_groups


# The super test's margins (csrc/sweep_bvh.cu super_test). A group test
# that passes in float32 puts the sphere's centre within sqrt(r^2 + x) of
# the ray's line, x = (1e-6 + 28.6 u) S + 2 e S (u = 2^-24; S the slack's
# sum |c|^2 + 2|c.o| + |o|^2 + tc^2; e = |1 - |d|^2|): the group's slack
# and every rounding of its expansion, for a direction within e of unit
# length. The super test's own rounding costs 28.6 u S + 2 e S more.
_BETA_GROUP = 2.75e-6
_BETA_SUPER = 1.75e-6
# a direction further than this from unit length (|1 - |d|^2|) passes
# every super, so the margins are proven only for |d| <= 1.004
E_MAX = 2.0 ** -7
# the interval tests' margin, a share of sqrt(S): covers tc's rounding,
# 5.4 u sqrt(S) on each side
KT = 2.0 ** -16
# a super's own radius margin: the intervals' rounding in R0 (19 u R0)
_PAD = 2.0 ** -10


def _up32(x) -> np.ndarray:
    """float32 of x rounded towards +inf."""
    x = np.asarray(x, np.float64)
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) < x, np.nextafter(y, np.float32(
        np.inf)), y)


def super_spheres(sph: np.ndarray, n_groups: int) -> np.ndarray:
    """[8, Gp/32] f32 super-spheres of the group spheres sph [8, Gp]: per
    run of SUPER consecutive groups, the centre c (float32), |c|^2, the
    test's r^2 and r, its slack coefficient k1 and the factor F, zero past
    the last group (a ragged last super holds only real groups).

    Built in float64 from the stored float32 group spheres (c_g, r_g
    raised by 2^-20 for the rounding of r^2): the centre of their
    bounding box, R0 = max(|c_g - c| + r_g') with each r_g' = max(r_g,
    R0'/64) (R0' the same maximum over r_g: a tiny or empty group is
    taken at 1/64 of the super), and F = max(1 + |c_g - c| / r_g').
    Where a group's float32 test passes for a ray, its centre lies
    within sqrt(r_g^2 + x) of the ray's line, x = b_g S_g (see
    _BETA_GROUP); so c lies within R0 + sqrt(F x) of it, by
    (sqrt(r^2 + x) + D)^2 <= (r + D)^2 + x (1 + D / r), and S_g <= 1.25
    S + 15.1 D^2 for |d| <= 1.01. The super test passes where m2 <= r^2
    + slack, slack = S (k1 + (2.6 F + 2.1) e) + 31 F e r^2: with r^2 =
    R0^2 (1 + 16 F b_g) and k1 = 1.01 (1.25 F b_g + b_s) that holds for
    every such ray, its own rounding included; its intervals use r =
    R0 (1 + 2^-10) (1 + e) + 2^-16 sqrt(S). So no (ray, group) pair that
    the group test passes fails its super's test (tests/test_torch_sweep.py
    counts them on adversarial rays)."""
    gp = sph.shape[1]
    out = np.zeros((8, gp // SUPER), np.float32)
    c = sph[0:3, :n_groups].T.astype(np.float64)
    r = sph[5, :n_groups].astype(np.float64) * (1 + 2.0 ** -20)
    tiny = float(np.finfo(np.float32).tiny)
    for s in range(-(-n_groups // SUPER)):
        cg, rg = c[s * SUPER:(s + 1) * SUPER], r[s * SUPER:(s + 1) * SUPER]
        lo = (cg - rg[:, None]).min(0)
        hi = (cg + rg[:, None]).max(0)
        cs = (0.5 * (lo + hi)).astype(np.float32)
        dist = np.linalg.norm(cg - cs.astype(np.float64), axis=1)
        rgf = np.maximum(np.maximum(rg, (dist + rg).max() / 64), tiny)
        r0 = (dist + rgf).max()
        f = (1 + dist / rgf).max()
        out[0:3, s] = cs
        out[3, s] = np.float32(float(cs.astype(np.float64)
                                     @ cs.astype(np.float64)))
        out[4, s] = _up32(r0 * r0 * (1 + 16 * f * _BETA_GROUP)
                          * (1 + 2.0 ** -20))
        out[5, s] = _up32(r0 * (1 + _PAD))
        out[6, s] = _up32(1.01 * (1.25 * f * _BETA_GROUP + _BETA_SUPER))
        out[7, s] = _up32(f)
    return out


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
    mt, sph, root, n_groups = build_sweep_tables(tris_mt)
    if inst_scale is None:
        inst, n_inst = flat_inst(np.zeros((0, 3)), np.zeros(0)), 0
    else:
        inst, n_inst = flat_inst(inst_off, inst_scale), len(inst_scale)
    return SweepTables(sph=torch.from_numpy(sph), mt=torch.from_numpy(mt),
                       inst=torch.from_numpy(inst),
                       root=torch.from_numpy(root), n_groups=int(n_groups),
                       n_inst=int(n_inst),
                       sup=torch.from_numpy(super_spheres(sph, n_groups)))


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

_LIB = kernels.Library("sweep_bvh", ["sweep_bvh.cu"], {
    "sweep_bvh_launch": [PTR, INT, PTR, PTR, INT, PTR, INT, INT, PTR, PTR,
                         PTR, PTR, INT, INT, PTR, PTR, PTR, PTR, PTR, PTR],
    "sweep_bvh_blocks_per_sm": [INT]})


def _check(tables: SweepTables, o, d, tmin, tmax, n_tris):
    n = o.shape[0]
    dev = o.device
    ng = tables.n_groups
    gp = ((ng + RAYS - 1) // RAYS) * RAYS
    for name, x, shape in (
            ("o", o, (n, 3)), ("d", d, (n, 3)), ("tmin", tmin, (n,)),
            ("tmax", tmax, (n,)), ("sph", tables.sph, (8, gp)),
            ("sup", tables.sup, (8, gp // SUPER)),
            ("mt", tables.mt, (9, ng * GROUP)),
            ("inst", tables.inst, ((tables.n_inst + 1) * 4,)),
            ("root", tables.root, (8,))):
        kernels.check(name, x, torch.float32, shape, dev)
    if not 0 < ng <= max_groups():
        raise ValueError(f"{ng} groups: the packed key names 1 to "
                         f"{max_groups()}")
    if not (ng - 1) * GROUP < n_tris <= ng * GROUP:
        raise ValueError(f"{n_tris} triangle rows do not fill {ng} groups")
    if max(tables.n_inst, 1) * n_tris >= 2 ** 31:
        raise ValueError("hit indices overflow int32")


@kernels.wrapper("sweep_bvh_kernel")
def intersect_sweep(tables: SweepTables, o, d, tmin, tmax, *, any_hit: bool,
                    n_tris: int, with_stats: bool = False, out=None):
    """Closest hit (or any hit) of rays o, d [N,3] in (tmin, tmax) [N].

    Index = inst * n_tris + triangle row (inst 0 for a soup); an any-hit
    reports t = 0 when occluded. with_stats also returns per-packet
    counters [ceil(N/128), STATS_COLS] int64: instances culled (root test
    passed), groups tested, the rays past the root test summed over the
    culled instances, the rays that test a group summed over the groups
    tested (the (ray, group) tests), thread 0's clock64() cycles in the
    culls (the list's sort included) and in the scans, the (ray, super)
    pairs whose super test passed, the group sphere tests the cull ran for
    them, the groups the culls listed (key below FAR) and the groups the
    scans popped from those lists (tested or not). CUDA
    tensors launch the kernel of csrc/sweep_bvh.cu, which writes t,
    index and valid (isfinite(t)); CPU tensors take
    `intersect_sweep_plain` (whose counters are not the kernel's: it has no
    packets, so it returns zeros). out: None, or the (t, index, valid) [N]
    tensors to write (rows of the caller's slabs; the plain version's
    outputs are copied there)."""
    _check(tables, o, d, tmin, tmax, n_tris)
    check_hit_out(out, o.shape[0], o.device)
    dev = o.device
    n = o.shape[0]
    n_packets = (n + RAYS - 1) // RAYS
    if not kernels.route("intersect_sweep", dev, o=o, d=d, tmin=tmin,
                         tmax=tmax):
        hit = kernels.copy_out(intersect_sweep_plain(
            tables, o, d, tmin, tmax, any_hit=any_hit, n_tris=n_tris), out)
        if with_stats:
            return hit, torch.zeros((n_packets, STATS_COLS),
                                    dtype=torch.int64)
        return hit
    stats = (torch.empty((n_packets, STATS_COLS), dtype=torch.int64,
                         device=dev) if with_stats else None)
    if out is None:
        out = (torch.empty((n,), dtype=torch.float32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.bool, device=dev))
    kernels.launch(
        intersect_sweep, dev, _LIB.load().sweep_bvh_launch,
        tables.sph.data_ptr(), tables.sph.shape[1], tables.mt.data_ptr(),
        tables.inst.data_ptr(), tables.n_inst, tables.root.data_ptr(),
        tables.n_groups, n_tris, o.data_ptr(), d.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), n, int(any_hit),
        out[0].data_ptr(), out[1].data_ptr(), kernels.ptr(stats),
        after=(out[2].data_ptr(), tables.sup.data_ptr()))
    hit = KindHit(*out)
    return (hit, stats) if with_stats else hit


def load_kernel(source: str = "sweep_bvh.cu", name: str = "sweep_bvh"):
    """The compiled sweep library: csrc/<source>, or any file (an absolute
    path) with the same C entry point, built and loaded under `name`."""
    return _LIB.build([source], name)


def blocks_per_sm(gp: int) -> int:
    """Resident blocks per SM of the closest-hit kernel at a sphere table
    of gp columns (the occupancy API, on the current card)."""
    return int(_LIB.load().sweep_bvh_blocks_per_sm(int(gp)))


def _dot3(w, x, y, z):
    """w[0] x + w[1] y + w[2] z as the chain of fused multiply-adds that
    the kernel and the reference's float32 contraction evaluate."""
    return fma32(w[2], z, fma32(w[1], y, w[0] * x))


def intersect_sweep_plain(tables: SweepTables, o, d, tmin, tmax, *,
                          any_hit: bool, n_tris: int) -> KindHit:
    """The kernel's plain PyTorch version, by another route: per instance,
    cull every (ray, group) pair with the kernel's sphere test (cap = tmax:
    there is no sequential best here), test the 128 triangles of every
    surviving pair with the wide route's Moller-Trumbore
    (`wide_bvh.mt_test`), and keep the minimum t with the lowest index on
    exact ties. The sphere tests' contractions are the kernel's chains of
    float32 fused multiply-adds, evaluated elementwise (never a matrix
    product, so never TF32). Chunked over rays (_CULL_ELEMS (ray, group)
    pairs at a time) and over surviving pairs (_PAIR_CHUNK at a time), so
    memory stays bounded at 2^20 rays on a mesh of a million rows."""
    n = o.shape[0]
    dev = o.device
    ng = tables.n_groups
    sph = tables.sph[:, :ng]
    cx, cy, cz, cc, r2, rad = (sph[k][None, :] for k in range(6))
    mt = tables.mt.view(9, ng, GROUP)
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
                rows = [mt[k][gg] for k in range(9)]            # [P, 128]
                t_w, ok = mt_test(
                    rows, (ox[rr, None], oy[rr, None], oz[rr, None]),
                    (dx[rr, None], dy[rr, None], dz[rr, None]),
                    tminl[rr, None], tmax[rr, None], scl)
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


# ---------------------------------------------------------------------------
# the work the inputs need (the kernel's root and sphere tests, as it rounds
# them: every fused step of csrc/sweep_bvh.cu is fma32 here)
# ---------------------------------------------------------------------------

def instance_rays(row, o, d, tmin, cap):
    """Rays in the space of instance row (off.xyz, scale), as the kernel maps
    them: (o' [N,3], tmin', cap', o'.d, o'.o)."""
    inv = 1.0 / row[3]
    lo = (o - row[:3]) * inv
    lx, ly, lz = lo.unbind(1)
    dx, dy, dz = d.unbind(1)
    return (lo, tmin * inv, cap * inv, _dot3((lx, ly, lz), dx, dy, dz),
            _dot3((lx, ly, lz), lx, ly, lz))


def root_test(root, lo, d, tminl, capl):
    """The kernel's root pre-test of rays in instance space: [N] bool."""
    ex, ey, ez = (root[k] - lo[:, k] for k in range(3))
    rtc = _dot3((ex, ey, ez), d[:, 0], d[:, 1], d[:, 2])
    rm2 = fma32(-rtc, rtc, _dot3((ex, ey, ez), ex, ey, ez))
    rr = root[5]
    return ((rm2 <= rr * rr * 1.0001 + 1e-5) & (rtc + rr >= tminl)
            & (rtc - rr <= capl) & (capl >= tminl))


def sphere_test(sph, lo, d, tminl, capl, od, oo):
    """The kernel's group-sphere test: rays [R] (instance space) against
    sphere columns sph [8, G] -> (pass [R, G], entry distance tc - r)."""
    cx, cy, cz, cc, r2, rad = (sph[k][None, :] for k in range(6))
    c = lambda x: x[:, None]
    far = float(FAR)
    tminc, capc = c(tminl.clamp(max=far)), c(capl.clamp(max=far))
    cd = _dot3((c(d[:, 0]), c(d[:, 1]), c(d[:, 2])), cx, cy, cz)
    co = _dot3((c(lo[:, 0]), c(lo[:, 1]), c(lo[:, 2])), cx, cy, cz)
    tc = cd - c(od)
    m2 = fma32(-tc, tc, cc - 2.0 * co + c(oo))
    slack = fma32(tc, tc, cc + 2.0 * torch.abs(co) + c(oo)) * 1e-6
    entry = tc - rad
    ok = ((m2 <= r2 + slack) & (tc + rad >= tminc) & (entry <= capc)
          & (capc >= tminc))
    return ok, entry


def super_test(sup, lo, d, tminl, capl, od, oo):
    """The kernel's super-sphere test: rays [R] (instance space) against
    super columns sup [8, S] -> [R, S] bool, every step rounded as
    csrc/sweep_bvh.cu's super_test rounds it."""
    cx, cy, cz, cc, r2, rad, k1, f = (sup[k][None, :] for k in range(8))
    c = lambda x: x[:, None]
    far = float(FAR)
    tminc, capc = c(tminl.clamp(max=far)), c(capl.clamp(max=far))
    dx, dy, dz = (c(d[:, k]) for k in range(3))
    cd = _dot3((dx, dy, dz), cx, cy, cz)
    co = _dot3((c(lo[:, 0]), c(lo[:, 1]), c(lo[:, 2])), cx, cy, cz)
    tc = cd - c(od)
    m2 = fma32(-tc, tc, cc - 2.0 * co + c(oo))
    ssum = fma32(tc, tc, cc + 2.0 * torch.abs(co) + c(oo))
    e = torch.abs(1.0 - _dot3((dx, dy, dz), dx, dy, dz))
    k2 = fma32(torch.tensor(2.6), f, torch.tensor(2.1))
    slack = fma32(ssum, fma32(k2, e, k1), r2 * (31.0 * f) * e)
    rt = fma32(torch.sqrt(ssum), torch.tensor(KT), rad * (1.0 + e))
    return (e > E_MAX) | ((m2 <= r2 + slack) & (tc + rt >= tminc)
                          & (tc - rt <= capc) & (capc >= tminc))


class SweepWork(NamedTuple):
    n_root: int        # rays past each instance's root test, summed
    n_pairs: int       # needed (ray, group) pairs
    n_super: int       # (ray, super) pairs whose super test passes
    n_group_tests: int  # the group tests those supers hold


def sweep_work_plain(tables: SweepTables, o, d, tmin, tmax, t_final):
    """The work a closest-hit cull-sweep needs on these rays, counted from
    the inputs, whichever kernel does it: (rays past each
    instance's root test, summed over instances; (ray, group) pairs among
    those whose own sphere test passes and whose entry, in world units,
    lies at or before the ray's final closest t; the (ray, super) pairs
    among the same rays whose super test passes; and the groups of those
    supers, the group tests a two-level cull runs for them). t_final [N]
    is that t, inf where there is no hit; min(tmax, t_final) caps every
    test. Any near-to-far traversal culls those rays and tests those
    pairs; a flat cull runs n_root x n_groups sphere tests, the two-level
    cull n_root x n_supers super tests and n_group_tests."""
    ng = tables.n_groups
    sph = tables.sph[:, :ng]
    n_sup = -(-ng // SUPER)
    sup = tables.sup[:, :n_sup]
    size = torch.clamp(ng - SUPER * torch.arange(n_sup, device=o.device),
                       max=SUPER)
    inst = tables.inst.view(-1, 4)
    cap = torch.minimum(tmax, t_final)
    chunk = max(1, _CULL_ELEMS // ng)
    n_root = n_pairs = n_super = n_tests = 0
    for i in range(max(tables.n_inst, 1)):
        row = inst[i + 1] if tables.n_inst else inst[0]
        lo, tminl, capl, od, oo = instance_rays(row, o, d, tmin, cap)
        live = torch.nonzero(root_test(tables.root, lo, d, tminl, capl))[:, 0]
        n_root += live.numel()
        for r0 in range(0, live.numel(), chunk):
            k = live[r0:r0 + chunk]
            args = (lo[k], d[k], tminl[k], capl[k], od[k], oo[k])
            ok, entry = sphere_test(sph, *args)
            ok &= entry.clamp(min=0.0) * row[3] <= cap[k, None]
            n_pairs += int(ok.sum())
            sok = super_test(sup, *args)
            n_super += int(sok.sum())
            n_tests += int((sok.to(torch.int64) * size).sum())
    return SweepWork(n_root, n_pairs, n_super, n_tests)
