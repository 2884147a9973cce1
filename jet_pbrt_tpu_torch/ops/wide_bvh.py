"""8-wide BVH: host-side collapse, the Hopper traversal kernel's wrapper, and
its plain PyTorch version.

Replaces the TPU packet kernel jet_pbrt_tpu/ops/wide_bvh.py
(`_wide_kernel` / `_wide_tile`, entered through `intersect_wide`). The work
is the same: the closest hit (world t and index inst * n_tris + triangle)
or an any-hit bit, over an 8-wide BVH collapsed from the binary skip-link
BVH, with two-level instancing (uniform scale + translation). The form is
not: the CUDA kernel (csrc/wide_bvh.cu) culls the lanes whose root visit
enters nothing, then walks each surviving ray on one thread of a persistent
warp behind a private stack, over child-planar float32 bounds. The kernel
and the plain version round alike and pop a node's children in one order,
(entry t, slot), so they walk the same nodes and agree bit for bit.

Tables (`WideTables`):
  bounds [N8, 8, 6] f32   per child: lo.xyz, hi.xyz
  planar [N8, 6, 8] f32   the same values child-planar (rows lo.x .. hi.z of
                          8 children): the kernel's aligned node loads
  child  [N8, 8]    i32   -1 empty; < INST_FLAG internal node index;
                          INST_FLAG | i instance leaf (enter the BLAS root
                          with instance i); LEAF_FLAG | l triangle leaf l,
                          whose rows are tris[l*leaf : (l+1)*leaf]
  tris   [T, 9]     f32   (p0, e1, e2) rows, leaves padded by duplication
  inst   [I+1, 4]   f32   (offset.xyz, scale); row 0 is the identity
For two-level tables the TLAS nodes come first and the BLAS root is node
`blas_root`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .intersect import KindHit, check_hit_out
from .kernels import INT, PTR

WIDTH = 8
# raw collapse encoding, as the reference's collapse_wide emits it:
# 0 empty; 1..INST_BASE-1 internal child m-1; >= INST_BASE instance leaf;
# < 0 triangle leaf v = -m-1 (leaf = v >> 5, count = v & 31)
INST_BASE = 1 << 24
FAR = np.float32(3.0e37)
# port child encoding (see the module docstring)
LEAF_FLAG = 1 << 30
INST_FLAG = 1 << 29
# per-thread stack entries of the CUDA kernel (STACK in csrc/wide_bvh.cu);
# an entry packs a node, leaf or instance index below INST_FLAG
STACK = 128
# columns of the kernel's counters (STATS_COLS in csrc/wide_bvh.cu): row 0
# is the cull pass (root visits of the live lanes it retires, -, -, -, live
# lanes, zeros), each further row one warp of the walk (node visits, leaf
# visits, node steps and leaf steps of the warp, rays walked, lanes at work
# summed over the node steps and over the leaf steps, lane 0's cycles in
# node work, leaf work and stack work)
STATS_COLS = 10
# the reference TPU kernel's table budgets (jet_pbrt_tpu/ops/wide_bvh.py:93),
# which decide the route of a mesh (scene/builder.py sweep_route)
_VMEM_BUDGET = 13 * 1024 * 1024
_SMEM_BUDGET = 256 * 1024


def fits_vmem(n_wide_nodes: int, n_tris: int, leaf_size: int = 16) -> bool:
    """The reference's gate for its wide kernel: bf16 planar bounds plus
    leaf-major float32 triangles within the VMEM budget, and the flat child
    table within the SMEM budget. The port's kernel has no such budget;
    the gate only routes meshes as the reference does."""
    pad = lambda x: ((max(x, 1) + 127) // 128) * 128
    n_leaves = (n_tris + leaf_size - 1) // leaf_size
    vmem = (pad(n_wide_nodes) * (6 * WIDTH) * 2
            + pad(n_leaves) * 9 * leaf_size * 4)
    smem = n_wide_nodes * WIDTH * 4
    return vmem <= _VMEM_BUDGET and smem <= _SMEM_BUDGET


class WideTables(NamedTuple):
    bounds: torch.Tensor   # [N8, 8, 6] f32
    child: torch.Tensor    # [N8, 8] i32
    tris: torch.Tensor     # [T, 9] f32
    inst: torch.Tensor     # [I+1, 4] f32
    blas_root: int         # first BLAS node (0 for single-level tables)
    depth: int             # wide levels on the deepest root-to-leaf path
    planar: torch.Tensor   # [N8, 6, 8] f32, bounds child-planar

    def to(self, device) -> "WideTables":
        return self._replace(bounds=self.bounds.to(device),
                             child=self.child.to(device),
                             tris=self.tris.to(device),
                             inst=self.inst.to(device),
                             planar=self.planar.to(device))


# ---------------------------------------------------------------------------
# host-side collapse: flattened binary skip-link BVH -> 8-wide tables
# ---------------------------------------------------------------------------

def _binary_children(bvh):
    """(left, right) of the DFS-preorder flatten: left(i) = i+1,
    right(i) = miss(i+1)."""
    bmin, _bmax, miss, leaf_first, _count = bvh
    n = len(bmin)
    left = np.full(n, -1, np.int64)
    right = np.full(n, -1, np.int64)
    idx = np.nonzero(leaf_first < 0)[0]
    left[idx] = idx + 1
    right[idx] = miss[np.minimum(idx + 1, n - 1)]
    return left, right


def _half_areas(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return e[:, 0] * (e[:, 1] + e[:, 2]) + e[:, 1] * e[:, 2]


def collapse_wide(bvh, leaf_size: int, leaf_meta=None):
    """Collapse a flattened binary BVH into 8-wide nodes by repeatedly
    opening the member with the largest surface area (the reference's
    collapse_wide, wide_bvh.py:141-207, without its TPU stack assert).

    Returns (bounds [N8, 8, 6] f32, meta [N8, 8] i32 in the raw collapse
    encoding, max_depth). Empty slots get inverted boxes (+FAR, -FAR)."""
    bmin, bmax, _miss, leaf_first, leaf_count = bvh
    if leaf_meta is None:
        def leaf_meta(first, count):
            if first % leaf_size:
                raise ValueError("leaf does not start on a leaf boundary")
            return -(1 + (first // leaf_size) * 32 + count)
    if leaf_size > 31:
        raise ValueError("leaf count field is 5 bits")
    left, right = _binary_children(bvh)
    is_leaf = leaf_first >= 0
    area = _half_areas(bmin, bmax) if len(bmin) else np.zeros(0)

    empty_box = np.array([FAR, FAR, FAR, -FAR, -FAR, -FAR], np.float32)
    bounds_rows: list[np.ndarray] = []
    meta_rows: list[np.ndarray] = []
    depth_of: list[int] = []

    def new_node(depth: int) -> int:
        bounds_rows.append(np.tile(empty_box, (WIDTH, 1)))
        meta_rows.append(np.zeros((WIDTH,), np.int32))
        depth_of.append(depth)
        return len(meta_rows) - 1

    work = [(new_node(1), 0)]
    while work:
        w, b = work.pop()
        members = [b] if is_leaf[b] else [left[b], right[b]]
        while len(members) < WIDTH:
            pick, best = -1, -1.0
            for j, m in enumerate(members):
                if not is_leaf[m] and area[m] > best:
                    pick, best = j, area[m]
            if pick < 0:
                break
            m = members.pop(pick)
            members.extend((left[m], right[m]))
        for k, m in enumerate(members):
            bounds_rows[w][k, :3] = bmin[m]
            bounds_rows[w][k, 3:] = bmax[m]
            if is_leaf[m]:
                meta_rows[w][k] = leaf_meta(int(leaf_first[m]),
                                            int(leaf_count[m]))
            else:
                c = new_node(depth_of[w] + 1)
                meta_rows[w][k] = 1 + c
                work.append((c, m))
    return np.stack(bounds_rows), np.stack(meta_rows), max(depth_of)


def _child_codes(meta: np.ndarray, node_offset: int = 0) -> np.ndarray:
    """Raw collapse meta -> port child codes; internal children shifted by
    node_offset."""
    m = meta.astype(np.int64)
    out = np.full(m.shape, -1, np.int64)
    internal = (m > 0) & (m < INST_BASE)
    out[internal] = m[internal] - 1 + node_offset
    ins = m >= INST_BASE
    out[ins] = INST_FLAG | (m[ins] - INST_BASE)
    tri = m < 0
    out[tri] = LEAF_FLAG | ((-m[tri] - 1) >> 5)
    return out.astype(np.int32)


def _inst_table(inst_off, inst_scale) -> np.ndarray:
    n = len(inst_scale)
    t = np.zeros((n + 1, 4), np.float32)
    t[0, 3] = 1.0
    if n:
        t[1:, :3] = np.asarray(inst_off, np.float32)
        t[1:, 3] = np.asarray(inst_scale, np.float32)
    return t


def _tables(bounds, child, tris, inst, blas_root, depth) -> WideTables:
    planar = np.ascontiguousarray(np.asarray(bounds).transpose(0, 2, 1))
    return WideTables(bounds=torch.tensor(bounds, dtype=torch.float32),
                      child=torch.tensor(child, dtype=torch.int32),
                      tris=torch.tensor(tris, dtype=torch.float32),
                      inst=torch.tensor(inst, dtype=torch.float32),
                      blas_root=int(blas_root), depth=int(depth),
                      planar=torch.tensor(planar, dtype=torch.float32))


def wide_tables(bvh, tris: np.ndarray, leaf_size: int) -> WideTables:
    """Single-level tables over a triangle soup (identity instance)."""
    bounds, meta, depth = collapse_wide(bvh, leaf_size)
    return _tables(bounds, _child_codes(meta), tris,
                   _inst_table(np.zeros((0, 3)), np.zeros(0)), 0, depth)


def wide_tables_instanced(tlas_bvh, blas_bvh, tris, inst_off, inst_scale,
                          leaf_size: int) -> WideTables:
    """Two-level tables: TLAS wide nodes first (their leaves enter the BLAS
    root with their instance), then the shared BLAS. tlas_bvh is built with
    leaf_size=1 over the instances in TLAS order (leaf_first = instance)."""
    def inst_leaf(first, count):
        if count != 1:
            raise ValueError("TLAS leaves hold exactly one instance")
        return INST_BASE + first

    tb, tm, t_depth = collapse_wide(tlas_bvh, 1, leaf_meta=inst_leaf)
    bb, bm, b_depth = collapse_wide(blas_bvh, leaf_size)
    n_tlas = tb.shape[0]
    child = np.concatenate([_child_codes(tm), _child_codes(bm, n_tlas)])
    return _tables(np.concatenate([tb, bb]), child, tris,
                   _inst_table(inst_off, inst_scale), n_tlas,
                   t_depth + b_depth)


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

_LIB = kernels.Library("wide_bvh", ["wide_bvh.cu"], {
    "wide_bvh_cast": [PTR] * 8 + [INT] * 6 + [PTR] * 7,
    "wide_bvh_walk_warps": [INT, INT, INT], "wide_bvh_blocks_per_sm": []})


def _check(tables: WideTables, o, d, tmin, tmax, leaf_size, n_tris):
    n = o.shape[0]
    dev = o.device
    n8 = tables.child.shape[0]
    # what the kernel's packed stack entry, its stack and the int32 hit
    # index can hold (shapes only, so before any tensor is touched)
    if (WIDTH - 1) * tables.depth + 1 > STACK:
        raise ValueError(f"wide-BVH depth {tables.depth} overflows the "
                         f"{STACK}-entry traversal stack")
    n_leaves = n_tris // max(leaf_size, 1)
    if max(n8, n_leaves, tables.inst.shape[0]) >= INST_FLAG:
        raise ValueError("a node, leaf or instance index of these tables "
                         "does not fit the stack entry's 29 bits")
    if max(tables.inst.shape[0] - 1, 1) * n_tris >= 2 ** 31:
        raise ValueError("hit indices inst * n_tris + row overflow int32")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel's int32 lane index holds "
                         "fewer than 2^31")
    for name, x, shape, dtype in (
            ("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
            ("tmin", tmin, (n,), torch.float32),
            ("tmax", tmax, (n,), torch.float32),
            ("bounds", tables.bounds, (n8, WIDTH, 6), torch.float32),
            ("planar", tables.planar, (n8, 6, WIDTH), torch.float32),
            ("child", tables.child, (n8, WIDTH), torch.int32),
            ("tris", tables.tris, (n_tris, 9), torch.float32),
            ("inst", tables.inst, (tables.inst.shape[0], 4), torch.float32)):
        kernels.check(name, x, dtype, shape, dev)
    if n_tris % leaf_size:
        raise ValueError("triangle rows are not a whole number of leaves")


@kernels.wrapper("wide_walk_kernel")
def intersect_wide(tables: WideTables, o, d, tmin, tmax, *, any_hit: bool,
                   has_inst: bool, leaf_size: int, n_tris: int,
                   with_stats: bool = False, out=None):
    """Closest hit (or any hit) of rays o, d [N,3] in (tmin, tmax) [N].

    Index = inst * n_tris + triangle row (inst 0 without instancing); an
    any-hit reports t = 0 when occluded. CUDA tensors launch the kernel of
    csrc/wide_bvh.cu (a cull pass, then the walk; one launch counted),
    which writes t, index and valid (isfinite(t)); CPU tensors take
    `intersect_wide_plain`. out: None, or the (t, index, valid) [N]
    tensors to write (rows of the caller's slabs; the plain version's
    outputs are copied there). with_stats (CUDA only: the counters are the
    kernel's) also returns them, [1 + walk warps, STATS_COLS] int64 (see
    STATS_COLS; `stats_summary` adds them up)."""
    _check(tables, o, d, tmin, tmax, leaf_size, n_tris)
    check_hit_out(out, o.shape[0], o.device)
    dev = o.device
    if dev.type == "cpu" and with_stats:
        raise ValueError("no wide-BVH kernel for device cpu: with_stats "
                         "counts the kernel's work")
    if not kernels.route("intersect_wide", dev, o=o, d=d, tmin=tmin,
                         tmax=tmax):
        return kernels.copy_out(intersect_wide_plain(
            tables, o, d, tmin, tmax, any_hit=any_hit, has_inst=has_inst,
            leaf_size=leaf_size, n_tris=n_tris), out)
    lib = _LIB.load()
    n = o.shape[0]
    stats = None
    if with_stats:
        with torch.cuda.device(dev):
            warps = lib.wide_bvh_walk_warps(int(any_hit), int(has_inst), 1)
        stats = torch.empty((1 + warps, STATS_COLS), dtype=torch.int64,
                            device=dev)
    if out is None:
        out = (torch.empty((n,), dtype=torch.float32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.bool, device=dev))
    # the survivor list and its two counters, in one tensor (the C entry
    # zeroes the counters on the stream; nothing is read back)
    scratch = torch.empty((n + 2,), dtype=torch.int32, device=dev)
    kernels.launch(
        intersect_wide, dev, lib.wide_bvh_cast, tables.planar.data_ptr(),
        tables.child.data_ptr(), tables.tris.data_ptr(),
        tables.inst.data_ptr(), o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
        tmax.data_ptr(), n, tables.blas_root, leaf_size, n_tris,
        int(any_hit), int(has_inst), out[0].data_ptr(), out[1].data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * n, kernels.ptr(stats),
        after=(out[2].data_ptr(),))
    hit = KindHit(*out)
    return (hit, stats) if with_stats else hit


def load_kernel(source: str = "wide_bvh.cu", name: str = "wide_bvh"):
    """The compiled wide-BVH library: csrc/<source>, or any file (an
    absolute path) with the same C entry points, built and loaded under
    `name`."""
    return _LIB.build([source], name)


def blocks_per_sm() -> int:
    """Resident blocks per SM of the walk (closest hit, instanced, no
    counters; the occupancy API on the current card)."""
    return int(_LIB.load().wide_bvh_blocks_per_sm())


def stats_summary(stats: torch.Tensor, leaf_size: int) -> dict:
    """The kernel's counters added up: node visits and triangle tests (as
    intersect_wide_plain(with_stats=True) counts them), leaf visits, live
    lanes, survivors of the cull, SIMD efficiency of the walk's node and
    leaf steps (lanes at work / 32 per warp step), and lane 0's cycles per
    kind of work."""
    c = [int(x) for x in stats[1:].sum(0).cpu()]
    cull = [int(x) for x in stats[0].cpu()]
    share = lambda visits, steps: visits / (32 * steps) if steps else 0.0
    return {"node_visits": cull[0] + c[0], "tri_tests": c[1] * leaf_size,
            "leaf_visits": c[1], "live": cull[4], "survivors": c[4],
            "simd_node": share(c[5], c[2]), "simd_leaf": share(c[6], c[3]),
            "simd": share(c[5] + c[6], c[2] + c[3]),
            "cycles_node": c[7], "cycles_leaf": c[8], "cycles_stack": c[9]}


def live_lanes(o, d, tmin, tmax):
    """Lanes with work: dead lanes (tmin = +inf or NaN, tmax < 0 or NaN)
    and rays with a NaN miss at once."""
    return ((tmax >= 0) & ~torch.isinf(tmin) & ~torch.isnan(tmin)
            & ~torch.isnan(o).any(1) & ~torch.isnan(d).any(1))


def _inv_dir(c):
    eps = 1e-12
    small = torch.abs(c) < eps
    guard = torch.where(c < 0, torch.full_like(c, -eps),
                        torch.full_like(c, eps))
    return 1.0 / torch.where(small, guard, c)


def _slab(nb, lx, ly, lz, jx, jy, jz):
    """Entry and exit distances of rays against boxes nb [..., 6] (lo.xyz,
    hi.xyz), one rounding per operation (the kernel's visit_node)."""
    t0x = (nb[..., 0] - lx) * jx
    t0y = (nb[..., 1] - ly) * jy
    t0z = (nb[..., 2] - lz) * jz
    t1x = (nb[..., 3] - lx) * jx
    t1y = (nb[..., 4] - ly) * jy
    t1z = (nb[..., 5] - lz) * jz
    t_en = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    t_ex = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    return t_en, t_ex


def wide_root_cull_plain(tables: WideTables, o, d, tmin, tmax):
    """The kernel's cull pass: True for a lane that is live and whose root
    visit (node 0 in world space: the TLAS root of instanced tables) pushes
    at least one child. Every other lane's result is the miss."""
    t_en, t_ex = _slab(tables.bounds[0][None], o[:, :1], o[:, 1:2], o[:, 2:],
                       _inv_dir(d[:, :1]), _inv_dir(d[:, 1:2]),
                       _inv_dir(d[:, 2:]))
    lo = torch.maximum(t_en, tmin[:, None])
    hi = torch.minimum(t_ex, tmax[:, None])
    hit = (lo <= hi) & (tables.child[0] != -1)[None]
    return live_lanes(o, d, tmin, tmax) & hit.any(1)


def mt_test(rows, o, d, tminl, tmax, scl):
    """Moller-Trumbore of rays (o in the instance's space, d) against
    (p0, e1, e2) rows, each product and sum rounded alone in this order, as
    csrc/tri_mt.cuh's mt_test, which both kernels include, rounds it:
    (t in the world, the accept rule t > tminl (instance space) and
    t_w < tmax (world)). The plain walk and the plain sweep share it, so a
    mesh's hits do not depend on its route."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    t_w = tt * scl
    ok = ((uu >= 0.0) & (vv >= 0.0) & (1.0 - uu - vv >= 0.0) & (tt > tminl)
          & (t_w < tmax))
    return t_w, ok


def intersect_wide_plain(tables: WideTables, o, d, tmin, tmax, *,
                         any_hit: bool, has_inst: bool, leaf_size: int,
                         n_tris: int, with_stats: bool = False):
    """The kernel's plain PyTorch version: the same per-ray stack walk over
    the same tables, batched over the rays that still have work. Each
    iteration pops one entry per ray: a node pushes its hit children so
    that they pop in the order (entry t, slot), in both modes; a leaf tests
    its triangles in slot order (a tie keeps the lowest slot). Entries
    whose entry distance exceeds min(tmax, best) are skipped. Each torch op
    rounds once, as the kernel's pinned arithmetic does.
    with_stats also returns the walk's work as Python ints: node visits
    (8 child slab tests each), the node visits that hit two or more
    children (and so rank them), and triangle tests (leaf_size per leaf
    visit)."""
    n = o.shape[0]
    dev = o.device
    inf = math.inf
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ix, iy, iz = _inv_dir(dx), _inv_dir(dy), _inv_dir(dz)
    best = torch.full((n,), inf, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    live = live_lanes(o, d, tmin, tmax)
    cap_s = (WIDTH - 1) * tables.depth + 1
    s_code = torch.zeros((n, cap_s), dtype=torch.int64, device=dev)
    s_inst = torch.full((n, cap_s), -1, dtype=torch.int64, device=dev)
    s_t = torch.zeros((n, cap_s), dtype=torch.float32, device=dev)
    sp = live.to(torch.int64)  # root entry: node 0, world space, t = 0
    bounds = tables.bounds
    child = tables.child.to(torch.int64)
    tris = tables.tris
    inst_tbl = tables.inst
    stats = {"node_visits": 0, "ranked_visits": 0, "tri_tests": 0}

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        top = sp[act] - 1
        sp[act] = top
        code = s_code[act, top]
        ins = s_inst[act, top]
        te = s_t[act, top]
        cap = torch.minimum(tmax[act], best[act])
        keep = te <= cap
        act, code, ins, te, cap, top = (x[keep] for x in
                                        (act, code, ins, te, cap, top))
        if has_inst:
            row = inst_tbl[ins + 1]
            scl = row[:, 3]
            inv = 1.0 / scl
            oxl = (ox[act] - row[:, 0]) * inv
            oyl = (oy[act] - row[:, 1]) * inv
            ozl = (oz[act] - row[:, 2]) * inv
            tminl = tmin[act] * inv
        else:
            oxl, oyl, ozl, tminl = ox[act], oy[act], oz[act], tmin[act]
        is_leaf = (code & LEAF_FLAG) != 0

        # ---- node entries: slab-test 8 children, push hits far to near
        nsel = torch.nonzero(~is_leaf).squeeze(1)
        stats["node_visits"] += nsel.numel()
        if nsel.numel():
            a = act[nsel]
            t_en, t_ex = _slab(bounds[code[nsel]], oxl[nsel, None],
                               oyl[nsel, None], ozl[nsel, None], ix[a, None],
                               iy[a, None], iz[a, None])
            if has_inst:
                capl = cap[nsel] * inv[nsel]
                lo = torch.maximum(t_en, tminl[nsel, None])
                hi = torch.minimum(t_ex, capl[:, None])
                key = lo * scl[nsel, None]
            else:
                lo = torch.maximum(t_en, tminl[nsel, None])
                hi = torch.minimum(t_ex, cap[nsel, None])
                key = lo
            cc = child[code[nsel]]                           # [M, 8]
            hit = (lo <= hi) & (cc != -1)
            if with_stats:
                stats["ranked_visits"] += int((hit.sum(1) >= 2).sum())
            key = torch.where(hit, key, torch.full_like(key, inf))
            # pop order (key, slot): ascending keys, equal keys by slot,
            # pushed last to first so that the first is on top
            order = torch.argsort(key, dim=1, stable=True)
            key = torch.gather(key, 1, order)
            cc = torch.gather(cc, 1, order)
            hit = torch.gather(hit, 1, order)
            ins_n = ins[nsel]
            p = sp[a]
            for k in reversed(range(WIDTH)):
                h = hit[:, k]
                c = cc[:, k]
                to_inst = (c & INST_FLAG) != 0
                e_code = torch.where(to_inst, torch.full_like(c, tables.blas_root),
                                     c)
                e_inst = torch.where(to_inst, c & ~INST_FLAG, ins_n)
                at = torch.where(h, p, torch.zeros_like(p))
                hi_ = h.nonzero().squeeze(1)
                s_code[a[hi_], at[hi_]] = e_code[hi_]
                s_inst[a[hi_], at[hi_]] = e_inst[hi_]
                s_t[a[hi_], at[hi_]] = key[hi_, k]
                p = p + h.to(torch.int64)
            sp[a] = p
        # ---- leaf entries: Moller-Trumbore over the leaf's slots in order
        lsel = torch.nonzero(is_leaf).squeeze(1)
        stats["tri_tests"] += lsel.numel() * leaf_size
        if lsel.numel():
            a = act[lsel]
            leaf = code[lsel] & ~LEAF_FLAG
            lx, ly, lz, tml = oxl[lsel], oyl[lsel], ozl[lsel], tminl[lsel]
            ddx, ddy, ddz = dx[a], dy[a], dz[a]
            b_t = best[a]
            b_i = best_idx[a]
            occ = torch.zeros_like(b_t, dtype=torch.bool)
            base_idx = leaf * leaf_size
            if has_inst:
                base_idx = base_idx + ins[lsel] * n_tris
            for k in range(leaf_size):
                t_w, ok = mt_test(
                    tris[leaf * leaf_size + k].unbind(1), (lx, ly, lz),
                    (ddx, ddy, ddz), tml, torch.minimum(tmax[a], b_t),
                    scl[lsel] if has_inst else 1.0)
                if any_hit:
                    occ = occ | ok
                else:
                    b_t = torch.where(ok, t_w, b_t)
                    b_i = torch.where(ok, (base_idx + k).to(torch.int32), b_i)
            if any_hit:
                best[a] = torch.where(occ, torch.zeros_like(b_t), b_t)
                sp[a] = torch.where(occ, torch.zeros_like(sp[a]), sp[a])
            else:
                best[a] = b_t
                best_idx[a] = b_i
    hit = KindHit(t=best, index=best_idx, valid=torch.isfinite(best))
    return (hit, stats) if with_stats else hit
