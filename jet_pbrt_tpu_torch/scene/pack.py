"""ScenePack: the whole scene as tensors, plus scene-level hit queries.

PyTorch counterpart of jet_pbrt_tpu/scene/pack.py. Static facts (array
sizes, light descriptors, routing) live in the frozen `SceneMeta`; numbers
live in `ScenePack`. Shape kinds are dispatched by a Python loop over the
kinds present. Meshes with a BVH (a triangle soup built with use_bvh, and
every instanced family) are traversed by ops/wide_bvh.py or, when the
builder routes them there (meshes beyond the reference's wide-kernel
budget, scene/builder.py), by ops/sweep_bvh.py; spheres, rects, disks and
small soups are tested by brute force, all of them in one ops/brute.py call
per cast. The work around the casts (the shadow segments, their sort key
and merge, the closest hit's reconstruction) is ops/rays.py's.

`SceneMeta` and `LightMeta` carry the reference's fields; they are copies
because the reference module imports JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops import brute as brute_ops
from ..ops import intersect as isect_ops
from ..ops import kernels
from ..ops import sweep_bvh
from ..ops import wide_bvh
from ..ops import linalg
from ..ops import rays as rays_ops
from ..ops import texture as tex_ops
from ..ops.linalg import dot, frame_from_z, normalize, to_local

KIND_TRI = 0
KIND_SPHERE = 1
KIND_RECT = 2
KIND_DISK = 3
KIND_INST = 4  # instanced mesh family mi has kind KIND_INST + mi

LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AREA = 2
LIGHT_ENV = 3


@dataclasses.dataclass(frozen=True)
class LightMeta:
    """Static description of one light; static_black marks a light whose
    radiance was zero at build time (NEE skips it)."""
    kind: int
    shape_kind: int = -1
    shape_idx: int = -1
    static_black: bool = False


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    name: str
    n_tri: int
    n_sph: int
    n_rect: int
    n_disk: int
    n_mat: int
    lights: tuple  # tuple[LightMeta, ...]
    use_bvh: bool = False
    n_tex: int = 0
    n_bvh_nodes: int = 0
    n_bvh_tris: int = 0
    present_lobes: tuple | None = None
    present_mf_kinds: tuple | None = None
    n_inst: tuple = ()
    n_blas_nodes: tuple = ()
    n_blas_tris: tuple = ()
    n_tlas_nodes: tuple = ()
    # routing, decided at build time (scene/builder.py): pallas_* -> the
    # cull-sweep kernel (ops/sweep_bvh.py), wide_* -> the 8-wide kernel;
    # exactly one of the two per BVH mesh
    pallas_bvh: bool = False
    pallas_blas: tuple = ()
    wide_bvh: bool = False
    wide_blas: tuple = ()
    wide_blas_root: tuple = ()
    n_groups_bvh: int = 0
    n_groups_blas: tuple = ()
    bvh_leaf_size: int = 4
    blas_leaf_size: tuple = ()

    @property
    def n_lights(self) -> int:
        return len(self.lights)

    @property
    def kernel_routed(self) -> bool:
        """True when any mesh goes through a traversal kernel: the signal
        for ray sorting to default on."""
        return bool(self.wide_bvh or self.pallas_bvh
                    or any(self.wide_blas) or any(self.pallas_blas))

    @property
    def env_light_indices(self) -> tuple:
        return tuple(i for i, lt in enumerate(self.lights)
                     if lt.kind == LIGHT_ENV)


class ScenePack(NamedTuple):
    tri_p0: torch.Tensor      # [T,3]
    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_n: torch.Tensor       # [T,3] face normal
    tri_uv: torch.Tensor      # [T,3,2]
    tri_mat: torch.Tensor     # [T] int32
    tri_light: torch.Tensor   # [T] int32, -1 = not emissive
    sph_c: torch.Tensor
    sph_r: torch.Tensor
    sph_mat: torch.Tensor
    sph_light: torch.Tensor
    rect_q: torch.Tensor      # [R,4,3]
    rect_n: torch.Tensor      # [R,3]
    rect_mat: torch.Tensor
    rect_light: torch.Tensor
    disk_c: torch.Tensor
    disk_n: torch.Tensor
    disk_r: torch.Tensor
    disk_mat: torch.Tensor
    disk_light: torch.Tensor
    mat_kind: torch.Tensor    # [M] int32
    mat_c0: torch.Tensor      # [M,3]
    mat_c1: torch.Tensor
    mat_s0: torch.Tensor      # [M]
    mat_s1: torch.Tensor
    mat_remap: torch.Tensor   # [M] bool
    mat_tex: torch.Tensor     # [M] int32 texture of Kd, -1 = none
    mat_mf: torch.Tensor      # [M] int32
    tex_kind: torch.Tensor
    tex_c0: torch.Tensor
    tex_c1: torch.Tensor
    tex_scale: torch.Tensor
    tex_image: torch.Tensor
    tex_wh: torch.Tensor
    light_c: torch.Tensor     # [L,3]
    light_pos: torch.Tensor
    light_dir: torch.Tensor
    world_center: torch.Tensor  # [3]
    world_radius: torch.Tensor  # []
    ray_eps: torch.Tensor       # []
    bvh_nodes: torch.Tensor     # [B,8] skip-link rows of the soup BVH
    bvh_tris: torch.Tensor      # [T',9] (p0, e1, e2) in BVH order
    blas_nodes: tuple           # per family [Bb,8]
    blas_tris: tuple            # per family [Tb,9]
    blas_n: tuple               # per family [Tb,3]
    blas_uv: tuple              # per family [Tb,3,2]
    inst_off: tuple             # per family [I,3]
    inst_scale: tuple           # per family [I]
    inst_mat: tuple             # per family [I] int32
    inst_light: tuple           # per family [I] int32
    tlas_nodes: tuple           # per family [K,8]
    inst_em_tris: tuple         # per family [Traw,9] (emissive instances)
    inst_em_n: tuple            # per family [Traw,3]
    bvh_wide: wide_bvh.WideTables | None   # soup tables iff meta.wide_bvh
    inst_wide: tuple            # per family WideTables iff wide_blas, else None
    bvh_sweep: sweep_bvh.SweepTables | None  # soup tables iff meta.pallas_bvh
    inst_sweep: tuple           # per family SweepTables iff pallas_blas,
                                # else None
    # mesh bounding spheres [8] (sweep_bvh.mesh_root_sphere) of the soup and
    # of each family's BLAS, whatever the route: the sort's pre-test reads them
    bvh_s_root: torch.Tensor
    inst_s_root: tuple

    def to(self, device) -> "ScenePack":
        def mv(x):
            if x is None:
                return None
            if isinstance(x, (wide_bvh.WideTables, sweep_bvh.SweepTables)):
                return x.to(device)
            if isinstance(x, tuple):
                return tuple(mv(v) for v in x)
            return x.to(device)
        return ScenePack(*(mv(v) for v in self))


class Hit(NamedTuple):
    """Batched FIntersection (reference: src/shape.h:33-77)."""
    valid: torch.Tensor     # [N] bool
    t: torch.Tensor         # [N]
    position: torch.Tensor  # [N,3]
    normal: torch.Tensor    # [N,3] geometric normal
    wo: torch.Tensor        # [N,3] -ray.dir
    uv: torch.Tensor        # [N,2] surface parameterisation (zero unless
                            # the scene has textures)
    mat_id: torch.Tensor    # [N] int32 (0 when invalid)
    light_id: torch.Tensor  # [N] int32, -1 = not an emitter


def _sweep(tables, n_tris, o, d, tmin, tmax, any_hit, stats, out=None):
    """One sweep cast, written into out where given (ops/sweep_bvh.py's);
    with a stats dict, adds the kernel's per-packet counters to it under
    sweep_<closest|shadow>_<packets|culls|tests|root|supers|spheres|
    listed|pops> (packets: those that culled at least one instance; tests:
    groups tested; root: rays past a root test; supers: (ray, super)
    passes; spheres: the cull's group sphere tests; listed: the groups the
    culls listed; pops: the groups the scans popped)."""
    if stats is None:
        return sweep_bvh.intersect_sweep(tables, o, d, tmin, tmax,
                                         any_hit=any_hit, n_tris=n_tris,
                                         out=out)
    hit, c = sweep_bvh.intersect_sweep(tables, o, d, tmin, tmax,
                                       any_hit=any_hit, n_tris=n_tris,
                                       with_stats=True, out=out)
    cls = "shadow" if any_hit else "closest"
    for k, v in (("packets", (c[:, 0] > 0).sum()), ("culls", c[:, 0].sum()),
                 ("tests", c[:, 1].sum()), ("root", c[:, 2].sum()),
                 ("supers", c[:, 6].sum()), ("spheres", c[:, 7].sum()),
                 ("listed", c[:, 8].sum()), ("pops", c[:, 9].sum())):
        key = f"sweep_{cls}_{k}"
        stats[key] = stats.get(key, 0) + v.to(torch.int64)
    return hit


def brute_shapes(meta: SceneMeta, pack: ScenePack) -> isect_ops.BruteShapes:
    """The pack's brute-force shapes: the triangles where no BVH kernel
    takes them, the spheres, rects and disks; None for a kind it lacks."""
    tri_brute = meta.n_tri > 0 and not (meta.pallas_bvh or meta.wide_bvh)
    return isect_ops.BruteShapes(
        tri=(pack.tri_p0, pack.tri_p1, pack.tri_p2) if tri_brute else None,
        sph=(pack.sph_c, pack.sph_r) if meta.n_sph else None,
        rect=(pack.rect_q, pack.rect_n) if meta.n_rect else None,
        disk=(pack.disk_c, pack.disk_n, pack.disk_r) if meta.n_disk
        else None)


def _kind_order(meta: SceneMeta, shapes) -> list:
    """The kinds of a scene's closest hit in `_kind_hits` order, which is
    merge_hits' tie order (an earlier kind keeps a tie): brute-force
    triangles or the soup's BVH first, then the instanced families,
    spheres, rects, disks. Each entry is (kind id, "brute" field or the
    BVH mesh: "soup" or the family index)."""
    out = []
    if meta.n_tri and (meta.pallas_bvh or meta.wide_bvh):
        out.append((KIND_TRI, "soup"))
    elif shapes.tri is not None:
        out.append((KIND_TRI, "tri"))
    out += [(KIND_INST + mi, mi) for mi in range(len(meta.n_inst))]
    out += [(k, f) for f, k in (("sph", KIND_SPHERE), ("rect", KIND_RECT),
                                ("disk", KIND_DISK))
            if getattr(shapes, f) is not None]
    return out


def _kind_hits(meta: SceneMeta, pack: ScenePack, o, d, tmin, tmax,
               any_hit: bool = False, stats: dict | None = None):
    """Closest (or any) hit per shape kind present in the scene: (hits,
    kinds). A BVH mesh takes the kernel its build routed it to
    (meta.pallas_* -> sweep, otherwise the wide kernel); the brute-force
    kinds are one brute_hits call, whose KindHits take their kinds' places
    (brute-force triangles first, then the instanced families, spheres,
    rects, disks). With any_hit, hits are [N] bool occlusion flags: one for
    all brute-force kinds together (kind None), then one per BVH mesh.
    Every cast writes its rows in place into slabs allocated here, one
    [K, N] t, index and valid slab (closest) or one [F, N] flag slab (any
    hit), each row a kind's in this order, so the merge and the hit
    reconstruction read them without a stack."""
    o, d, tmin, tmax = (x.contiguous() for x in (o, d, tmin, tmax))
    n = o.shape[0]
    dev = o.device
    shapes = brute_shapes(meta, pack)
    order = _kind_order(meta, shapes)
    meshes = [m for _, m in order if not isinstance(m, str) or m == "soup"]

    def bvh_cast(mesh, out):
        if mesh == "soup" and meta.pallas_bvh:
            return _sweep(pack.bvh_sweep, meta.n_bvh_tris, o, d, tmin, tmax,
                          any_hit, stats, out)
        if mesh == "soup":
            return wide_bvh.intersect_wide(
                pack.bvh_wide, o, d, tmin, tmax, any_hit=any_hit,
                has_inst=False, leaf_size=meta.bvh_leaf_size,
                n_tris=meta.n_bvh_tris, out=out)
        if meta.pallas_blas[mesh]:
            return _sweep(pack.inst_sweep[mesh], meta.n_blas_tris[mesh], o,
                          d, tmin, tmax, any_hit, stats, out)
        return wide_bvh.intersect_wide(
            pack.inst_wide[mesh], o, d, tmin, tmax, any_hit=any_hit,
            has_inst=True, leaf_size=meta.blas_leaf_size[mesh],
            n_tris=meta.n_blas_tris[mesh], out=out)

    if any_hit:
        brute = bool(shapes.present)
        flags = torch.empty((brute + len(meshes), n), dtype=torch.bool,
                            device=dev)
        if brute:
            brute_ops.brute_hits(o, d, tmin, tmax, shapes, True, out=flags[0])
        if meshes:
            # the BVH casts' t and index, which no caller reads
            scratch = (torch.empty((n,), dtype=torch.float32, device=dev),
                       torch.empty((n,), dtype=torch.int32, device=dev))
        for j, mesh in enumerate(meshes):
            bvh_cast(mesh, (*scratch, flags[brute + j]))
        return (list(flags.unbind(0)),
                [None] * brute + [KIND_TRI if m == "soup" else KIND_INST + m
                                  for m in meshes])
    k = len(order)
    slabs = (torch.empty((k, n), dtype=torch.float32, device=dev),
             torch.empty((k, n), dtype=torch.int32, device=dev),
             torch.empty((k, n), dtype=torch.bool, device=dev))
    if shapes.present:
        rows = [next(j for j, (_, m) in enumerate(order) if m == f)
                for f in shapes.present]
        brute_ops.brute_hits(o, d, tmin, tmax, shapes, False, out=slabs,
                             rows=rows)
    for j, (_, m) in enumerate(order):
        if not isinstance(m, str) or m == "soup":
            bvh_cast(m, tuple(x[j] for x in slabs))
    return ([isect_ops.KindHit(*(x[j] for x in slabs)) for j in range(k)],
            [kind for kind, _ in order])


def _rows(table, index):
    """table[index] with the index clamped into range: lanes of other kinds
    carry indices of their own tables, and their rows are discarded."""
    return linalg.gather_rows(table,
                              torch.clamp(index, 0, table.shape[0] - 1))


def _bary_uv(a, e1, e2, p, uvs):
    """Vertex uvs [N,3,2] interpolated at p by its barycentrics on the
    triangles (a, a + e1, a + e2) (reference package pack.py:483-507; the
    reference's own triangle GetUV is unused)."""
    v2 = p - a
    d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    d20, d21 = dot(v2, e1), dot(v2, e2)
    denom = torch.clamp_min(d00 * d11 - d01 * d01, 1e-18)
    wb = (d11 * d20 - d01 * d21) / denom
    wc = (d00 * d21 - d01 * d20) / denom
    wa = 1.0 - wb - wc
    return (uvs[:, 0] * wa[:, None] + uvs[:, 1] * wb[:, None]
            + uvs[:, 2] * wc[:, None])


def intersect(meta: SceneMeta, pack: ScenePack, o, d, tmin, tmax,
              stats: dict | None = None) -> Hit:
    """Closest hit over the whole scene (reference: src/scene.cc:25-33):
    the kinds' casts (`_kind_hits`), then their merge and the hit's
    reconstruction (`hit_reconstruct`: ops/rays.py's kernel on the card).
    UVs are computed only when the scene has textures. stats: optional
    dict that collects the sweep kernel's counters."""
    o, d = o.contiguous(), d.contiguous()
    hits, kinds = _kind_hits(meta, pack, o, d, tmin, tmax, stats=stats)
    if hits:
        return hit_reconstruct(meta, pack, o, d, hits, kinds)
    n = o.shape[0]
    dev = o.device
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    return Hit(valid=torch.zeros((n,), dtype=torch.bool, device=dev),
               t=torch.full((n,), math.inf, device=dev), position=z3,
               normal=z3, wo=-d,
               uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
               mat_id=torch.zeros((n,), dtype=torch.int32, device=dev),
               light_id=torch.full((n,), -1, dtype=torch.int32, device=dev))


def hit_reconstruct(meta: SceneMeta, pack: ScenePack, o, d, hits,
                    kinds) -> Hit:
    """The closest Hit of rays o, d [N,3] from each kind's KindHit (hits,
    in `_kind_hits` order, kinds their kind ids): `hit_reconstruct_plain`
    on CPU tensors; on CUDA tensors one launch of
    ops/rays.py::hit_reconstruct's kernel over the pack's tables, which
    raises on what the kernel cannot take."""
    if not kernels.route("hit_reconstruct", o.device):
        return hit_reconstruct_plain(meta, pack, o, d, hits, kinds)
    return Hit(*rays_ops.hit_reconstruct(o, d, hits, kinds,
                                         *hit_tables(meta, pack),
                                         meta.n_tex > 0))


def hit_tables(meta: SceneMeta, pack: ScenePack) -> tuple:
    """The pack's tables in ops/rays.py::hit_reconstruct's terms: ({shape
    table name: tensor}, [(triangles per instance, {family table name:
    tensor}) per instanced family])."""
    return ({name: getattr(pack, name) for name, *_ in rays_ops.HIT_TABLES},
            [(meta.n_blas_tris[mi], {name: getattr(pack, name)[mi]
                                     for name, *_ in rays_ops.FAMILY_TABLES})
             for mi in range(len(meta.n_inst))])


def hit_reconstruct_plain(meta: SceneMeta, pack: ScenePack, o, d, hits,
                          kinds) -> Hit:
    """ops/rays.py::hit_reconstruct's plain version: merge_hits, p = o +
    t_safe * d, and per kind its normal, material, light and, where the
    scene has textures, uv; material and light masked where nothing
    hits."""
    n = o.shape[0]
    dev = o.device
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    want_uv = meta.n_tex > 0
    t, kind, index, valid = isect_ops.merge_hits(hits, kinds)
    t_safe = torch.where(valid, t, torch.ones_like(t))
    p = o + t_safe[:, None] * d
    index = index.to(torch.int64)

    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    light_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for k in kinds:
        if k == KIND_TRI:
            nk = _rows(pack.tri_n, index)
            mk = _rows(pack.tri_mat, index)
            lk = _rows(pack.tri_light, index)
            if want_uv:
                a = _rows(pack.tri_p0, index)
                uvk = _bary_uv(a, _rows(pack.tri_p1, index) - a,
                               _rows(pack.tri_p2, index) - a, p,
                               _rows(pack.tri_uv, index))
        elif k == KIND_SPHERE:
            nk = normalize(p - _rows(pack.sph_c, index))
            mk = _rows(pack.sph_mat, index)
            lk = _rows(pack.sph_light, index)
            if want_uv:
                # lat-long of the unit normal (reference: src/shape.h:528-538,
                # on the normalised offset as the reference package does)
                phi = torch.atan2(nk[:, 2], nk[:, 0])
                theta = torch.asin(torch.clamp(nk[:, 1], -1.0, 1.0))
                uvk = torch.stack([1.0 - (phi + math.pi) / (2.0 * math.pi),
                                   (theta + math.pi / 2.0) / math.pi], dim=-1)
        elif k >= KIND_INST:
            mi = k - KIND_INST
            inst = index // meta.n_blas_tris[mi]
            ti = index % meta.n_blas_tris[mi]
            mk = _rows(pack.inst_mat[mi], inst)
            lk = _rows(pack.inst_light[mi], inst)
            nk = _rows(pack.blas_n[mi], ti)
            if want_uv:
                # barycentrics in instance space: the transform is a uniform
                # scale and a shift, so the weights are the world's
                rows = _rows(pack.blas_tris[mi], ti)
                p_l = ((p - _rows(pack.inst_off[mi], inst))
                       / torch.clamp_min(_rows(pack.inst_scale[mi], inst),
                                         1e-12)[:, None])
                uvk = _bary_uv(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], p_l,
                               _rows(pack.blas_uv[mi], ti))
        elif k == KIND_RECT:
            nk = isect_ops.rect_hit_normal(_rows(pack.rect_n, index), d)
            mk = _rows(pack.rect_mat, index)
            lk = _rows(pack.rect_light, index)
            if want_uv:
                # edge projection (reference: src/shape.h:437-447)
                q = _rows(pack.rect_q, index)
                v01 = q[:, 1] - q[:, 0]
                v03 = q[:, 3] - q[:, 0]
                v0p = p - q[:, 0]
                uvk = torch.stack(
                    [dot(v01, v0p) / torch.clamp_min(dot(v01, v01), 1e-12),
                     dot(v03, v0p) / torch.clamp_min(dot(v03, v03), 1e-12)],
                    dim=-1)
        else:
            nk = _rows(pack.disk_n, index)
            mk = _rows(pack.disk_mat, index)
            lk = _rows(pack.disk_light, index)
            if want_uv:
                # polar (reference: src/shape.h:223-236)
                c = _rows(pack.disk_c, index)
                local = to_local(frame_from_z(nk), p - c)
                phi = torch.atan2(local[:, 1], local[:, 0])
                phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
                r = torch.sqrt(torch.clamp_min(dot(p - c, p - c), 0.0))
                uvk = torch.stack(
                    [phi / (2 * math.pi),
                     r / torch.clamp_min(_rows(pack.disk_r, index), 1e-12)],
                    dim=-1)
        sel = kind == k
        normal = torch.where(sel[:, None], nk, normal)
        mat_id = torch.where(sel, mk, mat_id)
        light_id = torch.where(sel, lk, light_id)
        if want_uv:
            uv = torch.where(sel[:, None], uvk, uv)

    return Hit(valid=valid, t=t, position=p, normal=normal, wo=-d, uv=uv,
               mat_id=torch.where(valid, mat_id, torch.zeros_like(mat_id)),
               light_id=torch.where(valid, light_id,
                                    torch.full_like(light_id, -1)))


def occluded(meta: SceneMeta, pack: ScenePack, p_from, p_to,
             mask=None, sort: bool | None = None,
             stats: dict | None = None, roots=None,
             out=None) -> torch.Tensor:
    """Visibility between two point batches over the ray range
    [eps, dist - eps] (reference: src/scene.h:36-52); lanes with
    mask=False trace nothing and report unoccluded.

    sort (default: meta.kernel_routed, as in the reference) permutes the
    batch by (dead, needs-BVH, direction octant, origin Morton) before the
    casts and un-permutes the result; the permutation never changes the
    result. The set-up around the casts is ops/rays.py's (its kernels on
    the card): the key (`shadow_key`), then argsort, the permuted segments
    (`shadow_segments`), the casts, and the flags' OR scattered back to
    their lanes (`occlusion_merge`). stats: optional dict that collects the
    sweep kernel's counters. roots: the key's `rays_ops.root_table`, made
    here where None. out: None, or the [N] bool tensor the result is
    written into (a row of li_path's [J, N] slab of a vertex's shadow
    casts)."""
    if sort is None:
        sort = meta.kernel_routed
    p_from, p_to = p_from.contiguous(), p_to.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    perm = None
    if sort:
        key = rays_ops.shadow_key(meta, pack, p_from, p_to, mask,
                                  roots=roots)
        perm = torch.argsort(key, stable=True)
    o, d, tmin, tmax = rays_ops.shadow_segments(pack, p_from, p_to, mask,
                                                perm)
    flags, _ = _kind_hits(meta, pack, o, d, tmin, tmax, any_hit=True,
                          stats=stats)
    if not flags:
        if out is not None:
            return out.zero_()
        return torch.zeros(p_from.shape[:1], dtype=torch.bool,
                           device=p_from.device)
    return rays_ops.occlusion_merge(flags, perm, out=out)


def emitted(pack: ScenePack, hit: Hit) -> torch.Tensor:
    """One-sided area-light emission at a hit (reference:
    src/primitive.h:60-63, src/light.h:234-238)."""
    if pack.light_c.shape[0] == 0:
        return torch.zeros_like(hit.position)
    is_emitter = hit.light_id >= 0
    radiance = _rows(pack.light_c, hit.light_id.to(torch.int64))
    facing = dot(hit.normal, hit.wo) > 0.0
    return torch.where((is_emitter & facing & hit.valid)[:, None], radiance,
                       torch.zeros_like(radiance))


def effective_kd(meta: SceneMeta, pack: ScenePack, hit: Hit, c0, tex_id):
    """Kd, or its texture's tap at the hit where the material has a
    texture (tex_id from gather_material; reference package
    pack.py:595-607). The texels stay on the autograd tape."""
    if meta.n_tex == 0:
        return c0
    rgb = tex_ops.sample(pack, torch.clamp_min(tex_id, 0), hit.uv,
                         hit.position)
    return torch.where((tex_id >= 0)[:, None], rgb, c0)


def light_is_delta(meta: SceneMeta, light_index: int) -> bool:
    """Static is_delta_light (reference: src/light.h:25-28)."""
    return meta.lights[light_index].kind in (LIGHT_POINT, LIGHT_DIRECTIONAL)


def gather_material(pack: ScenePack, mat_id):
    """Material rows for a ray batch as (kind, c0, c1, s0, s1, remap, tex,
    mf), by plain indexing."""
    i = mat_id.to(torch.int64)
    return tuple(linalg.gather_rows(t, i) for t in (
        pack.mat_kind, pack.mat_c0, pack.mat_c1, pack.mat_s0, pack.mat_s1,
        pack.mat_remap, pack.mat_tex, pack.mat_mf))
