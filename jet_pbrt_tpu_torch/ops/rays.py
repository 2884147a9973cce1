"""The casts' set-up and the closest hit's reconstruction, as hand-written
kernels on the card.

Counterpart of the per-lane work that XLA fuses around the casts under
jax.jit(wave) (jet_pbrt_tpu/models/render.py:54): occluded's segment and
sort key (jet_pbrt_tpu/scene/pack.py:537-578, ops/sort.py:77-127), li_path's
sort key between bounces (models/integrators.py:250-260) and intersect's
merge and hit reconstruction (scene/pack.py:333-507). The reference has no
Pallas kernel for any of it. Four functions:

    shadow_key       csrc/rays.cu shadow_key_kernel<BOUNCE> on CUDA
                     tensors: occluded's segment, the BVH root-sphere test
                     against `root_table` and ops/sort.py::shadow_sort_key's
                     key in one pass; with bounce=True ray_sort_key's key of
                     li_path's sort; `shadow_key_plain` on CPU tensors.
    shadow_segments  shadow_segments_kernel: the segment of lane perm[j]
                     (lane j where the cast is not sorted) as row j of
                     contiguous o, d, tmin, tmax; `shadow_segments_plain`.
    occlusion_merge  occlusion_merge_kernel: the OR of a cast's flags and
                     the un-permute out[perm[j]] = occ[j];
                     `occlusion_merge_plain` (argsort, then a gather).
    hit_reconstruct  hit_reconstruct_kernel: merge_hits over the kinds and
                     every field of the closest hit, from the tables the
                     caller hands it; its plain version and its routing by
                     device are scene/pack.py's (`hit_reconstruct`,
                     `hit_reconstruct_plain`), beside Hit and the pack.

On a CUDA tensor a wrapper launches its kernel or raises on what the kernel
cannot take (dtype, shape, device, contiguity, an input that requires
grad: the kernels have no backward); nothing falls back. The plain versions
are the torch code the callers ran before the kernels, and the kernels
match them bit for bit on the card (see the source's note on how their
arithmetic is pinned). Any number of flags, kinds and instanced families
fits one launch: the flags and the kinds' hits go in as [K, N] slabs, the
kinds' tables through an int64 table on the device (`hit_table`). Each
kernel launches on the current stream, allocates nothing itself and
synchronises nothing, so a captured wave (models/graph.py) holds it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import sort as sort_ops
from . import kernels
from .kernels import check, ptr
from .linalg import dot

# csrc/rays.cu's kind ids (scene/pack.py's KIND_*)
KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST = 0, 1, 2, 3, 4
# hit_reconstruct's shape tables in csrc/rays.cu's order: (name, dtype, row
# width, kind that reads it, read only for uvs); scene/pack.py fills each
# from the pack's field of its name
HIT_TABLES = (
    ("tri_p0", torch.float32, 3, KIND_TRI, True),
    ("tri_p1", torch.float32, 3, KIND_TRI, True),
    ("tri_p2", torch.float32, 3, KIND_TRI, True),
    ("tri_n", torch.float32, 3, KIND_TRI, False),
    ("tri_uv", torch.float32, 6, KIND_TRI, True),
    ("tri_mat", torch.int32, 1, KIND_TRI, False),
    ("tri_light", torch.int32, 1, KIND_TRI, False),
    ("sph_c", torch.float32, 3, KIND_SPHERE, False),
    ("sph_mat", torch.int32, 1, KIND_SPHERE, False),
    ("sph_light", torch.int32, 1, KIND_SPHERE, False),
    ("rect_q", torch.float32, 12, KIND_RECT, True),
    ("rect_n", torch.float32, 3, KIND_RECT, False),
    ("rect_mat", torch.int32, 1, KIND_RECT, False),
    ("rect_light", torch.int32, 1, KIND_RECT, False),
    ("disk_c", torch.float32, 3, KIND_DISK, True),
    ("disk_n", torch.float32, 3, KIND_DISK, False),
    ("disk_r", torch.float32, 1, KIND_DISK, True),
    ("disk_mat", torch.int32, 1, KIND_DISK, False),
    ("disk_light", torch.int32, 1, KIND_DISK, False))
# each instanced family's tables in csrc/rays.cu's order: (name, dtype, row
# width, read only for uvs); inst_* rows are instances, the others the
# family's triangles
FAMILY_TABLES = (
    ("inst_mat", torch.int32, 1, False),
    ("inst_light", torch.int32, 1, False),
    ("blas_n", torch.float32, 3, False),
    ("blas_tris", torch.float32, 9, True),
    ("blas_uv", torch.float32, 6, True),
    ("inst_off", torch.float32, 3, True),
    ("inst_scale", torch.float32, 1, True))


class _KeyArgs(ctypes.Structure):
    _fields_ = ([("n", ctypes.c_int), ("n_roots", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in (
                    "a", "b", "live", "ray_eps", "center", "radius", "roots",
                    "key")])


class _SegArgs(ctypes.Structure):
    _fields_ = ([("n", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in (
                    "p_from", "p_to", "mask", "perm", "ray_eps", "o", "d",
                    "tmin", "tmax")])


class _MergeArgs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("n_flags", ctypes.c_int),
                ("flags", ctypes.c_void_p), ("perm", ctypes.c_void_p),
                ("out", ctypes.c_void_p)]


class _HitArgs(ctypes.Structure):
    _fields_ = ([("n", ctypes.c_int), ("n_kinds", ctypes.c_int),
                 ("want_uv", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in (
                    "o", "d", "kt", "ki", "table", "valid", "t", "pos", "nrm",
                    "wo", "uv", "mat_id", "light_id")])


_LIB = kernels.Library(
    "rays", ["rays.cu"],
    {"shadow_key": [ctypes.POINTER(_KeyArgs), ctypes.c_int, ctypes.c_void_p],
     **{name: [ctypes.POINTER(args), ctypes.c_void_p] for name, args in (
         ("shadow_segments", _SegArgs), ("occlusion_merge", _MergeArgs),
         ("hit_reconstruct", _HitArgs))}},
    {"rays_key_args_size": _KeyArgs, "rays_segments_args_size": _SegArgs,
     "rays_merge_args_size": _MergeArgs, "rays_hit_args_size": _HitArgs})


def _slab(xs) -> torch.Tensor:
    """The [K, N] tensor whose rows are the [N] tensors xs: a view where
    they already are consecutive rows of one tensor (as brute_hits returns
    its kinds), else their stack."""
    x0 = xs[0]
    n, size = x0.shape[0], x0.element_size()
    if all(x.dtype == x0.dtype and x.shape == x0.shape and x.is_contiguous()
           and x.untyped_storage().data_ptr()
           == x0.untyped_storage().data_ptr()
           and x.data_ptr() == x0.data_ptr() + j * n * size
           for j, x in enumerate(xs)):
        return x0.as_strided((len(xs), n), (n, 1))
    return torch.stack(xs)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def segment_plain(pack, p_from, p_to, mask):
    """occluded's segment from p_from to p_to over [eps, dist - eps]: (o,
    d, tmin, tmax); lanes with mask False get tmin = inf, tmax = -1."""
    delta = p_to - p_from
    dist = torch.sqrt(torch.clamp_min(dot(delta, delta), 1e-20))
    d = delta / dist[:, None]
    tmin = pack.ray_eps.expand(dist.shape)
    tmax = dist - pack.ray_eps
    if mask is not None:
        tmin = torch.where(mask, tmin, torch.full_like(dist, math.inf))
        tmax = torch.where(mask, tmax, torch.full_like(dist, -1.0))
    return p_from, d, tmin, tmax


def shadow_key_plain(meta, pack, a, b, live=None, bounce: bool = False,
                     roots=None):
    """The int32 sort key [N]: of occluded's segments from a = p_from to b
    = p_to (live: the mask or None), ops/sort.py::shadow_sort_key; with
    bounce, of li_path's rays a = o, b = d (live: active) between bounces,
    ops/sort.py::ray_sort_key with needs_bvh. roots is the kernel's
    (`root_table`); bvh_needed makes the same spheres itself."""
    if not bounce:
        o, d, tmin, tmax = segment_plain(pack, a, b, live)
        return sort_ops.shadow_sort_key(meta, pack, tmax > 0.0, o, d, tmin,
                                        tmax)
    n = a.shape[0]
    eps = pack.ray_eps.expand(n)
    inf = torch.full((n,), math.inf, device=a.device)
    neg = torch.full((n,), -1.0, device=a.device)
    world_lo = (pack.world_center - pack.world_radius).detach()
    world_inv = (1.0 / torch.clamp_min(2.0 * pack.world_radius,
                                       1e-12)).detach().expand(3)
    needs = sort_ops.bvh_needed(meta, pack, a, b,
                                torch.where(live, eps, inf),
                                torch.where(live, inf, neg))
    return sort_ops.ray_sort_key(live, a, b, world_lo, world_inv,
                                 needs_bvh=needs)


def shadow_segments_plain(pack, p_from, p_to, mask, perm):
    """occluded's segments, row j that of lane perm[j] (lane j where perm
    is None), as contiguous (o [N,3], d [N,3], tmin [N], tmax [N])."""
    o, d, tmin, tmax = segment_plain(pack, p_from, p_to, mask)
    if perm is not None:
        o, d, tmin, tmax = o[perm], d[perm], tmin[perm], tmax[perm]
    return tuple(x.contiguous() for x in (o, d, tmin, tmax))


def occlusion_merge_plain(flags, perm):
    """The OR of a cast's [N] bool flags, row j moved back to lane perm[j]
    (argsort plus gather, never a scatter) where the cast was sorted."""
    occ = flags[0]
    for f in flags[1:]:
        occ = occ | f
    if perm is not None:
        occ = occ[torch.argsort(perm)]
    return occ


# --------------------------------------------------------------------------
# the root table
# --------------------------------------------------------------------------

def root_table(meta, pack) -> torch.Tensor:
    """The BVH root spheres that ops/sort.py::bvh_needed tests, as a
    float32 [R, 4] (center, radius) tensor on the pack's device: the soup's
    where meta.use_bvh and meta.n_tri, then every instance of each family
    (root[0:3] * scale + off, root[5] * scale: bvh_needed's own torch
    expressions, so the same bits). A few torch ops, made anew from the
    pack at each call, so that a captured wave makes it from the pack it
    replays; li_path makes it once a wave."""
    rows = []
    if meta.use_bvh and meta.n_tri:
        root = pack.bvh_s_root
        rows.append(torch.cat([root[0:3], root[5:6]])[None])
    for mi in range(len(meta.n_inst)):
        root = pack.inst_s_root[mi]
        scale = pack.inst_scale[mi][:meta.n_inst[mi]]
        off = pack.inst_off[mi][:meta.n_inst[mi]]
        rows.append(torch.cat([root[None, 0:3] * scale[:, None] + off,
                               (root[5] * scale)[:, None]], dim=1))
    if not rows:
        return torch.zeros((0, 4), dtype=torch.float32,
                           device=pack.world_center.device)
    return torch.cat(rows).contiguous()


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def check_key_inputs(pack, a, b, live, bounce: bool, dev) -> int:
    """Raise unless shadow_key_kernel can take the inputs: a, b contiguous
    float32 [N,3], live a contiguous bool [N] (or None where not bounce),
    the pack's ray_eps, world_center and world_radius float32 of their
    shapes, all on dev. Returns N."""
    n = a.shape[0] if a.dim() == 2 else -1
    check("a", a, torch.float32, (n, 3), dev)
    check("b", b, torch.float32, (n, 3), dev)
    if live is None and bounce:
        raise ValueError("shadow_key: bounce=True takes the active lanes")
    if live is not None:
        check("live", live, torch.bool, (n,), dev)
    check("pack.ray_eps", pack.ray_eps, torch.float32, (), dev)
    check("pack.world_center", pack.world_center, torch.float32, (3,), dev)
    check("pack.world_radius", pack.world_radius, torch.float32, (), dev)
    kernels.check_lanes(n)
    return n


@kernels.wrapper("shadow_key_kernel")
def shadow_key(meta, pack, a, b, live=None, bounce: bool = False,
               roots=None):
    """`shadow_key_plain`: one launch of shadow_key_kernel<bounce> on CUDA
    tensors (a, b [N,3] float32; live [N] bool, which bounce needs; roots
    the [R, 4] `root_table`, made here where None), the plain version on
    CPU tensors."""
    dev = a.device
    if not kernels.route("shadow_key", dev, a=a, b=b, ray_eps=pack.ray_eps,
                         world_center=pack.world_center,
                         world_radius=pack.world_radius, roots=roots):
        return shadow_key_plain(meta, pack, a, b, live, bounce, roots)
    n = check_key_inputs(pack, a, b, live, bounce, dev)
    if roots is None:
        roots = root_table(meta, pack)
        kernels.no_grad_inputs("shadow_key", roots=roots)
    check("roots", roots, torch.float32, (roots.shape[0], 4), dev)
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    args = _KeyArgs(n=n, n_roots=roots.shape[0], a=ptr(a), b=ptr(b),
                    live=ptr(live), ray_eps=ptr(pack.ray_eps),
                    center=ptr(pack.world_center),
                    radius=ptr(pack.world_radius), roots=ptr(roots),
                    key=ptr(key))
    kernels.launch(shadow_key, dev, _LIB.load().shadow_key, ctypes.byref(args),
                   int(bounce))
    return key


def check_segment_inputs(pack, p_from, p_to, mask, perm, dev) -> int:
    """Raise unless shadow_segments_kernel can take the inputs: p_from,
    p_to contiguous float32 [N,3], mask bool [N] or None, perm int64 [N]
    or None, the pack's ray_eps a float32 scalar, all on dev. Returns N."""
    n = p_from.shape[0] if p_from.dim() == 2 else -1
    check("p_from", p_from, torch.float32, (n, 3), dev)
    check("p_to", p_to, torch.float32, (n, 3), dev)
    if mask is not None:
        check("mask", mask, torch.bool, (n,), dev)
    if perm is not None:
        check("perm", perm, torch.int64, (n,), dev)
    check("pack.ray_eps", pack.ray_eps, torch.float32, (), dev)
    kernels.check_lanes(n)
    return n


@kernels.wrapper("shadow_segments_kernel")
def shadow_segments(pack, p_from, p_to, mask=None, perm=None):
    """`shadow_segments_plain`: one launch of shadow_segments_kernel on
    CUDA tensors (p_from, p_to [N,3] float32, mask [N] bool or None, perm
    [N] int64 or None), the plain version on CPU tensors."""
    dev = p_from.device
    if not kernels.route("shadow_segments", dev, p_from=p_from, p_to=p_to,
                         ray_eps=pack.ray_eps):
        return shadow_segments_plain(pack, p_from, p_to, mask, perm)
    n = check_segment_inputs(pack, p_from, p_to, mask, perm, dev)
    o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d = torch.empty_like(o)
    tmin = torch.empty((n,), dtype=torch.float32, device=dev)
    tmax = torch.empty_like(tmin)
    args = _SegArgs(n=n, p_from=ptr(p_from), p_to=ptr(p_to),
                    mask=ptr(mask), perm=ptr(perm),
                    ray_eps=ptr(pack.ray_eps), o=ptr(o), d=ptr(d),
                    tmin=ptr(tmin), tmax=ptr(tmax))
    kernels.launch(shadow_segments, dev, _LIB.load().shadow_segments,
                   ctypes.byref(args))
    return o, d, tmin, tmax


def check_merge_inputs(flags, perm, dev) -> int:
    """Raise unless occlusion_merge_kernel can take the inputs: one or more
    contiguous bool [N] flags and perm int64 [N] or None, all on dev.
    Returns N."""
    if not flags:
        raise ValueError("occlusion_merge: a cast with no flag has nothing "
                         "to merge")
    n = flags[0].shape[0] if flags[0].dim() == 1 else -1
    for j, f in enumerate(flags):
        check(f"flags[{j}]", f, torch.bool, (n,), dev)
    if perm is not None:
        check("perm", perm, torch.int64, (n,), dev)
    kernels.check_lanes(n)
    return n


@kernels.wrapper("occlusion_merge_kernel")
def occlusion_merge(flags, perm=None, out=None):
    """`occlusion_merge_plain`: one launch of occlusion_merge_kernel on
    CUDA tensors (flags: one or more [N] bool, as one [F, N] slab; perm
    [N] int64, a permutation of the lanes, or None; out: None or the
    contiguous [N] bool tensor to write), the plain version on CPU tensors
    (its result copied into out)."""
    if not flags:
        raise ValueError("occlusion_merge: a cast with no flag has nothing "
                         "to merge")
    dev = flags[0].device
    if out is not None:
        check("out", out, torch.bool, (flags[0].shape[0],), dev)
    if not kernels.route("occlusion_merge", dev,
                         **{f"flags[{j}]": f for j, f in enumerate(flags)}):
        return kernels.copy_out(occlusion_merge_plain(flags, perm), out)
    n = check_merge_inputs(flags, perm, dev)
    slab = _slab(flags)
    if out is None:
        out = torch.empty((n,), dtype=torch.bool, device=dev)
    args = _MergeArgs(n=n, n_flags=len(flags), flags=ptr(slab),
                      perm=ptr(perm), out=ptr(out))
    kernels.launch(occlusion_merge, dev, _LIB.load().occlusion_merge,
                   ctypes.byref(args))
    return out


def _used_tables(kinds, tables: dict, families: list, want_uv: bool):
    """The tables hit_reconstruct_kernel reads for these kinds: [(name,
    dtype, width, tensor)] of the shape tables of the kinds present and of
    every instanced family the kinds name (uv tables only where want_uv).
    Raises where one is missing."""
    used = []
    for name, dtype, w, kind, uv_only in HIT_TABLES:
        if kind in kinds and (want_uv or not uv_only):
            used.append((name, dtype, w, tables.get(name)))
    for k in kinds:
        if k >= KIND_INST:
            if k - KIND_INST >= len(families):
                raise ValueError(f"hit_reconstruct: kind {k} names family "
                                 f"{k - KIND_INST} of {len(families)}")
            _, tabs = families[k - KIND_INST]
            used += [(f"{name}[{k - KIND_INST}]", dtype, w, tabs.get(name))
                     for name, dtype, w, uv_only in FAMILY_TABLES
                     if want_uv or not uv_only]
    missing = [name for name, *_, x in used if x is None]
    if missing:
        raise ValueError(f"hit_reconstruct: no table {', '.join(missing)}")
    return used


def check_hit_inputs(o, d, hits, kinds, tables, families, want_uv,
                     dev) -> tuple:
    """Raise unless hit_reconstruct_kernel can take the inputs: o, d
    contiguous float32 [N,3], one or more hits of contiguous float32 t and
    int32 index [N] with one kind id each, and of the tables it reads
    (_used_tables) each a contiguous tensor of its dtype on dev with at
    least one row of its width. Returns (N, {name: table it reads})."""
    n = o.shape[0] if o.dim() == 2 else -1
    check("o", o, torch.float32, (n, 3), dev)
    check("d", d, torch.float32, (n, 3), dev)
    if not hits or len(hits) != len(kinds):
        raise ValueError(f"hit_reconstruct: one or more kinds, one id "
                         f"each; got {len(hits)} hits, {len(kinds)} ids")
    for j, h in enumerate(hits):
        check(f"hits[{j}].t", h.t, torch.float32, (n,), dev)
        check(f"hits[{j}].index", h.index, torch.int32, (n,), dev)
    used = _used_tables(kinds, tables, families, want_uv)
    for name, dtype, w, x in used:
        rows = x.shape[0] if x.dim() else 0
        if rows == 0 or x.numel() != rows * w:
            raise ValueError(f"{name}: expected rows of {w} values, at "
                             f"least one, got {list(x.shape)}")
        check(name, x, dtype, tuple(x.shape), dev)
    kernels.check_lanes(n)
    return n, {name: x for name, *_, x in used}


# hit_table's values -> the int64 tensor; kept for the process, since a
# captured wave reads it by address
_HIT_TABLE_CACHE: dict = {}


def hit_table(kinds, families: list, used: dict, dev) -> torch.Tensor:
    """hit_reconstruct_kernel's int64 table (csrc/rays.cu's layout) of the
    tables it reads (used: check_hit_inputs'): each shape table's address
    and rows (0 for one the kinds do not read), the kinds' ids, then per
    family its triangles per instance and each table's address and rows.
    Its values are addresses and counts, never the tables' contents, so
    one made at the first eager call holds for every later call on the
    same tables. It is made by a host copy at that call and kept (as
    ops/shade.py::_statics): a CUDA graph cannot capture the copy, and
    every capture follows an eager warm-up call (models/graph.py) on the
    same pack, which makes it."""
    vals = []
    for name, *_ in HIT_TABLES:
        x = used.get(name)
        vals += [x.data_ptr(), x.shape[0]] if x is not None else [0, 0]
    vals += list(kinds)
    for f, (n_tris, _) in enumerate(families):
        vals.append(n_tris)
        for name, *_ in FAMILY_TABLES:
            x = used.get(f"{name}[{f}]")
            vals += [x.data_ptr(), x.shape[0]] if x is not None else [0, 0]
    key = (tuple(vals), str(dev))
    if key not in _HIT_TABLE_CACHE:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("hit_table: the kinds' table is made by an "
                               "eager call before a capture")
        _HIT_TABLE_CACHE[key] = torch.tensor(vals, dtype=torch.int64,
                                             device=dev)
    return _HIT_TABLE_CACHE[key]


@kernels.wrapper("hit_reconstruct_kernel")
def hit_reconstruct(o, d, hits, kinds, tables: dict, families: list,
                    want_uv: bool) -> tuple:
    """One launch of hit_reconstruct_kernel on CUDA tensors: the closest
    hit of rays o, d [N,3] float32 over hits (KindHits of [N] float32 t and
    int32 index in `_kind_hits` order, as [K, N] slabs) of kinds (their
    kind ids), with the tables of the shape kinds ({HIT_TABLES name:
    tensor}) and of each instanced family ([(triangles per instance,
    {FAMILY_TABLES name: tensor})]); uvs where want_uv, else zeros.
    Returns scene/pack.py::Hit's fields in order, contiguous. Its plain
    version is scene/pack.py::hit_reconstruct_plain, which that module's
    hit_reconstruct takes on CPU tensors; any other device raises here."""
    dev = o.device
    if not kernels.route("hit_reconstruct", dev):
        raise ValueError("no hit_reconstruct kernel for device cpu: the "
                         "plain version is scene/pack.py's")
    n, used = check_hit_inputs(o, d, hits, kinds, tables, families,
                               want_uv, dev)
    kernels.no_grad_inputs("hit_reconstruct", o=o, d=d,
                           **{f"hits[{j}].t": h.t for j, h in enumerate(hits)},
                           **used)
    kt = _slab([h.t for h in hits])
    ki = _slab([h.index for h in hits])
    table = hit_table(kinds, families, used, dev)
    f32 = torch.float32
    out = (torch.empty((n,), dtype=torch.bool, device=dev),
           torch.empty((n,), dtype=f32, device=dev),
           torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty((n, 2), dtype=f32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev))
    args = _HitArgs(n=n, n_kinds=len(hits), want_uv=int(want_uv),
                    o=ptr(o), d=ptr(d), kt=ptr(kt), ki=ptr(ki),
                    table=ptr(table),
                    **dict(zip(("valid", "t", "pos", "nrm", "wo", "uv",
                                "mat_id", "light_id"), map(ptr, out))))
    kernels.launch(hit_reconstruct, dev, _LIB.load().hit_reconstruct,
                   ctypes.byref(args))
    return out

