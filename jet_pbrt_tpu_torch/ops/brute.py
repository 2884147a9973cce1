"""Every brute-force shape of a scene against one ray batch, as one kernel
launch on the card.

Counterpart of the brute-force tests of jet_pbrt_tpu/ops/intersect.py
(:72-215) under jax.jit(wave): XLA fuses each kind's [M, N] broadcast with
its reduction; the reference has no Pallas kernel for it. One call tests
the rays of one cast against the triangles (those no BVH kernel takes),
spheres, rects and disks of a scene (`intersect.BruteShapes`):

    brute_hits   csrc/brute.cu brute_hits_kernel on CUDA tensors: each
                 block lists the live lanes of its span and writes the
                 dead ones at once, then tests the live rays in rounds,
                 one a thread, against every shape, the shapes staged
                 through shared memory as float4 rows while the previous
                 tile is tested;
                 `intersect.brute_hits_plain` on CPU tensors.

Closest mode returns one KindHit per kind present, as the intersect_*
functions compute it; any-hit mode the [N] bool OR of their valid. On a
CUDA tensor the wrapper launches the kernel or raises; nothing falls
back. The kernel matches the plain version bit for bit on the card (see
the source's note on how its arithmetic is pinned).
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .intersect import BruteShapes, KindHit, brute_hits_plain

# BruteShapes field -> (its tensors' names, each tensor's shape past the
# shape count)
_SHAPE_TENSORS = {"tri": (("tri_p0", (3,)), ("tri_p1", (3,)),
                          ("tri_p2", (3,))),
                  "sph": (("sph_c", (3,)), ("sph_r", ())),
                  "rect": (("rect_q", (4, 3)), ("rect_n", (3,))),
                  "disk": (("disk_c", (3,)), ("disk_n", (3,)),
                           ("disk_r", ()))}
_COUNTS = {"tri": "n_tri", "sph": "n_sph", "rect": "n_rect",
           "disk": "n_disk"}
_PTRS = ("o", "d", "tmin", "tmax") + tuple(
    name for spec in _SHAPE_TENSORS.values() for name, _ in spec) + (
    "t", "index", "valid")


class _BruteArgs(ctypes.Structure):
    _fields_ = ([("n", ctypes.c_int)]
                + [(c, ctypes.c_int) for c in _COUNTS.values()]
                + [(k, ctypes.c_void_p) for k in _PTRS]
                + [("row", ctypes.c_int * 4)])


_LIB = kernels.Library(
    "brute", ["brute.cu"],
    {"brute_hits": [ctypes.POINTER(_BruteArgs), ctypes.c_int,
                    ctypes.c_void_p]},
    {"brute_args_size": _BruteArgs})


def shape_tensors(shapes: BruteShapes) -> dict:
    """{name: tensor} of the kinds present (the kernel's argument names)."""
    return {name: x for f in shapes.present
            for (name, _), x in zip(_SHAPE_TENSORS[f], getattr(shapes, f))}


def check_inputs(o, d, tmin, tmax, shapes: BruteShapes) -> dict:
    """Raise unless the rays (o, d [N,3], tmin, tmax [N]) and every shape
    tensor are contiguous float32 of their shapes on one device and off
    the autograd tape (the kernel reads raw pointers and has no backward;
    geometry is no differentiable field). Returns {kind count: shapes}."""
    n = o.shape[0] if o.dim() == 2 else -1
    dev = o.device
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tmin", tmin, (n,)), ("tmax", tmax, (n,))):
        kernels.check(name, x, torch.float32, shape, dev)
    counts = dict.fromkeys(_COUNTS.values(), 0)
    for f in shapes.present:
        xs = getattr(shapes, f)
        spec = _SHAPE_TENSORS[f]
        if len(xs) != len(spec):
            raise ValueError(f"shapes.{f}: expected {len(spec)} tensors")
        m = xs[0].shape[0] if xs[0].dim() else -1
        if m == 0:
            raise ValueError(f"shapes.{f} holds no shape: a kind the scene "
                             "lacks is None")
        for (name, tail), x in zip(spec, xs):
            kernels.check(name, x, torch.float32, (m, *tail), dev)
        counts[_COUNTS[f]] = m
    if n >= 2 ** 31 or any(m >= 2 ** 31 for m in counts.values()):
        raise ValueError("the kernel's int32 ray and shape indices hold "
                         "fewer than 2^31")
    kernels.no_grad_inputs("brute_hits", o=o, d=d, tmin=tmin, tmax=tmax,
                           **shape_tensors(shapes))
    return counts


def check_out(out, rows, n: int, kinds: int, any_hit: bool, dev):
    """Raise unless `out` can take the outputs: in any-hit mode a
    contiguous bool [N]; in closest mode (t, index, valid) slabs, float32,
    int32 and bool [R, N] contiguous, and rows one distinct slab row per
    kind present. Returns the rows (0..K-1 where out is None)."""
    if out is None:
        return list(range(kinds))
    if any_hit:
        if out.dtype != torch.bool or tuple(out.shape) != (n,) \
                or not out.is_contiguous() or out.device != dev:
            raise ValueError(f"out: expected a contiguous bool [{n}] tensor "
                             f"on {dev}")
        return [0]
    r = out[0].shape[0] if out[0].dim() == 2 else -1
    for name, x, dtype in zip(("t", "index", "valid"), out,
                              (torch.float32, torch.int32, torch.bool)):
        if x.dtype != dtype or tuple(x.shape) != (r, n) \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"out {name}: expected a contiguous {dtype} "
                             f"[R, {n}] slab on {dev}")
    rows = list(range(kinds)) if rows is None else [int(j) for j in rows]
    if len(rows) != kinds or len(set(rows)) != kinds \
            or any(not 0 <= j < r for j in rows):
        raise ValueError(f"rows {rows}: one distinct row of the {r}-row "
                         f"slabs for each of the {kinds} kinds")
    return rows


@kernels.wrapper("brute_hits_kernel")
def brute_hits(o, d, tmin, tmax, shapes: BruteShapes, any_hit: bool,
               out=None, rows=None):
    """`intersect.brute_hits_plain`: one launch of brute_hits_kernel on
    CUDA tensors (none for an empty batch), the plain version on CPU
    tensors. Closest mode: [KindHit per kind present], each kind's t,
    index and valid rows of one [K, N] output, or, with out = (t, index,
    valid) [R, N] slabs, rows `rows` of them (one per kind present, in
    order; default 0..K-1); any-hit mode: [N] bool, written into out where
    given. The plain version's outputs are copied into out."""
    counts = check_inputs(o, d, tmin, tmax, shapes)
    dev = o.device
    n = o.shape[0]
    k = 1 if any_hit else len(shapes.present)
    rows = check_out(out, rows, n, k, any_hit, dev)
    if not kernels.route("brute_hits", dev):
        got = brute_hits_plain(o, d, tmin, tmax, shapes, any_hit)
        if out is None or any_hit:
            return kernels.copy_out(got, out)
        return [kernels.copy_out(h, KindHit(*(slab[j] for slab in out)))
                for j, h in zip(rows, got)]
    if out is None:
        t = torch.empty((0 if any_hit else k, n), dtype=torch.float32,
                        device=dev)
        index = torch.empty((0 if any_hit else k, n), dtype=torch.int32,
                            device=dev)
        valid = torch.empty((k, n), dtype=torch.bool, device=dev)
    elif any_hit:
        t = index = None
        valid = out
    else:
        t, index, valid = out
    if n and shapes.present:
        a = _BruteArgs(n=n, **counts)
        ptrs = dict(o=o, d=d, tmin=tmin, tmax=tmax, t=t, index=index,
                    valid=valid, **shape_tensors(shapes))
        for name, x in ptrs.items():
            setattr(a, name, kernels.ptr(x))
        for j, r in enumerate(rows):
            a.row[j] = r
        kernels.launch(brute_hits, dev, _LIB.load().brute_hits,
                       ctypes.byref(a), int(any_hit))
    elif any_hit:
        valid.zero_()
    if any_hit:
        return valid if out is not None else valid[0]
    return [KindHit(t=t[j], index=index[j], valid=valid[j]) for j in rows]
