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

from .intersect import BruteShapes, KindHit, brute_hits_plain, \
    no_grad_inputs
from .launches import register

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
                + [(k, ctypes.c_void_p) for k in _PTRS])


def _library():
    from ..utils.cuda_build import load_library
    return load_library("brute", ["brute.cu"], _declare)


def _declare(lib):
    lib.brute_hits.argtypes = [ctypes.POINTER(_BruteArgs), ctypes.c_int,
                               ctypes.c_void_p]
    lib.brute_hits.restype = ctypes.c_int
    lib.brute_args_size.restype = ctypes.c_int
    if lib.brute_args_size() != ctypes.sizeof(_BruteArgs):
        raise RuntimeError("csrc/brute.cu and ops/brute.py disagree on the "
                           "kernel's argument layout")


def _check(name, x, shape, dev):
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{name}: expected a contiguous float32 "
                         f"{list(shape)} tensor on {dev}, got {x.dtype} "
                         f"{list(x.shape)} on {x.device}"
                         + ("" if x.is_contiguous() else ", not contiguous"))


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
        _check(name, x, shape, dev)
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
            _check(name, x, (m, *tail), dev)
        counts[_COUNTS[f]] = m
    if n >= 2 ** 31 or any(m >= 2 ** 31 for m in counts.values()):
        raise ValueError("the kernel's int32 ray and shape indices hold "
                         "fewer than 2^31")
    no_grad_inputs("brute_hits", o=o, d=d, tmin=tmin, tmax=tmax,
                   **shape_tensors(shapes))
    return counts


def brute_hits(o, d, tmin, tmax, shapes: BruteShapes, any_hit: bool):
    """`intersect.brute_hits_plain`: one launch of brute_hits_kernel on
    CUDA tensors (none for an empty batch), the plain version on CPU
    tensors. Closest mode: [KindHit per kind present], each kind's t,
    index and valid rows of one [K, N] output; any-hit mode: [N] bool."""
    counts = check_inputs(o, d, tmin, tmax, shapes)
    dev = o.device
    if dev.type == "cpu":
        return brute_hits_plain(o, d, tmin, tmax, shapes, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"no brute_hits route for device {dev}")
    n = o.shape[0]
    k = 1 if any_hit else len(shapes.present)
    t = torch.empty((0 if any_hit else k, n), dtype=torch.float32,
                    device=dev)
    index = torch.empty((0 if any_hit else k, n), dtype=torch.int32,
                        device=dev)
    valid = torch.empty((k, n), dtype=torch.bool, device=dev)
    if n and shapes.present:
        a = _BruteArgs(n=n, **counts)
        ptrs = dict(o=o, d=d, tmin=tmin, tmax=tmax, t=t, index=index,
                    valid=valid, **shape_tensors(shapes))
        for name, x in ptrs.items():
            setattr(a, name, x.data_ptr() if x.numel() else None)
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.brute_hits(ctypes.byref(a), int(any_hit),
                                 torch.cuda.current_stream(dev).cuda_stream)
        brute_hits.launches += 1
        if err != 0:
            raise RuntimeError(f"brute_hits launch failed: CUDA error {err}")
    elif any_hit:
        valid.zero_()
    if any_hit:
        return valid[0]
    return [KindHit(t=t[j], index=index[j], valid=valid[j])
            for j in range(k)]


brute_hits.launches = 0
register(__name__, "brute_hits", "brute_hits_kernel")
