"""The wave's glue around the casts, the vertices and the sorts, as
hand-written kernels on the card.

Counterpart of the per-lane work that XLA fuses around the casts, the
vertex and the sorts under jax.jit(wave) (jet_pbrt_tpu/models/render.py:
34-42, models/camera.py:56-70, models/integrators.py:259-292); the
reference has no Pallas kernel for it. Three functions:

    camera_rays     csrc/wave.cu camera_rays_kernel on CUDA tensors: the
                    film position of each pixel id with its jitter, the
                    camera ray through it and li_path's initial state
                    (`WaveState`, its counters zeroed); `camera_rays_plain`
                    on CPU tensors.
    permute_state   permute_state_kernel: every row of a WaveState and of
                    the lanes' streams (the LaneKeys words, or the debug
                    sampler's uniforms) gathered by one perm, in one
                    launch; `permute_state_plain`, a gather each.
    unsort_guard    unsort_guard_kernel: out[lane[i]] = L[i] where finite,
                    else 0 (lane None: the guard alone, in place);
                    `unsort_guard_plain` (argsort, then a gather, then the
                    guard).

Under autograd (li_path's kernel route with a pack that requires grad) the
state's L and beta carry a gradient through the permutes and the un-sort:
`permute` and `unsort` are torch.autograd.Functions around permute_state
and unsort_guard whose backwards are two more kernels of csrc/wave.cu,

    permute_state_backward   g_in[perm[j]] = g_out[j] for L and beta;
                             `permute_state_backward_plain` (index_copy_).
    unsort_guard_backward    gL[i] = isfinite(L[i]) ? g[lane[i]] : 0;
                             `unsort_guard_backward_plain` (a gather and
                             the guard's where).

On a CUDA tensor a wrapper launches its kernel or raises on what the kernel
cannot take (dtype, shape, device, contiguity, an input that requires
grad: a wrapper reads raw pointers, so a differentiable input goes through
the Functions); nothing falls back. The plain
versions are the torch code wave_fn and li_path ran before the kernels,
and the kernels match them bit for bit on the card (see the source's note
on how their arithmetic is pinned). Each kernel launches on the current
stream, allocates nothing itself and synchronises nothing, so a captured
wave (models/graph.py) holds it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import rng
from .intersect import no_grad_inputs
from .launches import register

# the wave's ray counters (li_path's with_stats), in csrc/wave.cu's order
COUNTS = ("rays_primary", "rays_bounce", "rays_shadow", "rays")


class WaveState(NamedTuple):
    """li_path's per-lane state between two closest-hit casts on the glue
    kernels' route: ops/shade.py::VertexState's rows, the lane's pixel row
    (its index before any sort), the next cast's bounds and the wave's
    int64 ray counters [4] (COUNTS)."""
    L: torch.Tensor              # [N,3]
    beta: torch.Tensor           # [N,3]
    active: torch.Tensor         # [N] bool
    prev_specular: torch.Tensor  # [N] bool
    prev_pdf: torch.Tensor       # [N]
    ray_o: torch.Tensor          # [N,3]
    ray_d: torch.Tensor          # [N,3]
    lane: torch.Tensor           # [N] int64
    tmin: torch.Tensor           # [N]
    tmax: torch.Tensor           # [N]
    counts: torch.Tensor         # [4] int64


# the state's rows a permute moves, and each row's dtype and width
_ROWS = (("L", torch.float32, 3), ("beta", torch.float32, 3),
         ("ray_o", torch.float32, 3), ("ray_d", torch.float32, 3),
         ("active", torch.bool, 1), ("prev_specular", torch.bool, 1),
         ("prev_pdf", torch.float32, 1), ("lane", torch.int64, 1),
         ("tmin", torch.float32, 1), ("tmax", torch.float32, 1))
# csrc/wave.cu StateRows' fields, in order
_STATE_FIELDS = ("L", "beta", "o", "d", "active", "spec", "pdf", "lane",
                 "tmin", "tmax", "k0", "k1", "sample", "u")


class _CameraArgs(ctypes.Structure):
    _fields_ = ([("n", ctypes.c_int), ("width", ctypes.c_longlong)]
                + [(k, ctypes.c_void_p) for k in (
                    "pixel", "jitter", "position", "front", "right", "up",
                    "resolution", "ray_eps", "o", "d", "L", "beta", "active",
                    "spec", "pdf", "lane", "tmin", "tmax", "counts")])


class _StateRows(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _STATE_FIELDS]


class _PermuteArgs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("u_width", ctypes.c_int),
                ("perm", ctypes.c_void_p), ("inp", _StateRows),
                ("out", _StateRows)]


class _UnsortArgs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("L", ctypes.c_void_p),
                ("lane", ctypes.c_void_p), ("out", ctypes.c_void_p)]


class _PermuteGradArgs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int)] + [(k, ctypes.c_void_p) for k in (
        "perm", "gL", "gbeta", "gL_in", "gbeta_in")]


class _UnsortGradArgs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int)] + [(k, ctypes.c_void_p) for k in (
        "L", "lane", "g", "gL")]


_ARGS = {"wave_camera_args_size": _CameraArgs,
         "wave_permute_args_size": _PermuteArgs,
         "wave_unsort_args_size": _UnsortArgs,
         "wave_permute_grad_args_size": _PermuteGradArgs,
         "wave_unsort_grad_args_size": _UnsortGradArgs}


def _library():
    from ..utils.cuda_build import load_library
    return load_library("wave", ["wave.cu"], _declare)


def _declare(lib):
    for name, args in (("camera_rays", _CameraArgs),
                       ("permute_state", _PermuteArgs),
                       ("unsort_guard", _UnsortArgs),
                       ("permute_state_backward", _PermuteGradArgs),
                       ("unsort_guard_backward", _UnsortGradArgs)):
        getattr(lib, name).argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    for name, args in _ARGS.items():
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != ctypes.sizeof(args):
            raise RuntimeError("csrc/wave.cu and ops/wave.py disagree on "
                               f"the layout of {args.__name__}")


def _check(name, x, dtype, shape, dev):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{name}: expected a contiguous {dtype} "
                         f"{list(shape)} tensor on {dev}, got {x.dtype} "
                         f"{list(x.shape)} on {x.device}"
                         + ("" if x.is_contiguous() else ", not contiguous"))


def _route(name: str, dev, **inputs) -> bool:
    """True where `name` launches its kernel (a CUDA device), False on the
    CPU (the plain version); raises on another device and, on the card,
    where an input requires grad."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {name} route for device {dev}")
    no_grad_inputs(name, **{k: x for k, x in inputs.items()
                            if x is not None})
    return True


def _ptr(x):
    return None if x is None or not x.numel() else x.data_ptr()


def _launch(name: str, fn, args) -> None:
    dev = torch.cuda.current_device()
    err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_lanes(n: int) -> None:
    if n >= 2 ** 31:
        raise ValueError("the kernels' int32 lane index holds fewer than "
                         "2^31 lanes")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def initial_state_plain(o, d, ray_eps) -> WaveState:
    """li_path's state before its first cast, as its torch code made it:
    L = 0, beta = 1, every lane active, no specular bounce, pdf 0, the lane
    index, the first cast's bounds where(active, eps, inf) and
    where(active, inf, -1), and zeroed counters."""
    n = o.shape[0]
    dev = o.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_specular = torch.zeros((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    lane = torch.arange(n, device=dev)
    inf = torch.full((n,), math.inf, device=dev)
    neg = torch.full((n,), -1.0, device=dev)
    eps = ray_eps.expand(n)
    return WaveState(L, beta, active, prev_specular, prev_pdf, o, d, lane,
                     torch.where(active, eps, inf),
                     torch.where(active, inf, neg),
                     torch.zeros((len(COUNTS),), dtype=torch.int64,
                                 device=dev))


def camera_rays_plain(cam, pixel, width: int, jitter, ray_eps) -> WaveState:
    """wave_fn's camera in torch ops: the film position (pixel % width +
    jitter x, pixel // width + jitter y) of pixel ids [N] int64 with the
    jitter [N, 2], models/camera.py::generate_rays through it, and
    li_path's initial state (initial_state_plain)."""
    from ..models import camera as camera_mod

    # pixel + in-pixel jitter (reference: src/sampler.h:148-155)
    x = (pixel % width).to(torch.float32) + jitter[:, 0]
    y = (pixel // width).to(torch.float32) + jitter[:, 1]
    o, d = camera_mod.generate_rays(cam, torch.stack([x, y], dim=-1))
    return initial_state_plain(o, d, ray_eps)


def permute_state_plain(state: WaveState, u, perm):
    """(state, u) with every lane's rows moved to where perm puts them: row
    j of each [N, ...] row takes lane perm[j], the counters stay. u is
    rng.LaneKeys (both key words and the sample index move) or the debug
    sampler's uniforms [N, ...]."""
    moved = {name: getattr(state, name)[perm] for name, *_ in _ROWS}
    if isinstance(u, rng.LaneKeys):
        u = rng.LaneKeys(*(x[perm] for x in u))
    else:
        u = u[perm]
    return state._replace(**moved), u


def unsort_guard_plain(L, lane):
    """L [N,3] with row i moved back to row lane[i] (lane None: no sort),
    by argsort then a gather, and every non-finite value set to 0 (the
    invalid-sample guard, reference: src/integrator.cc:104)."""
    if lane is not None:
        L = L[torch.argsort(lane)]
    return torch.where(torch.isfinite(L), L, torch.zeros_like(L))


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def check_camera_inputs(cam, pixel, width: int, jitter, ray_eps, dev) -> int:
    """Raise unless camera_rays_kernel can take the inputs: pixel a
    contiguous int64 [N], jitter a contiguous float32 [N, 2], the camera's
    rows float32 [3] (and resolution [2]) and ray_eps a float32 scalar, all
    on dev, width positive. Returns N."""
    n = pixel.shape[0] if pixel.dim() == 1 else -1
    _check("pixel", pixel, torch.int64, (n,), dev)
    _check("jitter", jitter, torch.float32, (n, 2), dev)
    for name in ("position", "front", "right", "up"):
        _check(f"cam.{name}", getattr(cam, name), torch.float32, (3,), dev)
    _check("cam.resolution", cam.resolution, torch.float32, (2,), dev)
    _check("ray_eps", ray_eps, torch.float32, (), dev)
    if width <= 0:
        raise ValueError(f"camera_rays: width {width} is not positive")
    _check_lanes(n)
    return n


def camera_rays(cam, pixel, width: int, jitter, ray_eps) -> WaveState:
    """`camera_rays_plain`: one launch of camera_rays_kernel on CUDA
    tensors (pixel [N] int64, jitter [N, 2] float32, the camera's rows and
    ray_eps on the card), the plain version on CPU tensors. The state's
    ray_o and ray_d are the camera's rays."""
    dev = pixel.device
    if not _route("camera_rays", dev, jitter=jitter, ray_eps=ray_eps,
                  **{k: getattr(cam, k) for k in cam._fields}):
        return camera_rays_plain(cam, pixel, width, jitter, ray_eps)
    n = check_camera_inputs(cam, pixel, width, jitter, ray_eps, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    state = WaveState(
        L=torch.empty((n, 3), **f32), beta=torch.empty((n, 3), **f32),
        active=torch.empty((n,), **b8), prev_specular=torch.empty((n,), **b8),
        prev_pdf=torch.empty((n,), **f32), ray_o=torch.empty((n, 3), **f32),
        ray_d=torch.empty((n, 3), **f32),
        lane=torch.empty((n,), dtype=torch.int64, device=dev),
        tmin=torch.empty((n,), **f32), tmax=torch.empty((n,), **f32),
        counts=torch.empty((len(COUNTS),), dtype=torch.int64, device=dev))
    args = _CameraArgs(
        n=n, width=int(width), pixel=_ptr(pixel), jitter=_ptr(jitter),
        position=_ptr(cam.position), front=_ptr(cam.front),
        right=_ptr(cam.right), up=_ptr(cam.up),
        resolution=_ptr(cam.resolution), ray_eps=_ptr(ray_eps),
        o=_ptr(state.ray_o), d=_ptr(state.ray_d), L=_ptr(state.L),
        beta=_ptr(state.beta), active=_ptr(state.active),
        spec=_ptr(state.prev_specular), pdf=_ptr(state.prev_pdf),
        lane=_ptr(state.lane), tmin=_ptr(state.tmin),
        tmax=_ptr(state.tmax), counts=_ptr(state.counts))
    lib = _library()
    with torch.cuda.device(dev):
        _launch("camera_rays", lib.camera_rays, args)
    camera_rays.launches += 1
    return state


camera_rays.launches = 0
register(__name__, "camera_rays", "camera_rays_kernel")


def check_permute_inputs(state: WaveState, u, perm, dev) -> int:
    """Raise unless permute_state_kernel can take the inputs: every row of
    the state contiguous, of its dtype and [N] or [N, 3] shape, u LaneKeys
    of contiguous int32 k0, k1 and int64 sample [N] or a contiguous float32
    [N, ...] tensor, perm int64 [N], all on dev. Returns N."""
    n = state.L.shape[0] if state.L.dim() == 2 else -1
    for name, dtype, w in _ROWS:
        _check(name, getattr(state, name), dtype,
               (n, 3) if w == 3 else (n,), dev)
    if isinstance(u, rng.LaneKeys):
        _check("u.k0", u.k0, torch.int32, (n,), dev)
        _check("u.k1", u.k1, torch.int32, (n,), dev)
        _check("u.sample", u.sample, torch.int64, (n,), dev)
    else:
        _check("u", u, torch.float32, (n, *u.shape[1:]), dev)
    _check("perm", perm, torch.int64, (n,), dev)
    _check_lanes(n)
    return n


def permute_state(state: WaveState, u, perm):
    """`permute_state_plain`: one launch of permute_state_kernel on CUDA
    tensors for every row of the state and of u (LaneKeys or the debug
    sampler's uniforms), the plain version on CPU tensors. Returns the
    permuted (state, u) in fresh tensors; the counters stay."""
    dev = perm.device
    rows = {name: getattr(state, name) for name, *_ in _ROWS}
    if not _route("permute_state", dev, **rows,
                  **({"u": u} if torch.is_tensor(u) else {})):
        return permute_state_plain(state, u, perm)
    n = check_permute_inputs(state, u, perm, dev)
    out = {k: torch.empty_like(x) for k, x in rows.items()}
    keys = isinstance(u, rng.LaneKeys)
    u_out = (rng.LaneKeys(*(torch.empty_like(x) for x in u)) if keys
             else torch.empty_like(u))

    def state_rows(r, uu):
        return _StateRows(
            L=_ptr(r["L"]), beta=_ptr(r["beta"]), o=_ptr(r["ray_o"]),
            d=_ptr(r["ray_d"]), active=_ptr(r["active"]),
            spec=_ptr(r["prev_specular"]), pdf=_ptr(r["prev_pdf"]),
            lane=_ptr(r["lane"]), tmin=_ptr(r["tmin"]), tmax=_ptr(r["tmax"]),
            k0=_ptr(uu.k0) if keys else None,
            k1=_ptr(uu.k1) if keys else None,
            sample=_ptr(uu.sample) if keys else None,
            u=None if keys else _ptr(uu))

    args = _PermuteArgs(n=n, u_width=0 if keys or not n
                        else u.numel() // n, perm=_ptr(perm),
                        inp=state_rows(rows, u), out=state_rows(out, u_out))
    lib = _library()
    with torch.cuda.device(dev):
        _launch("permute_state", lib.permute_state, args)
    permute_state.launches += 1
    return state._replace(**out), u_out


permute_state.launches = 0
register(__name__, "permute_state", "permute_state_kernel")


def check_unsort_inputs(L, lane, dev) -> int:
    """Raise unless unsort_guard_kernel can take the inputs: L a contiguous
    float32 [N, 3], lane int64 [N] or None, on dev. Returns N."""
    n = L.shape[0] if L.dim() == 2 else -1
    _check("L", L, torch.float32, (n, 3), dev)
    if lane is not None:
        _check("lane", lane, torch.int64, (n,), dev)
    _check_lanes(n)
    return n


def unsort_guard(L, lane=None, out=None):
    """`unsort_guard_plain`: one launch of unsort_guard_kernel on CUDA
    tensors (L [N, 3] float32; lane [N] int64, the pixel row of each row, a
    permutation, or None without a sort, when L is guarded in place unless
    `out` is given), the plain version on CPU tensors."""
    dev = L.device
    if not _route("unsort_guard", dev, L=L):
        return unsort_guard_plain(L, lane)
    n = check_unsort_inputs(L, lane, dev)
    if out is None:
        out = L if lane is None else torch.empty_like(L)
    else:
        _check("out", out, torch.float32, (n, 3), dev)
    args = _UnsortArgs(n=n, L=_ptr(L), lane=_ptr(lane), out=_ptr(out))
    lib = _library()
    with torch.cuda.device(dev):
        _launch("unsort_guard", lib.unsort_guard, args)
    unsort_guard.launches += 1
    return out


unsort_guard.launches = 0
register(__name__, "unsort_guard", "unsort_guard_kernel")


# --------------------------------------------------------------------------
# the backward
# --------------------------------------------------------------------------

def permute_state_backward_plain(perm, gL, gbeta):
    """(d loss / d L, d loss / d beta) before permute_state from those
    after it, gL and gbeta [N,3] (None: 0): the transpose of x[perm], row
    perm[j] taking row j (perm a permutation)."""
    def back(g):
        if g is None:
            return None
        return torch.zeros_like(g).index_copy_(0, perm, g)
    return back(gL), back(gbeta)


def permute_state_backward(perm, gL, gbeta):
    """`permute_state_backward_plain`: one launch of
    permute_state_backward_kernel on CUDA tensors (perm [N] int64 a
    permutation of the lanes, as argsort gives; gL, gbeta [N,3] float32 or
    None for 0), returning both gradients (zeros for a None one; None
    where both are None), the plain version on CPU tensors."""
    dev = perm.device
    if not _route("permute_state_backward", dev, gL=gL, gbeta=gbeta):
        return permute_state_backward_plain(perm, gL, gbeta)
    n = perm.shape[0] if perm.dim() == 1 else -1
    _check("perm", perm, torch.int64, (n,), dev)
    for name, g in (("gL", gL), ("gbeta", gbeta)):
        if g is not None:
            _check(name, g, torch.float32, (n, 3), dev)
    _check_lanes(n)
    if gL is None and gbeta is None:
        return None, None
    gl = torch.empty((n, 3), dtype=torch.float32, device=dev)
    gb = torch.empty_like(gl)
    args = _PermuteGradArgs(n=n, perm=_ptr(perm), gL=_ptr(gL),
                            gbeta=_ptr(gbeta), gL_in=_ptr(gl),
                            gbeta_in=_ptr(gb))
    lib = _library()
    with torch.cuda.device(dev):
        _launch("permute_state_backward", lib.permute_state_backward, args)
    permute_state_backward.launches += 1
    return gl, gb


permute_state_backward.launches = 0
register(__name__, "permute_state_backward", "permute_state_backward_kernel")


def unsort_guard_backward_plain(L, lane, g):
    """d loss / d L before unsort_guard from g [N,3] after it: g[lane[i]]
    where L[i] is finite, else 0 (lane None: g where L is finite)."""
    if lane is not None:
        g = g[lane]
    return torch.where(torch.isfinite(L), g, torch.zeros_like(g))


def unsort_guard_backward(L, lane, g):
    """`unsort_guard_backward_plain`: one launch of
    unsort_guard_backward_kernel on CUDA tensors (L [N,3] float32 the
    un-sort's input, lane [N] int64 or None, g [N,3] float32), the plain
    version on CPU tensors."""
    dev = L.device
    if not _route("unsort_guard_backward", dev, L=L, g=g):
        return unsort_guard_backward_plain(L, lane, g)
    n = check_unsort_inputs(L, lane, dev)
    _check("g", g, torch.float32, (n, 3), dev)
    out = torch.empty_like(L)
    args = _UnsortGradArgs(n=n, L=_ptr(L), lane=_ptr(lane), g=_ptr(g),
                           gL=_ptr(out))
    lib = _library()
    with torch.cuda.device(dev):
        _launch("unsort_guard_backward", lib.unsort_guard_backward, args)
    unsort_guard_backward.launches += 1
    return out


unsort_guard_backward.launches = 0
register(__name__, "unsort_guard_backward", "unsort_guard_backward_kernel")


class _Permute(torch.autograd.Function):
    """permute_state with the state's L and beta tracked: (perm, state, u,
    holder, L, beta) -> the permuted (L, beta); the permuted (state, u)
    goes to holder["out"]. Backward: permute_state_backward."""

    @staticmethod
    def forward(ctx, perm, state, u, holder, L, beta):
        moved, u_out = permute_state(
            state._replace(L=L.detach(), beta=beta.detach()), u, perm)
        holder["out"] = (moved, u_out)
        ctx.save_for_backward(perm)
        ctx.set_materialize_grads(False)
        return moved.L, moved.beta

    @staticmethod
    def backward(ctx, gL, gbeta):
        (perm,) = ctx.saved_tensors
        gl, gb = permute_state_backward(perm, gL, gbeta)
        return None, None, None, None, gl, gb


def permute(state: WaveState, u, perm):
    """permute_state(state, u, perm), differentiable in state.L and
    state.beta (the _Permute Function; its forward is permute_state's
    launch, its backward permute_state_backward's)."""
    holder = {}
    L, beta = _Permute.apply(perm, state, u, holder, state.L, state.beta)
    moved, u_out = holder["out"]
    return moved._replace(L=L, beta=beta), u_out


class _Unsort(torch.autograd.Function):
    """unsort_guard into a fresh tensor with L tracked: (lane, L) -> the
    un-sorted, guarded L. Backward: unsort_guard_backward."""

    @staticmethod
    def forward(ctx, lane, L):
        L = L.detach()
        out = unsort_guard(L, lane, out=torch.empty_like(L)) \
            if L.device.type == "cuda" else unsort_guard(L, lane)
        ctx.save_for_backward(L, lane)
        return out

    @staticmethod
    def backward(ctx, g):
        L, lane = ctx.saved_tensors
        return None, unsort_guard_backward(L, lane, g.contiguous())


def unsort(L, lane=None):
    """unsort_guard(L, lane), differentiable in L where it requires grad
    (the _Unsort Function, into a fresh tensor; its backward is
    unsort_guard_backward); off the tape unsort_guard itself, which
    guards in place where there was no sort."""
    if torch.is_grad_enabled() and L.requires_grad:
        return _Unsort.apply(lane, L)
    return unsort_guard(L, lane)

