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
from . import kernels
from .kernels import check, ptr

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


_LIB = kernels.Library(
    "wave", ["wave.cu"],
    {name: [ctypes.POINTER(args), ctypes.c_void_p] for name, args in (
        ("camera_rays", _CameraArgs), ("permute_state", _PermuteArgs),
        ("unsort_guard", _UnsortArgs),
        ("permute_state_backward", _PermuteGradArgs),
        ("unsort_guard_backward", _UnsortGradArgs))},
    {"wave_camera_args_size": _CameraArgs,
     "wave_permute_args_size": _PermuteArgs,
     "wave_unsort_args_size": _UnsortArgs,
     "wave_permute_grad_args_size": _PermuteGradArgs,
     "wave_unsort_grad_args_size": _UnsortGradArgs})


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
    check("pixel", pixel, torch.int64, (n,), dev)
    check("jitter", jitter, torch.float32, (n, 2), dev)
    for name in ("position", "front", "right", "up"):
        check(f"cam.{name}", getattr(cam, name), torch.float32, (3,), dev)
    check("cam.resolution", cam.resolution, torch.float32, (2,), dev)
    check("ray_eps", ray_eps, torch.float32, (), dev)
    if width <= 0:
        raise ValueError(f"camera_rays: width {width} is not positive")
    kernels.check_lanes(n)
    return n


@kernels.wrapper("camera_rays_kernel")
def camera_rays(cam, pixel, width: int, jitter, ray_eps) -> WaveState:
    """`camera_rays_plain`: one launch of camera_rays_kernel on CUDA
    tensors (pixel [N] int64, jitter [N, 2] float32, the camera's rows and
    ray_eps on the card), the plain version on CPU tensors. The state's
    ray_o and ray_d are the camera's rays."""
    dev = pixel.device
    if not kernels.route("camera_rays", dev, jitter=jitter, ray_eps=ray_eps,
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
        n=n, width=int(width), pixel=ptr(pixel), jitter=ptr(jitter),
        position=ptr(cam.position), front=ptr(cam.front),
        right=ptr(cam.right), up=ptr(cam.up),
        resolution=ptr(cam.resolution), ray_eps=ptr(ray_eps),
        o=ptr(state.ray_o), d=ptr(state.ray_d), L=ptr(state.L),
        beta=ptr(state.beta), active=ptr(state.active),
        spec=ptr(state.prev_specular), pdf=ptr(state.prev_pdf),
        lane=ptr(state.lane), tmin=ptr(state.tmin),
        tmax=ptr(state.tmax), counts=ptr(state.counts))
    kernels.launch(camera_rays, dev, _LIB.load().camera_rays,
                   ctypes.byref(args))
    return state


def check_permute_inputs(state: WaveState, u, perm, dev) -> int:
    """Raise unless permute_state_kernel can take the inputs: every row of
    the state contiguous, of its dtype and [N] or [N, 3] shape, u LaneKeys
    of contiguous int32 k0, k1 and int64 sample [N] or a contiguous float32
    [N, ...] tensor, perm int64 [N], all on dev. Returns N."""
    n = state.L.shape[0] if state.L.dim() == 2 else -1
    for name, dtype, w in _ROWS:
        check(name, getattr(state, name), dtype,
              (n, 3) if w == 3 else (n,), dev)
    if isinstance(u, rng.LaneKeys):
        check("u.k0", u.k0, torch.int32, (n,), dev)
        check("u.k1", u.k1, torch.int32, (n,), dev)
        check("u.sample", u.sample, torch.int64, (n,), dev)
    else:
        check("u", u, torch.float32, (n, *u.shape[1:]), dev)
    check("perm", perm, torch.int64, (n,), dev)
    kernels.check_lanes(n)
    return n


@kernels.wrapper("permute_state_kernel")
def permute_state(state: WaveState, u, perm):
    """`permute_state_plain`: one launch of permute_state_kernel on CUDA
    tensors for every row of the state and of u (LaneKeys or the debug
    sampler's uniforms), the plain version on CPU tensors. Returns the
    permuted (state, u) in fresh tensors; the counters stay."""
    dev = perm.device
    rows = {name: getattr(state, name) for name, *_ in _ROWS}
    if not kernels.route("permute_state", dev, **rows,
                         **({"u": u} if torch.is_tensor(u) else {})):
        return permute_state_plain(state, u, perm)
    n = check_permute_inputs(state, u, perm, dev)
    out = {k: torch.empty_like(x) for k, x in rows.items()}
    keys = isinstance(u, rng.LaneKeys)
    u_out = (rng.LaneKeys(*(torch.empty_like(x) for x in u)) if keys
             else torch.empty_like(u))

    def state_rows(r, uu):
        return _StateRows(
            L=ptr(r["L"]), beta=ptr(r["beta"]), o=ptr(r["ray_o"]),
            d=ptr(r["ray_d"]), active=ptr(r["active"]),
            spec=ptr(r["prev_specular"]), pdf=ptr(r["prev_pdf"]),
            lane=ptr(r["lane"]), tmin=ptr(r["tmin"]), tmax=ptr(r["tmax"]),
            k0=ptr(uu.k0) if keys else None,
            k1=ptr(uu.k1) if keys else None,
            sample=ptr(uu.sample) if keys else None,
            u=None if keys else ptr(uu))

    args = _PermuteArgs(n=n, u_width=0 if keys or not n
                        else u.numel() // n, perm=ptr(perm),
                        inp=state_rows(rows, u), out=state_rows(out, u_out))
    kernels.launch(permute_state, dev, _LIB.load().permute_state,
                   ctypes.byref(args))
    return state._replace(**out), u_out


def check_unsort_inputs(L, lane, dev) -> int:
    """Raise unless unsort_guard_kernel can take the inputs: L a contiguous
    float32 [N, 3], lane int64 [N] or None, on dev. Returns N."""
    n = L.shape[0] if L.dim() == 2 else -1
    check("L", L, torch.float32, (n, 3), dev)
    if lane is not None:
        check("lane", lane, torch.int64, (n,), dev)
    kernels.check_lanes(n)
    return n


@kernels.wrapper("unsort_guard_kernel")
def unsort_guard(L, lane=None, out=None):
    """`unsort_guard_plain`: one launch of unsort_guard_kernel on CUDA
    tensors (L [N, 3] float32; lane [N] int64, the pixel row of each row, a
    permutation, or None without a sort, when L is guarded in place unless
    `out` is given), the plain version on CPU tensors."""
    dev = L.device
    if not kernels.route("unsort_guard", dev, L=L):
        return unsort_guard_plain(L, lane)
    n = check_unsort_inputs(L, lane, dev)
    if out is None:
        out = L if lane is None else torch.empty_like(L)
    else:
        check("out", out, torch.float32, (n, 3), dev)
    args = _UnsortArgs(n=n, L=ptr(L), lane=ptr(lane), out=ptr(out))
    kernels.launch(unsort_guard, dev, _LIB.load().unsort_guard,
                   ctypes.byref(args))
    return out


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


@kernels.wrapper("permute_state_backward_kernel")
def permute_state_backward(perm, gL, gbeta):
    """`permute_state_backward_plain`: one launch of
    permute_state_backward_kernel on CUDA tensors (perm [N] int64 a
    permutation of the lanes, as argsort gives; gL, gbeta [N,3] float32 or
    None for 0), returning both gradients (zeros for a None one; None
    where both are None), the plain version on CPU tensors."""
    dev = perm.device
    if not kernels.route("permute_state_backward", dev, gL=gL, gbeta=gbeta):
        return permute_state_backward_plain(perm, gL, gbeta)
    n = perm.shape[0] if perm.dim() == 1 else -1
    check("perm", perm, torch.int64, (n,), dev)
    for name, g in (("gL", gL), ("gbeta", gbeta)):
        if g is not None:
            check(name, g, torch.float32, (n, 3), dev)
    kernels.check_lanes(n)
    if gL is None and gbeta is None:
        return None, None
    gl = torch.empty((n, 3), dtype=torch.float32, device=dev)
    gb = torch.empty_like(gl)
    args = _PermuteGradArgs(n=n, perm=ptr(perm), gL=ptr(gL),
                            gbeta=ptr(gbeta), gL_in=ptr(gl),
                            gbeta_in=ptr(gb))
    kernels.launch(permute_state_backward, dev,
                   _LIB.load().permute_state_backward, ctypes.byref(args))
    return gl, gb


def unsort_guard_backward_plain(L, lane, g):
    """d loss / d L before unsort_guard from g [N,3] after it: g[lane[i]]
    where L[i] is finite, else 0 (lane None: g where L is finite)."""
    if lane is not None:
        g = g[lane]
    return torch.where(torch.isfinite(L), g, torch.zeros_like(g))


@kernels.wrapper("unsort_guard_backward_kernel")
def unsort_guard_backward(L, lane, g):
    """`unsort_guard_backward_plain`: one launch of
    unsort_guard_backward_kernel on CUDA tensors (L [N,3] float32 the
    un-sort's input, lane [N] int64 or None, g [N,3] float32), the plain
    version on CPU tensors."""
    dev = L.device
    if not kernels.route("unsort_guard_backward", dev, L=L, g=g):
        return unsort_guard_backward_plain(L, lane, g)
    n = check_unsort_inputs(L, lane, dev)
    check("g", g, torch.float32, (n, 3), dev)
    out = torch.empty_like(L)
    args = _UnsortGradArgs(n=n, L=ptr(L), lane=ptr(lane), g=ptr(g),
                           gL=ptr(out))
    kernels.launch(unsort_guard_backward, dev,
                   _LIB.load().unsort_guard_backward, ctypes.byref(args))
    return out


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
        # autograd may hand a strided gradient (an expanded one, say)
        gl, gb = permute_state_backward(
            perm, *(None if g is None else g.contiguous()
                    for g in (gL, gbeta)))
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

