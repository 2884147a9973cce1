"""One path vertex of `li_path`: shading, NEE set-up, BSDF sampling and
Russian roulette, as one fused kernel on the card.

Counterpart of the vertex block of jet_pbrt_tpu/models/integrators.py:108-237
(reference: src/integrator.cc:328-393) under jax.jit(wave): XLA fuses it
into a few programs; the reference has no Pallas kernel for it. A vertex
is everything li_path does between one closest-hit cast and the next but
the shadow casts and the ray sort: the emission add, and below max_depth
the material with its texture tap, the lobe, the shading frame, every
non-black light's sample, f, `useful` mask, contribution and shadow
endpoint, the BSDF sample, the roulette and the next bounce's state.

Two functions and their plain versions:

    shade_vertex     csrc/shade.cu shade_vertex_kernel on CUDA tensors, one
                     thread per lane computing only the lane's own lobe and
                     light branches; `shade_vertex_plain` on CPU tensors.
    nee_accumulate   L + where(useful & ~occluded, contrib, 0), light after
                     light in light order: nee_accumulate_kernel on CUDA
                     tensors, `nee_accumulate_plain` on CPU tensors.

On a CUDA tensor a wrapper launches its kernel or raises; nothing falls
back. The plain versions are the torch code li_path ran before the
kernel, and the kernel matches them bit for bit on the card (see the
source's note on how its arithmetic is pinned).

`vertex` is li_path's whole vertex on the kernel route: shade_vertex, the
bounce's shadow casts (a callable of li_path's) and nee_accumulate as one
torch.autograd.Function, whose backward is csrc/shade_grad.cu's
vertex_backward_kernel, one launch per tangent set the scene's materials
need (`backward_sets`; one on the last bounce), and one grad_reduce_kernel
launch (the wrappers `vertex_backward` and `grad_reduce`) on the card, and
autograd through the plain vertex on the CPU (`vertex_backward_plain`).
The backward reads only what the forward saved, the vertex's inputs and
the bounce's shadow flags, and recomputes the rest; it covers the pack's
GRAD_FIELDS and the light table's summed environment radiance.

`kernel_route` is li_path's one routing decision: the wrappers (so the
kernels on the card) where li_path runs with nee=True and mis=False, the
primary rays do not require grad and no pack field outside GRAD_FIELDS
does. The plain version everywhere else, declared scope and not a
fallback: mis=True (its MIS emission weight re-intersects the light, and
its NEE weight needs the BSDF pdf), nee=False, and a gradient in the
scene's geometry (the reference differentiates none); li_whitted and
li_debug_normal keep their own torch code. These are the next fusions.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import bsdf as bsdf_ops
from . import lights as light_ops
from . import microfacet as mf
from . import rng
from .intersect import no_grad_inputs
from .launches import register
from .linalg import PI, absdot, frame_from_z, is_black, length, cross, \
    max_component, to_local, to_world
from .sampling import power_heuristic
from ..utils.log import span

# the light table's row widths (csrc/shade.cuh TABLE_W, STATIC_W, EM_W)
TABLE_W = 32
STATIC_W = 5
EM_W = 12

# the pack's fields the vertex's backward covers: diff/params.py's
# DIFFERENTIABLE_FIELDS and the texture colours; the kernel's parameter
# gradients are one vector of these fields' rows in _SLOT_FIELDS' order,
# then the environment's summed radiance (3)
GRAD_FIELDS = ("mat_c0", "mat_c1", "mat_s0", "mat_s1", "light_c",
               "tex_image", "tex_c0", "tex_c1")
_SLOT_FIELDS = ("mat_c0", "mat_c1", "mat_s0", "mat_s1", "tex_c0", "tex_c1",
                "light_c")


class VertexState(NamedTuple):
    """A path's per-lane state between two vertices."""
    L: torch.Tensor              # [N,3]
    beta: torch.Tensor           # [N,3]
    active: torch.Tensor         # [N] bool
    prev_specular: torch.Tensor  # [N] bool
    prev_pdf: torch.Tensor       # [N] pdf of the last BSDF sample
    ray_o: torch.Tensor          # [N,3]
    ray_d: torch.Tensor          # [N,3]


class Vertex(NamedTuple):
    """One vertex's outputs: the state after it (on the last bounce only L
    changes); per non-black light j in light order, the shadow ray's inputs
    and what it adds where unoccluded; below max_depth the next cast's
    bounds; and, where the wave counts its rays, its counters after this
    vertex."""
    state: VertexState
    useful: torch.Tensor     # [J, N] bool
    contrib: torch.Tensor    # [J, N, 3]
    shadow_to: torch.Tensor  # [J, N, 3] the light sample's point
    tmin: torch.Tensor | None = None   # [N] where(active, eps, inf)
    tmax: torch.Tensor | None = None   # [N] where(active, inf, -1)
    counts: torch.Tensor | None = None  # [4] int64 (ops/wave.py COUNTS)


class LightTable(NamedTuple):
    """The pack's lights for the kernel, on the pack's device. Per
    non-black light j in light order: `rows[j]` [TABLE_W] float32 (radiance
    at 0:3; then by kind the position or direction, the shape's rows and
    per-light constants, computed by the plain version's own torch
    expressions; 2 x the world radius last) and `statics[j]` [STATIC_W]
    int32 (kind, shape kind, uniform slot 1 + 2 * light index, t_count,
    first row in `em`); `em` [T, EM_W] the emissive instances' raw mesh
    triangles (p0, e1, e2) and normals, each family once; `le_env` [3]
    the environment lights' radiance summed in light order."""
    rows: torch.Tensor
    statics: torch.Tensor
    em: torch.Tensor
    le_env: torch.Tensor


def _pack_tensors(pack):
    """(field, tensor) of every tensor of the pack, a tuple field's each."""
    for name, x in zip(pack._fields, pack):
        if torch.is_tensor(x):
            yield name, x
        elif isinstance(x, tuple):
            yield from ((name, t) for t in x if torch.is_tensor(t))


def kernel_route(meta, pack, *tensors, nee: bool, mis: bool) -> bool:
    """Whether li_path's vertex takes `vertex` (the wrappers; on the card
    their kernels and, under autograd, the backward's) rather than the
    plain versions: with NEE, without MIS, where none of `tensors` (the
    primary rays) requires grad and no pack field outside GRAD_FIELDS
    does. Any number of lights."""
    return (nee and not mis
            and not any(x.requires_grad for x in tensors)
            and not any(x.requires_grad for name, x in _pack_tensors(pack)
                        if name not in GRAD_FIELDS))


# (statics rows, device) -> the int32 tensor; kept for the process, since
# a captured wave reads it by address
_STATICS: dict = {}


def _statics(rows: tuple, dev) -> torch.Tensor:
    """The light table's static part as an int32 [J, STATIC_W] tensor on
    dev, made by a host copy at its first use and kept: a CUDA graph
    cannot capture that copy, and every capture follows an eager warm-up
    call (models/graph.py), which makes it."""
    key = (rows, str(dev))
    if key not in _STATICS:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("light_table: the lights' static table is "
                               "made by an eager call before a capture")
        _STATICS[key] = torch.tensor(rows, dtype=torch.int32,
                                     device=dev).reshape(-1, STATIC_W)
    return _STATICS[key]


def light_table(meta, pack) -> LightTable:
    """The kernel's table of the pack's lights (LightTable). Its numbers
    are made by torch ops on the pack's device, with no host copy, inside
    a captured wave too; its static part comes from meta and the pack's
    shapes (_statics). The rows are made off the autograd tape (the
    kernels read them alone, and the backward adds each light's radiance
    gradient to its row of light_c itself); le_env, the environment
    lights' sum, stays on it."""
    f32 = dict(dtype=torch.float32, device=pack.light_c.device)
    with torch.no_grad():
        rows, statics, em = _light_rows(meta, pack)
    le_env = torch.zeros((3,), **f32)
    for i in meta.env_light_indices:
        le_env = le_env + pack.light_c[i]
    return LightTable(
        rows=torch.stack(rows) if rows else torch.zeros((0, TABLE_W), **f32),
        statics=_statics(tuple(v for row in statics for v in row),
                         pack.light_c.device),
        em=torch.cat(em) if em else torch.zeros((0, EM_W), **f32),
        le_env=le_env)


def _light_rows(meta, pack):
    """light_table's float rows, static rows and emissive-triangle blocks,
    as lists."""
    from ..scene.pack import LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_AREA, \
        KIND_TRI, KIND_RECT, KIND_DISK, KIND_SPHERE, KIND_INST

    dev = pack.light_c.device
    zero = torch.zeros((3,), dtype=torch.float32, device=dev)
    one = torch.ones((1,), dtype=torch.float32, device=dev)
    two_wr = (2.0 * pack.world_radius).reshape(1)
    rows, statics, em_rows, em_first = [], [], [], {}
    n_em = 0
    for li, lm in enumerate(meta.lights):
        if lm.static_black:
            continue
        a = b = c = nrm = zero
        s15 = s16 = one
        t_count = first = 0
        if lm.kind == LIGHT_POINT:
            a = pack.light_pos[li]
        elif lm.kind == LIGHT_DIRECTIONAL:
            a = pack.light_dir[li]
        elif lm.kind == LIGHT_AREA:
            sk, si = lm.shape_kind, lm.shape_idx
            if sk == KIND_TRI:
                a, b, c = pack.tri_p0[si], pack.tri_p1[si], pack.tri_p2[si]
                nrm = pack.tri_n[si]
                s15 = one / (0.5 * length(cross(b - a, c - a)))
            elif sk == KIND_RECT:
                q = pack.rect_q[si]
                a, b, c = q[1], q[0] - q[1], q[2] - q[1]
                nrm = pack.rect_n[si]
                s15 = one / length(cross(q[0] - q[1], q[2] - q[1]))
            elif sk == KIND_DISK:
                nd, r = pack.disk_n[si], pack.disk_r[si]
                s, t, _ = frame_from_z(nd[None, :])
                a, b, c, nrm = pack.disk_c[si], s[0], t[0], nd
                s15, s16 = one / (PI * r * r), r.reshape(1)
            elif sk == KIND_SPHERE:
                r = pack.sph_r[si]
                a = pack.sph_c[si]
                s15, s16 = one / (4.0 * PI * r * r), r.reshape(1)
            elif sk >= KIND_INST:
                mi = sk - KIND_INST
                t_count = pack.inst_em_tris[mi].shape[0]
                if mi not in em_first:
                    em_first[mi] = n_em
                    n_em += t_count
                    em_rows.append(torch.cat([pack.inst_em_tris[mi],
                                              pack.inst_em_n[mi]], dim=1))
                first = em_first[mi]
                a = pack.inst_off[mi][si]
                s16 = pack.inst_scale[mi][si].reshape(1)
            else:
                raise ValueError(f"bad area-light shape kind {sk}")
        rows.append(torch.cat([pack.light_c[li], a, b, c, nrm, s15.reshape(1),
                               s16, torch.zeros((TABLE_W - 18,),
                                                dtype=torch.float32,
                                                device=dev), two_wr]))
        statics.append((lm.kind, lm.shape_kind, 1 + 2 * li, t_count, first))
    return rows, statics, em_rows


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _stacks(usefuls, contribs, targets, n, dev):
    """The per-light lists as [J, N] / [J, N, 3] tensors (J may be 0)."""
    if usefuls:
        return torch.stack(usefuls), torch.stack(contribs), \
            torch.stack(targets)
    return (torch.zeros((0, n), dtype=torch.bool, device=dev),
            torch.zeros((0, n, 3), dtype=torch.float32, device=dev),
            torch.zeros((0, n, 3), dtype=torch.float32, device=dev))


def _bounds(pack, active):
    """The next cast's (tmin, tmax): dead lanes trace nothing, tmin = +inf
    and tmax = -1 miss at once."""
    n = active.shape[0]
    inf = torch.full((n,), math.inf, device=active.device)
    neg = torch.full((n,), -1.0, device=active.device)
    return (torch.where(active, pack.ray_eps.expand(n), inf),
            torch.where(active, inf, neg))


def _counted(counts, bounce: int, live, useful):
    """counts [4] plus this vertex's live lanes (primary at bounce 0, else
    bounce), its useful shadow rays, and both in the total."""
    cast = live.sum()
    shadow = useful.sum()
    zero = torch.zeros_like(cast)
    return counts + torch.stack([cast if bounce == 0 else zero,
                                 zero if bounce == 0 else cast, shadow,
                                 cast + shadow])


def shade_vertex_plain(meta, pack, hit, state: VertexState, u_vertex,
                       bounce: int, max_depth: int, *, le_env=None,
                       nee: bool = True, mis: bool = False,
                       counts=None) -> Vertex:
    """One vertex in torch ops (li_path's code before the kernel): hit is
    the closest hit of the state's rays, u_vertex [N, 4 + 2 * lights] the
    vertex's uniforms (unused on the last bounce), le_env the escaped
    rays' radiance (default light_ops.env_radiance). Below max_depth it
    also returns the next cast's bounds; with counts (the wave's [4] ray
    counters) the counters after this vertex."""
    from ..scene import pack as scene_pack

    L, beta, active, prev_specular, prev_pdf, ray_o, ray_d = state
    n = L.shape[0]
    dev = L.device
    nl = meta.n_lights
    if le_env is None:
        le_env = light_ops.env_radiance(meta, pack, n)

    # emission (reference: src/integrator.cc:328-337)
    gate = (active if bounce == 0 else active & prev_specular) if nee \
        else active
    le = torch.where(hit.valid[:, None], scene_pack.emitted(pack, hit),
                     le_env)
    L = L + torch.where(gate[:, None], beta * le, torch.zeros_like(le))

    if mis and bounce > 0:
        # the BSDF-sampled emitter hits that NEE alone drops
        w_area = torch.zeros((n,), dtype=torch.float32, device=dev)
        for li_idx in range(nl):
            kind = meta.lights[li_idx].kind
            if kind not in (scene_pack.LIGHT_AREA, scene_pack.LIGHT_ENV):
                continue
            pl = light_ops.pdf_li(meta, pack, li_idx, ray_o, ray_d)
            w = power_heuristic(1.0, prev_pdf, 1.0, pl)
            this = (hit.valid & (hit.light_id == li_idx)
                    if kind == scene_pack.LIGHT_AREA else ~hit.valid)
            w_area = torch.where(this, w, w_area)
        L = L + torch.where((active & ~prev_specular)[:, None],
                            beta * le * w_area.detach()[:, None],
                            torch.zeros_like(le))

    usefuls, contribs, targets = [], [], []
    if bounce >= max_depth:
        stacks = _stacks(usefuls, contribs, targets, n, dev)
        return Vertex(state._replace(L=L), *stacks, counts=None
                      if counts is None else _counted(counts, bounce, active,
                                                      stacks[0]))
    cont = active & hit.valid

    mat_kind, c0, c1, s0, s1, remap, tex_id, mf_kind = \
        scene_pack.gather_material(pack, hit.mat_id)
    c0 = scene_pack.effective_kd(meta, pack, hit, c0, tex_id)
    lobe = bsdf_ops.make_lobe(mat_kind, c0, c1, s0, s1, remap,
                              rng.stream_lobe(u_vertex), mf_kind=mf_kind)
    delta = bsdf_ops.is_delta(lobe)
    frame = frame_from_z(hit.normal)
    wo_local = to_local(frame, hit.wo)

    # NEE over all lights (reference: src/integrator.cc:357-372)
    for li_idx in range(nl if nee else 0):
        if meta.lights[li_idx].static_black:
            continue
        ls = light_ops.sample_li(meta, pack, li_idx, hit.position,
                                 rng.stream_nee(u_vertex, li_idx))
        # the light sample's direction, pdf and point carry no gradient
        wi, pdf = ls.wi.detach(), ls.pdf.detach()
        wi_local = to_local(frame, wi)
        f = bsdf_ops.eval_f(lobe, wo_local, wi_local,
                            lobes=meta.present_lobes,
                            mf_kinds=meta.present_mf_kinds)
        useful = (cont & ~delta & (pdf > 0.0) & ~is_black(ls.li)
                  & ~is_black(f))
        contrib = beta * f * ls.li * (
            absdot(wi, hit.normal) / torch.clamp_min(pdf, 1e-20))[:, None]
        if mis and not scene_pack.light_is_delta(meta, li_idx):
            pb = bsdf_ops.pdf(lobe, wo_local, wi_local,
                              lobes=meta.present_lobes,
                              mf_kinds=meta.present_mf_kinds)
            contrib = contrib * power_heuristic(1.0, pdf, 1.0,
                                                pb.detach())[:, None]
        usefuls.append(useful)
        contribs.append(contrib)
        targets.append(ls.pos.detach())

    # BSDF sampling (reference: src/integrator.cc:375-379)
    bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u_vertex, nl),
                         lobes=meta.present_lobes,
                         mf_kinds=meta.present_mf_kinds)
    # the sampled direction and its pdf carry no gradient; f does
    wi_world = to_world(frame, bs.wi).detach()
    pdf_b = bs.pdf.detach()
    sample_ok = (pdf_b > 0.0) & ~is_black(bs.f)

    # Russian roulette (reference: src/integrator.cc:383-393)
    if bounce >= 3:
        q = torch.clamp_min(1.0 - max_component(bs.f.detach()), 0.05)
        rr_die = rng.stream_rr(u_vertex, nl) < q
        rr_scale = 1.0 / torch.clamp_min(1.0 - q, 1e-6)
    else:
        rr_die = torch.zeros_like(active)
        rr_scale = torch.ones_like(pdf_b)

    active = cont & sample_ok & ~rr_die
    weight = (bs.f * (absdot(wi_world, hit.normal)
                      / torch.clamp_min(pdf_b, 1e-20))[:, None]
              * rr_scale[:, None])
    beta = torch.where(active[:, None], beta * weight, beta)
    ray_o = torch.where(active[:, None], hit.position, ray_o)
    ray_d = torch.where(active[:, None], wi_world, ray_d)
    stacks = _stacks(usefuls, contribs, targets, n, dev)
    return Vertex(VertexState(L, beta, active, bs.is_specular, pdf_b, ray_o,
                              ray_d),
                  *stacks, *_bounds(pack, active),
                  counts=None if counts is None
                  else _counted(counts, bounce, state.active, stacks[0]))


def nee_accumulate_plain(L, useful, occ, contrib):
    """L [N,3] plus each light's contribution [J,N,3] where useful [J,N]
    and not occluded occ [J,N], one light after another."""
    for j in range(useful.shape[0]):
        L = L + torch.where((useful[j] & ~occ[j])[:, None], contrib[j],
                            torch.zeros_like(contrib[j]))
    return L


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_INTS = ("n", "bounce", "last", "roulette", "lobes", "mf_mode", "n_tex",
         "has_images", "n_light_rows", "th", "tw", "s", "n_nee", "u_stride")
_PTRS = ("valid", "pos", "nrm", "wo", "uv", "mat_id", "light_id", "L",
         "beta", "active", "prev_specular", "prev_pdf", "ray_o", "ray_d", "u",
         "mat_kind", "mat_c0", "mat_c1", "mat_s0", "mat_s1", "mat_remap",
         "mat_tex", "mat_mf", "tex_kind", "tex_c0", "tex_c1", "tex_scale",
         "tex_image", "tex_wh", "light_c", "table", "statics", "em", "le_env",
         "L_out", "beta_out",
         "active_out", "spec_out", "pdf_out", "o_out", "d_out", "useful",
         "contrib", "shadow_to", "ray_eps", "tmin_out", "tmax_out", "counts")


class _ShadeArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_void_p) for k in _PTRS])


def _library():
    from ..utils.cuda_build import load_library
    return load_library("shade", ["shade.cu"], _declare)


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.shade_vertex.argtypes = [ctypes.POINTER(_ShadeArgs), vp]
    lib.shade_vertex.restype = ci
    lib.nee_accumulate.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp]
    lib.nee_accumulate.restype = ci
    for name in ("shade_args_size", "shade_table_width"):
        getattr(lib, name).restype = ci
    if (lib.shade_args_size(), lib.shade_table_width()) != (
            ctypes.sizeof(_ShadeArgs), TABLE_W):
        raise RuntimeError("csrc/shade.cu and ops/shade.py disagree on the "
                           "kernel's argument layout")


def _check(name, x, dtype, shape, dev):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{name}: expected a contiguous {dtype} "
                         f"{list(shape)} tensor on {dev}, got {x.dtype} "
                         f"{list(x.shape)} on {x.device}"
                         + ("" if x.is_contiguous() else ", not contiguous"))


def _table_check(name, x, dtype, dev):
    if x.dtype != dtype or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"pack.{name}: expected a contiguous {dtype} tensor "
                         f"on {dev}")


def _mf_mode(kinds) -> int:
    kinds = None if kinds is None else tuple(kinds)
    return {(mf.GGX,): 1, (mf.BECKMANN,): 2}.get(kinds, 0)


_TABLES = {"mat_kind": torch.int32, "mat_c0": torch.float32,
           "mat_c1": torch.float32, "mat_s0": torch.float32,
           "mat_s1": torch.float32, "mat_remap": torch.bool,
           "mat_tex": torch.int32, "mat_mf": torch.int32,
           "tex_kind": torch.int32, "tex_c0": torch.float32,
           "tex_c1": torch.float32, "tex_scale": torch.float32,
           "tex_image": torch.float32, "tex_wh": torch.int32,
           "light_c": torch.float32}


def check_vertex_inputs(meta, pack, hit, state: VertexState, u_vertex,
                        bounce: int, max_depth: int, dev,
                        counts=None) -> None:
    """Raise unless every tensor shade_vertex_kernel reads (the hit, the
    state, the vertex's uniforms below max_depth, rows of S floats with a
    stride of their own, the pack's material, texture and light tables and
    ray_eps, the counters where given) is contiguous, of its dtype and
    shape, on dev, and off the autograd tape."""
    n = state.L.shape[0]
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    ins = {"hit.valid": (hit.valid, b8, (n,)),
           "hit.position": (hit.position, f32, (n, 3)),
           "hit.normal": (hit.normal, f32, (n, 3)),
           "hit.wo": (hit.wo, f32, (n, 3)), "hit.uv": (hit.uv, f32, (n, 2)),
           "hit.mat_id": (hit.mat_id, i32, (n,)),
           "hit.light_id": (hit.light_id, i32, (n,)),
           "L": (state.L, f32, (n, 3)), "beta": (state.beta, f32, (n, 3)),
           "active": (state.active, b8, (n,)),
           "prev_specular": (state.prev_specular, b8, (n,)),
           "prev_pdf": (state.prev_pdf, f32, (n,)),
           "ray_o": (state.ray_o, f32, (n, 3)),
           "ray_d": (state.ray_d, f32, (n, 3))}
    for name, (x, dtype, shape) in ins.items():
        _check(name, x, dtype, shape, dev)
    if bounce < max_depth:
        s = 4 + 2 * meta.n_lights
        if u_vertex.dtype != f32 or tuple(u_vertex.shape) != (n, s) \
                or u_vertex.stride(1) != 1 or u_vertex.device != dev \
                or (n > 1 and u_vertex.stride(0) < s):
            raise ValueError(f"u_vertex: expected float32 [{n}, {s}] rows of "
                             f"contiguous floats on {dev}, got "
                             f"{u_vertex.dtype} {list(u_vertex.shape)} "
                             f"strides {u_vertex.stride()} on "
                             f"{u_vertex.device}")
        ins["u_vertex"] = (u_vertex, f32, (n, s))
    _check("pack.ray_eps", pack.ray_eps, f32, (), dev)
    if counts is not None:
        _check("counts", counts, torch.int64, (4,), dev)
    for name, dtype in _TABLES.items():
        _table_check(name, getattr(pack, name), dtype, dev)
    no_grad_inputs("shade_vertex", **{k.replace(".", "_"): v[0]
                                      for k, v in ins.items()},
                   **{k: getattr(pack, k) for k in _TABLES})


def check_accumulate_inputs(L, useful, occ, contrib, dev) -> int:
    """Raise unless nee_accumulate's inputs are contiguous, of their dtype
    and shape ([N,3], [J,N], [J,N], [J,N,3]), on dev and off the autograd
    tape; returns J."""
    n = L.shape[0]
    j = useful.shape[0] if useful.dim() == 2 else -1
    _check("L", L, torch.float32, (n, 3), dev)
    _check("useful", useful, torch.bool, (j, n), dev)
    _check("occ", occ, torch.bool, (j, n), dev)
    _check("contrib", contrib, torch.float32, (j, n, 3), dev)
    no_grad_inputs("nee_accumulate", L=L, contrib=contrib)
    return j


def _shade_args(meta, pack, hit, state: VertexState, u_vertex, bounce: int,
                max_depth: int, lights: LightTable, n_nee: int,
                outs: dict) -> _ShadeArgs:
    """The kernels' ShadeArgs of one vertex: its sizes and flags, the hit,
    the state's rows (a None row is a null pointer), the uniforms, the
    pack's tables, the light table and the outputs `outs`."""
    n = hit.valid.shape[0]
    last = bounce >= max_depth
    a = _ShadeArgs()
    lobes = bsdf_ops.ALL_LOBES if meta.present_lobes is None \
        else meta.present_lobes
    ints = dict(n=n, bounce=bounce, last=int(last), roulette=int(bounce >= 3),
                lobes=sum(1 << k for k in lobes),
                mf_mode=_mf_mode(meta.present_mf_kinds), n_tex=meta.n_tex,
                has_images=int(pack.tex_image.shape[0] > 0),
                n_light_rows=pack.light_c.shape[0],
                th=pack.tex_image.shape[1] if pack.tex_image.dim() == 4 else 0,
                tw=pack.tex_image.shape[2] if pack.tex_image.dim() == 4 else 0,
                s=4 + 2 * meta.n_lights, n_nee=n_nee,
                u_stride=0 if last else u_vertex.stride(0))
    for k, v in ints.items():
        setattr(a, k, int(v))
    ptrs = dict(valid=hit.valid, pos=hit.position, nrm=hit.normal, wo=hit.wo,
                uv=hit.uv, mat_id=hit.mat_id, light_id=hit.light_id,
                L=state.L, beta=state.beta, active=state.active,
                prev_specular=state.prev_specular, prev_pdf=state.prev_pdf,
                ray_o=state.ray_o, ray_d=state.ray_d,
                u=None if last else u_vertex, table=lights.rows,
                statics=lights.statics, em=lights.em, le_env=lights.le_env,
                ray_eps=pack.ray_eps, **outs,
                **{k: getattr(pack, k) for k in _TABLES})
    for k, v in ptrs.items():
        setattr(a, k, None if v is None else v.data_ptr())
    return a


def _check_lights(meta, lights: LightTable, dev) -> int:
    """Raise unless the light table's tensors are contiguous, of their
    dtype and shape, on dev; returns the NEE lights' count."""
    n_nee = sum(not lm.static_black for lm in meta.lights)
    _check("lights.rows", lights.rows, torch.float32, (n_nee, TABLE_W), dev)
    _check("lights.statics", lights.statics, torch.int32, (n_nee, STATIC_W),
           dev)
    _check("lights.em", lights.em, torch.float32, (lights.em.shape[0], EM_W),
           dev)
    _check("lights.le_env", lights.le_env, torch.float32, (3,), dev)
    return n_nee


def shade_vertex(meta, pack, hit, state: VertexState, u_vertex, bounce: int,
                 max_depth: int, *, lights: LightTable | None = None,
                 counts=None) -> Vertex:
    """`shade_vertex_plain` with nee=True, mis=False: one launch of
    shade_vertex_kernel on CUDA tensors (lights: the pack's light_table,
    made here when not given; counts: None or the wave's [4] int64 ray
    counters, which the kernel adds to in place and returns), the plain
    version on CPU tensors."""
    dev = state.L.device
    if dev.type == "cpu":
        return shade_vertex_plain(meta, pack, hit, state, u_vertex, bounce,
                                  max_depth, counts=counts)
    if dev.type != "cuda":
        raise ValueError(f"no shade_vertex route for device {dev}")
    check_vertex_inputs(meta, pack, hit, state, u_vertex, bounce, max_depth,
                        dev, counts)
    n = state.L.shape[0]
    last = bounce >= max_depth
    f32, b8 = torch.float32, torch.bool
    if lights is None:
        lights = light_table(meta, pack)
    n_nee = _check_lights(meta, lights, dev)

    L_out = torch.empty_like(state.L)
    if last:
        beta_out, active_out, spec_out, pdf_out, o_out, d_out = (
            state.beta, state.active, state.prev_specular, state.prev_pdf,
            state.ray_o, state.ray_d)
        tmin = tmax = None
        nj = 0
    else:
        beta_out = torch.empty_like(state.beta)
        active_out = torch.empty_like(state.active)
        spec_out = torch.empty_like(state.prev_specular)
        pdf_out = torch.empty_like(state.prev_pdf)
        o_out = torch.empty_like(state.ray_o)
        d_out = torch.empty_like(state.ray_d)
        tmin = torch.empty((n,), dtype=f32, device=dev)
        tmax = torch.empty((n,), dtype=f32, device=dev)
        nj = n_nee
    useful = torch.empty((nj, n), dtype=b8, device=dev)
    contrib = torch.empty((nj, n, 3), dtype=f32, device=dev)
    shadow_to = torch.empty((nj, n, 3), dtype=f32, device=dev)

    a = _shade_args(meta, pack, hit, state, u_vertex, bounce, max_depth,
                    lights, nj, dict(
                        L_out=L_out, beta_out=beta_out,
                        active_out=active_out, spec_out=spec_out,
                        pdf_out=pdf_out, o_out=o_out, d_out=d_out,
                        useful=useful, contrib=contrib, shadow_to=shadow_to,
                        tmin_out=tmin, tmax_out=tmax, counts=counts))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.shade_vertex(ctypes.byref(a),
                               torch.cuda.current_stream(dev).cuda_stream)
    shade_vertex.launches += 1
    if err != 0:
        raise RuntimeError(f"shade_vertex launch failed: CUDA error {err}")
    return Vertex(VertexState(L_out, beta_out, active_out, spec_out, pdf_out,
                              o_out, d_out), useful, contrib, shadow_to,
                  tmin, tmax, counts)


shade_vertex.launches = 0
register(__name__, "shade_vertex", "shade_vertex_kernel")


def nee_accumulate(L, useful, occ, contrib):
    """`nee_accumulate_plain`: one launch of nee_accumulate_kernel on CUDA
    tensors for all lights, the plain version on CPU tensors."""
    dev = L.device
    if dev.type == "cpu":
        return nee_accumulate_plain(L, useful, occ, contrib)
    if dev.type != "cuda":
        raise ValueError(f"no nee_accumulate route for device {dev}")
    j = check_accumulate_inputs(L, useful, occ, contrib, dev)
    n = L.shape[0]
    out = torch.empty_like(L)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.nee_accumulate(L.data_ptr(), useful.data_ptr(),
                                 occ.data_ptr(), contrib.data_ptr(), n, j,
                                 out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    nee_accumulate.launches += 1
    if err != 0:
        raise RuntimeError(f"nee_accumulate launch failed: CUDA error {err}")
    return out


nee_accumulate.launches = 0
register(__name__, "nee_accumulate", "nee_accumulate_kernel")


# --------------------------------------------------------------------------
# the backward
# --------------------------------------------------------------------------

class _GradArgs(ctypes.Structure):
    _fields_ = ([("a", _ShadeArgs)]
                + [(k, ctypes.c_void_p) for k in (
                    "gL", "gbeta", "occ", "gbeta_in", "partials", "taps",
                    "tap_rows")]
                + [(k, ctypes.c_int) for k in ("n_mat", "n_tex_rows",
                                               "n_slots", "first",
                                               "device_acc")])


# A material row's parameters by index: 0-2 c0 rgb, 3-5 c1 rgb, 6 s0, 7 s1.
# Material kind -> the parameters a lane's f and BSDF sample depend on
# (make_lobe's uses; rough glass takes c0 or c1 by its lobe, and a
# texture takes c0's three): the backward's tangents. Any other parameter's
# gradient from the lane is exactly 0.
_C0, _C1 = (0, 1, 2), (3, 4, 5)
TANGENTS = {bsdf_ops.MAT_MATTE: _C0, bsdf_ops.MAT_MIRROR: _C0,
            bsdf_ops.MAT_PHONG: _C0 + (6,),
            bsdf_ops.MAT_GLASS: _C0 + _C1 + (6,),
            bsdf_ops.MAT_PLASTIC: _C0 + _C1 + (6,),
            bsdf_ops.MAT_ROUGHGLASS: _C0 + _C1 + (6, 7),
            bsdf_ops.MAT_METAL: _C0 + _C1 + (6, 7)}
# vertex_backward_kernel's instantiations, smallest first: the parameters
# each carries tangents for; a kind takes the first set that holds its row
TANGENT_SETS = (_C0, _C0 + (6,), tuple(range(8)))


def tangent_set(kind: int) -> int:
    """The set of TANGENT_SETS whose kernel computes a lane of this
    material kind."""
    return next(i for i, ps in enumerate(TANGENT_SETS)
                if set(TANGENTS[kind]) <= set(ps))


# the lobes each set's kinds make (scene/builder.py's _LOBES_OF)
_SET_LOBES = ({bsdf_ops.LOBE_LAMBERT, bsdf_ops.LOBE_SPECULAR},
              {bsdf_ops.LOBE_PHONG},
              {bsdf_ops.LOBE_FRESNEL, bsdf_ops.LOBE_MICROFACET,
               bsdf_ops.LOBE_MICROFACET_TRANS})


def backward_sets(meta) -> tuple:
    """The tangent sets vertex_backward launches below max_depth: those of
    the lobes meta.present_lobes holds (every set where it is None), a
    superset of its materials' sets (a plastic makes a Lambert lobe and a
    microfacet one, so its set is launched; a matte one's is launched too
    though no matte material is in the scene)."""
    lobes = set(bsdf_ops.ALL_LOBES if meta.present_lobes is None
                else meta.present_lobes)
    return tuple(i for i, ls in enumerate(_SET_LOBES) if lobes & ls)


def _grad_library():
    from ..utils.cuda_build import load_library
    return load_library("shade_grad", ["shade_grad.cu"], _declare_grad)


def _declare_grad(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.vertex_backward.argtypes = [ctypes.POINTER(_GradArgs), ci, ci, vp]
    lib.vertex_backward.restype = ci
    lib.grad_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.grad_reduce.restype = ci
    for name in ("shade_grad_args_size", "vertex_backward_rows",
                 "vertex_backward_sets", "vertex_backward_set_of",
                 "vertex_backward_set_params"):
        getattr(lib, name).restype = ci
    lib.vertex_backward_rows.argtypes = [ci, ci]
    lib.vertex_backward_set_of.argtypes = [ci]
    lib.vertex_backward_set_params.argtypes = [ci, ctypes.POINTER(ci)]
    if lib.shade_grad_args_size() != ctypes.sizeof(_GradArgs):
        raise RuntimeError("csrc/shade_grad.cu and ops/shade.py disagree on "
                           "the backward's argument layout")


def kernel_tangents() -> tuple:
    """The kernel's own tangent table: (its sets' parameters, each
    material kind's set), for holding against TANGENT_SETS and
    tangent_set."""
    lib = _grad_library()
    sets = []
    for s in range(lib.vertex_backward_sets()):
        params = (ctypes.c_int * 8)()
        sets.append(tuple(params[:lib.vertex_backward_set_params(s, params)]))
    return tuple(sets), {k: lib.vertex_backward_set_of(k) for k in TANGENTS}


def grad_slots(pack) -> dict:
    """{field: (first slot, shape)} of the backward's parameter-gradient
    vector (_SLOT_FIELDS' rows in order, then "le_env", 3 slots)."""
    out, at = {}, 0
    for f in _SLOT_FIELDS:
        shape = tuple(getattr(pack, f).shape)
        out[f] = (at, shape)
        at += math.prod(shape)
    out["le_env"] = (at, (3,))
    return out


def n_grad_slots(pack) -> int:
    return sum(math.prod(shape) for _, shape in grad_slots(pack).values())


def split_grads(flat, pack) -> dict:
    """The backward's parameter-gradient vector as {field: view} (and
    "le_env")."""
    return {f: flat[at:at + math.prod(shape)].view(shape)
            for f, (at, shape) in grad_slots(pack).items()}


def check_backward_inputs(meta, pack, hit, state: VertexState, u_vertex,
                          bounce: int, max_depth: int, occ, gL, gbeta,
                          dev) -> None:
    """Raise unless every tensor vertex_backward_kernel reads is contiguous,
    of its dtype and shape, on dev, and off the autograd tape: the hit,
    beta, active and prev_specular, the uniforms and [J, N] shadow flags
    below max_depth, the pack's tables, gL [N,3] and gbeta [N,3] or None."""
    n = state.beta.shape[0]
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    ins = {"hit.valid": (hit.valid, b8, (n,)),
           "hit.position": (hit.position, f32, (n, 3)),
           "hit.normal": (hit.normal, f32, (n, 3)),
           "hit.wo": (hit.wo, f32, (n, 3)), "hit.uv": (hit.uv, f32, (n, 2)),
           "hit.mat_id": (hit.mat_id, i32, (n,)),
           "hit.light_id": (hit.light_id, i32, (n,)),
           "beta": (state.beta, f32, (n, 3)),
           "active": (state.active, b8, (n,)),
           "prev_specular": (state.prev_specular, b8, (n,)),
           "gL": (gL, f32, (n, 3))}
    if gbeta is not None:
        ins["gbeta"] = (gbeta, f32, (n, 3))
    if bounce < max_depth:
        ins["u_vertex"] = (u_vertex, f32, (n, 4 + 2 * meta.n_lights))
        ins["occ"] = (occ, b8, (occ.shape[0], n))
    for name, (x, dtype, shape) in ins.items():
        if name == "u_vertex":
            if x.dtype != dtype or tuple(x.shape) != shape \
                    or x.stride(1) != 1 or x.device != dev:
                raise ValueError(f"u_vertex: expected float32 {list(shape)} "
                                 f"rows of contiguous floats on {dev}")
        else:
            _check(name, x, dtype, shape, dev)
    for name, dtype in _TABLES.items():
        _table_check(name, getattr(pack, name), dtype, dev)
    no_grad_inputs("vertex_backward", **{k.replace(".", "_"): v[0]
                                         for k, v in ins.items()},
                   **{k: getattr(pack, k) for k in _TABLES})


def vertex_backward(meta, pack, hit, state: VertexState, u_vertex,
                    bounce: int, max_depth: int, lights: LightTable, occ, gL,
                    gbeta=None, taps: bool = False):
    """vertex_backward_kernel, one launch per tangent set of
    backward_sets(meta) below max_depth and one on the last bounce (CUDA
    tensors only; CPU tensors take `vertex_backward_plain` whole): from the
    vertex's inputs (the hit, state.beta, .active, .prev_specular, the
    uniforms, the light table and the bounce's [J, N] shadow flags occ) and
    d loss / d its outputs (gL [N,3], gbeta [N,3] or None for 0), returns
    (d loss / d beta [N,3], the partial parameter gradients [G,
    n_grad_slots] for grad_reduce, and with taps an image texture's
    per-lane texel gradients [N, 4, 3] and flat rows of tex_image [N, 4],
    else None, None). Any number of parameter slots: past a block's shared
    memory the kernel accumulates in the partials' rows."""
    dev = gL.device
    if dev.type != "cuda":
        raise ValueError(f"no vertex_backward kernel for device {dev}")
    check_backward_inputs(meta, pack, hit, state, u_vertex, bounce,
                          max_depth, occ, gL, gbeta, dev)
    n = gL.shape[0]
    last = bounce >= max_depth
    n_nee = _check_lights(meta, lights, dev)
    slots = n_grad_slots(pack)
    lib = _grad_library()
    f32 = dict(dtype=torch.float32, device=dev)
    gbeta_in = torch.empty((n, 3), **f32)
    partials = torch.empty((lib.vertex_backward_rows(n, slots), slots), **f32)
    tap_g = torch.empty((n, 4, 3), **f32) if taps else None
    tap_rows = torch.empty((n, 4), dtype=torch.int64, device=dev) \
        if taps else None
    g = _GradArgs()
    g.a = _shade_args(meta, pack, hit, state, u_vertex, bounce, max_depth,
                      lights, 0 if last else n_nee, {})
    for k, v in dict(gL=gL, gbeta=gbeta, occ=None if last else occ,
                     gbeta_in=gbeta_in, partials=partials, taps=tap_g,
                     tap_rows=tap_rows).items():
        setattr(g, k, None if v is None else v.data_ptr())
    g.n_mat, g.n_tex_rows = pack.mat_c0.shape[0], pack.tex_c0.shape[0]
    g.n_slots = slots
    # the first launch writes every lane's cheap part and the partials'
    # rows, the later ones add theirs
    sets = backward_sets(meta)[:1 if last else None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k, s in enumerate(sets):
            err = lib.vertex_backward(ctypes.byref(g), s, int(k == 0), stream)
            vertex_backward.launches += 1
            if err != 0:
                raise RuntimeError(f"vertex_backward launch failed: CUDA "
                                   f"error {err}")
    return gbeta_in, partials, tap_g, tap_rows


vertex_backward.launches = 0
register(__name__, "vertex_backward", "vertex_backward_kernel")


# grad_reduce's chains (csrc/shade_grad.cu CHAINS)
REDUCE_CHAINS = 64


def grad_reduce_plain(partials):
    """The columns of partials [G, P] summed in a fixed order: REDUCE_CHAINS
    chains, chain c the rows c, c + REDUCE_CHAINS, ... added in order (the
    rows padded with zeros to a multiple of the chains), then a pairwise
    tree over the chains, chain c plus chain c + h for h = REDUCE_CHAINS / 2
    down to 1."""
    g, p = partials.shape
    per = max(1, -(-g // REDUCE_CHAINS))
    rows = torch.cat([partials, partials.new_zeros(
        (per * REDUCE_CHAINS - g, p))]).view(per, REDUCE_CHAINS, p)
    acc = rows[0].clone()
    for r in range(1, per):
        acc = acc + rows[r]
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return acc[0]


def grad_reduce(partials):
    """`grad_reduce_plain`: one launch of grad_reduce_kernel on a CUDA
    tensor [G, P] (float32, contiguous), the plain version on a CPU
    tensor."""
    dev = partials.device
    if dev.type == "cpu":
        return grad_reduce_plain(partials)
    if dev.type != "cuda":
        raise ValueError(f"no grad_reduce route for device {dev}")
    _check("partials", partials, torch.float32, tuple(partials.shape), dev)
    no_grad_inputs("grad_reduce", partials=partials)
    grid, slots = partials.shape
    out = torch.empty((slots,), dtype=torch.float32, device=dev)
    lib = _grad_library()
    with torch.cuda.device(dev):
        err = lib.grad_reduce(partials.data_ptr(), grid, slots,
                              out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    grad_reduce.launches += 1
    if err != 0:
        raise RuntimeError(f"grad_reduce launch failed: CUDA error {err}")
    return out


grad_reduce.launches = 0
register(__name__, "grad_reduce", "grad_reduce_kernel")


def vertex_backward_plain(meta, pack, hit, state: VertexState, u_vertex,
                          bounce: int, max_depth: int, occ, gL, gbeta=None,
                          le_env=None):
    """One vertex's backward by autograd through its plain versions
    (shade_vertex_plain, then below max_depth nee_accumulate_plain with the
    shadow flags occ) recomputed on the same inputs: returns (d loss / d L,
    d loss / d beta, {field of GRAD_FIELDS: its gradient}, d loss / d
    le_env or None) for d loss / d the vertex's L gL and beta gbeta (None:
    0). le_env: the environment's radiance the forward took (None: the
    plain version's own, from light_c)."""
    with torch.enable_grad():
        leaves = {f: getattr(pack, f).detach().requires_grad_(True)
                  for f in GRAD_FIELDS}
        L = state.L.detach().requires_grad_(True)
        beta = state.beta.detach().requires_grad_(True)
        le = None if le_env is None else le_env.detach().requires_grad_(True)
        v = shade_vertex_plain(meta, pack._replace(**leaves), hit,
                               state._replace(L=L, beta=beta), u_vertex,
                               bounce, max_depth, le_env=le)
        outs, gouts = [v.state.L], [gL]
        if bounce < max_depth:
            outs[0] = nee_accumulate_plain(v.state.L, v.useful, occ, v.contrib)
            if gbeta is not None:
                outs.append(v.state.beta)
                gouts.append(gbeta)
        ins = (L, beta, *leaves.values(), *(() if le is None else (le,)))
        grads = torch.autograd.grad(outs, ins, gouts, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ins, grads)]
    return (grads[0], grads[1], dict(zip(GRAD_FIELDS, grads[2:10])),
            grads[10] if le is not None else None)


def vertex_grads(meta, pack, hit, state: VertexState, u_vertex, bounce: int,
                 max_depth: int, lights, occ, gL, gbeta=None,
                 fields=GRAD_FIELDS):
    """(d loss / d L, d loss / d beta, {field: gradient} for `fields`, d
    loss / d lights.le_env or None) of one vertex: on the card
    vertex_backward's launches and grad_reduce (and, where "tex_image" is
    among the fields and the pack has images, index_add_ of the texel
    taps), on the CPU vertex_backward_plain."""
    if gL.device.type == "cpu":
        gl, gb, g, ge = vertex_backward_plain(
            meta, pack, hit, state, u_vertex, bounce, max_depth, occ, gL,
            gbeta, None if lights is None else lights.le_env)
        return gl, gb, {f: g[f] for f in fields}, ge
    # the last bounce reads no material: no texel tap
    taps = "tex_image" in fields and pack.tex_image.shape[0] > 0 \
        and bounce < max_depth
    gb, partials, tap_g, tap_rows = vertex_backward(
        meta, pack, hit, state, u_vertex, bounce, max_depth, lights, occ, gL,
        gbeta, taps)
    flat = split_grads(grad_reduce(partials), pack)
    g = {f: flat[f] for f in fields if f in flat}
    if "tex_image" in fields:
        img = pack.tex_image
        g["tex_image"] = torch.zeros_like(img) if not taps else \
            torch.zeros((img.numel() // 3, 3), dtype=img.dtype,
                        device=img.device).index_add_(
                0, tap_rows.view(-1), tap_g.view(-1, 3)).view(img.shape)
    return gL, gb, g, flat["le_env"]


class _VertexCall:
    """What `vertex` hands its Function besides the tensors autograd
    tracks: the vertex's other inputs, and after the forward its outputs
    (`vertex`, the Vertex; `occ`, the shadow flags)."""

    def __init__(self, meta, pack, hit, state, u_vertex, bounce, max_depth,
                 lights, counts, occlude):
        self.meta, self.pack, self.hit, self.state = meta, pack, hit, state
        self.u_vertex, self.bounce, self.max_depth = u_vertex, bounce, \
            max_depth
        self.lights, self.counts, self.occlude = lights, counts, occlude
        self.vertex = self.occ = None


class _Vertex(torch.autograd.Function):
    """shade_vertex, the shadow casts and nee_accumulate of one vertex:
    (L, beta, le_env, *GRAD_FIELDS) -> L after the NEE and, below
    max_depth, the next beta. The forward runs the wrappers on detached
    inputs; the backward is vertex_grads on what it saved."""

    @staticmethod
    def forward(ctx, call, L, beta, le_env, *fields):
        pack = call.pack._replace(**{f: x.detach()
                                     for f, x in zip(GRAD_FIELDS, fields)})
        state = call.state._replace(L=L.detach(), beta=beta.detach())
        lights = call.lights if le_env is None \
            else call.lights._replace(le_env=le_env.detach())
        last = call.bounce >= call.max_depth
        with span("li_path.vertex"):
            v = shade_vertex(call.meta, pack, call.hit, state, call.u_vertex,
                             call.bounce, call.max_depth, lights=lights,
                             counts=call.counts)
        L_out, occ = v.state.L, None
        if not last:
            with span("li_path.occluded"):
                occ = call.occlude(v)
            with span("li_path.nee_accumulate"):
                L_out = nee_accumulate(v.state.L, v.useful, occ, v.contrib)
        call.vertex, call.occ = v, occ
        if any(ctx.needs_input_grad):
            if L.device.type == "cuda":
                # what the backward kernel reads of the state
                state = state._replace(L=None, prev_pdf=None, ray_o=None,
                                       ray_d=None)
            ctx.saved = (call.meta, pack, call.hit, state, call.u_vertex,
                         call.bounce, call.max_depth, lights, occ)
            ctx.set_materialize_grads(False)
        return L_out if last else (L_out, v.state.beta)

    @staticmethod
    def backward(ctx, gL, gbeta=None):
        meta, pack, hit, state, u_vertex, bounce, max_depth, lights, occ = \
            ctx.saved
        need = ctx.needs_input_grad
        if gL is None:
            gL = torch.zeros_like(state.beta)
        fields = tuple(f for f, k in zip(GRAD_FIELDS, need[4:]) if k)
        gl, gb, g, ge = vertex_grads(meta, pack, hit, state, u_vertex,
                                     bounce, max_depth, lights, occ, gL,
                                     gbeta, fields)
        return (None, gl if need[1] else None, gb if need[2] else None,
                ge if need[3] else None, *(g.get(f) for f in GRAD_FIELDS))


def vertex(meta, pack, hit, state: VertexState, u_vertex, bounce: int,
           max_depth: int, *, lights: LightTable | None = None, counts=None,
           occlude=None):
    """li_path's vertex on the kernel route, differentiable: shade_vertex
    (`lights` as it takes them; on the card li_path's light_table), then
    below max_depth the bounce's shadow casts, occlude(v) -> [J, N] bool
    flags, and nee_accumulate. Returns (the Vertex with its state's L after
    the NEE, the flags or None). Under autograd, where state.L, .beta,
    lights.le_env or a pack field of GRAD_FIELDS requires grad, the whole
    vertex is one torch.autograd.Function whose backward is vertex_grads
    (on the card vertex_backward's launches and one grad_reduce)."""
    call = _VertexCall(meta, pack, hit, state, u_vertex, bounce, max_depth,
                       lights, counts, occlude)
    le_env = None if lights is None else lights.le_env
    out = _Vertex.apply(call, state.L, state.beta, le_env,
                        *(getattr(pack, f) for f in GRAD_FIELDS))
    v = call.vertex
    if bounce >= max_depth:
        return v._replace(state=v.state._replace(L=out)), None
    return v._replace(state=v.state._replace(L=out[0], beta=out[1])), \
        call.occ
