"""A configuration's scene as the reference's tensors.

A configuration file (pbrt_bench/configs/*.json) states its scene as a list
of operations: materials, shapes, meshes and lights in the order a scene
builder adds them. This module lays them out as the program's builder does
(jet_pbrt_tpu_torch/scene/builder.py at commit 77f45ea: the same row order,
float32 casts, face normals, light ids, world sphere and ray epsilon), so
that both sides see the same numbers, and builds the reference's own
intersection structures (bvh.py). It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bsdf as bsdf_ops
from . import bvh as bvh_ops
from . import meshes
from . import microfacet as mf_ops
from .consts import (KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST,
                     LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_AREA, LIGHT_ENV)

RAY_EPS_REL = 1.25e-6
MATERIAL_KINDS = {
    "matte": bsdf_ops.MAT_MATTE, "mirror": bsdf_ops.MAT_MIRROR,
    "glass": bsdf_ops.MAT_GLASS, "plastic": bsdf_ops.MAT_PLASTIC,
    "metal": bsdf_ops.MAT_METAL, "roughglass": bsdf_ops.MAT_ROUGHGLASS,
    "phong": bsdf_ops.MAT_PHONG}
_LOBES_OF = {
    bsdf_ops.MAT_MATTE: (bsdf_ops.LOBE_LAMBERT,),
    bsdf_ops.MAT_MIRROR: (bsdf_ops.LOBE_SPECULAR,),
    bsdf_ops.MAT_GLASS: (bsdf_ops.LOBE_FRESNEL,),
    bsdf_ops.MAT_PLASTIC: (bsdf_ops.LOBE_LAMBERT, bsdf_ops.LOBE_MICROFACET),
    bsdf_ops.MAT_METAL: (bsdf_ops.LOBE_MICROFACET,),
    bsdf_ops.MAT_ROUGHGLASS: (bsdf_ops.LOBE_MICROFACET,
                              bsdf_ops.LOBE_MICROFACET_TRANS),
    bsdf_ops.MAT_PHONG: (bsdf_ops.LOBE_PHONG,),
}
_MF = {"ggx": mf_ops.GGX, "beckmann": mf_ops.BECKMANN}


@dataclasses.dataclass(frozen=True)
class Light:
    kind: int
    shape_kind: int = -1
    shape_idx: int = -1
    static_black: bool = False


def face_normals(tris: np.ndarray, flip: bool) -> np.ndarray:
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30),
                 np.array([0, 0, 1], np.float32))
    return (-n if flip else n).astype(np.float32)


def material_row(op: dict) -> tuple:
    """(kind, c0, c1, s0, s1, remap, mf) of a material operation, as the
    builder's add_<kind> stores it."""
    kind = MATERIAL_KINDS[op["kind"]]
    z = (0.0, 0.0, 0.0)
    mf = _MF[op.get("distribution", "ggx")]
    remap = bool(op.get("remap", False))
    if op["kind"] in ("matte", "mirror"):
        return kind, op["color"], z, 0.0, 0.0, False, mf_ops.GGX
    if op["kind"] == "glass":
        return kind, op["kr"], op["kt"], op["eta"], 0.0, False, mf_ops.GGX
    if op["kind"] == "plastic":
        return (kind, op["kd"], op["ks"], op["roughness"], op["roughness"],
                remap, mf)
    if op["kind"] == "metal":
        return (kind, op["eta"], op["k"], op["urough"], op["vrough"], remap,
                mf)
    if op["kind"] == "roughglass":
        return (kind, op["kr"], op["kt"], op["roughness"], op["eta"], remap,
                mf)
    return kind, op["ks"], z, op["exponent"], 0.0, False, mf_ops.GGX


class Layout:
    """The scene's rows in numpy, in the builder's order and types."""

    def __init__(self, config: dict):
        self.tris, self.tri_mat, self.tri_light, self.tri_flip = [], [], [], []
        self.sph, self.rect, self.disk = [], [], []
        self.mats, self.mat_names = [], {}
        self.lights = []        # (Light, radiance, pos, direction)
        self.families = []      # dict(tris, n, inst=[(off, scale, mat, light)])
        for op in config["scene"]:
            getattr(self, "_" + op["op"])(op)
        cam = config["camera"]
        self.lookfrom = tuple(cam["lookfrom"])
        self.lookat = tuple(cam["lookat"])
        self.vup = tuple(cam["vup"])
        self.vfov = float(cam["vfov"])
        build = config.get("build", {})
        self.use_bvh = build.get("use_bvh")
        if self.use_bvh is None:
            self.use_bvh = len(self.tris) > 64
        self._world()

    # -- operations --------------------------------------------------------
    def _material(self, op):
        self.mat_names[op["name"]] = len(self.mats)
        self.mats.append(material_row(op))

    def _light(self, light: Light, c, pos=(0, 0, 0), direction=(0, 0, 1)):
        self.lights.append((light, np.asarray(c, np.float32),
                            np.asarray(pos, np.float32),
                            np.asarray(direction, np.float32)))
        return len(self.lights) - 1

    def _env_light(self, op):
        self._light(Light(LIGHT_ENV), op["radiance"])

    def _point_light(self, op):
        self._light(Light(LIGHT_POINT), op["intensity"], pos=op["position"])

    def _directional_light(self, op):
        d = np.asarray(op["direction"], np.float64)
        self._light(Light(LIGHT_DIRECTIONAL), op["irradiance"],
                    direction=d / np.linalg.norm(d))

    def _area(self, kind, idx, radiance):
        lid = self._light(Light(LIGHT_AREA, kind, idx), radiance)
        if kind == KIND_TRI:
            self.tri_light[idx] = lid
        elif kind == KIND_SPHERE:
            self.sph[idx][3] = lid
        elif kind == KIND_RECT:
            self.rect[idx][3] = lid
        else:
            self.disk[idx][4] = lid

    def _add_tri(self, pts, mat, flip):
        self.tris.append(np.stack([np.asarray(p, np.float32) for p in pts]))
        self.tri_mat.append(self.mat_names[mat])
        self.tri_light.append(-1)
        self.tri_flip.append(bool(flip))
        return len(self.tris) - 1

    def _triangle(self, op):
        i = self._add_tri(op["points"], op["material"],
                          op.get("flip_normal", False))
        if op.get("light") is not None:
            self._area(KIND_TRI, i, op["light"])

    def _quad(self, op):
        q0, q1, q2, q3 = op["points"]
        flip = op.get("flip_normal", False)
        t1 = self._add_tri((q0, q1, q2), op["material"], flip)
        t2 = self._add_tri((q0, q2, q3), op["material"], flip)
        if op.get("light") is not None:
            for t in (t1, t2):
                self._area(KIND_TRI, t, op["light"])

    def _rect(self, op):
        q = np.stack([np.asarray(p, np.float32) for p in op["points"]])
        n = np.cross(q[1] - q[0], q[2] - q[0])
        n = n / np.linalg.norm(n)
        if op.get("flip_normal", False):
            n = -n
        self.rect.append([q, n.astype(np.float32),
                          self.mat_names[op["material"]], -1])
        if op.get("light") is not None:
            self._area(KIND_RECT, len(self.rect) - 1, op["light"])

    def _rect_xz(self, op):
        (x0, x1), (z0, z1), y = op["x"], op["z"], op["y"]
        self._rect(dict(op, points=((x0, y, z0), (x0, y, z1), (x1, y, z1),
                                    (x1, y, z0))))

    def _sphere(self, op):
        self.sph.append([np.asarray(op["center"], np.float32),
                         float(op["radius"]), self.mat_names[op["material"]],
                         -1])
        if op.get("light") is not None:
            self._area(KIND_SPHERE, len(self.sph) - 1, op["light"])

    def _disk(self, op):
        n = np.asarray(op["normal"], np.float32)
        n = n / np.linalg.norm(n)
        self.disk.append([np.asarray(op["center"], np.float32), n,
                          float(op["radius"]), self.mat_names[op["material"]],
                          -1])
        if op.get("light") is not None:
            self._area(KIND_DISK, len(self.disk) - 1, op["light"])

    def _instanced_mesh(self, op):
        tris = np.asarray(meshes.make(op["mesh"]), np.float32).copy()
        if op.get("flip_handedness", False):
            tris[..., 2] *= -1.0
        rows = [(np.asarray(i["offset"], np.float32), float(i["scale"]),
                 self.mat_names[i["material"]], -1) for i in op["instances"]]
        self.families.append(dict(
            tris=tris, n=face_normals(tris, op.get("flip_normal", False)),
            inst=rows))

    # -- the world sphere and ray epsilon (builder.build) ------------------
    def _world(self):
        tri = (np.stack(self.tris) if self.tris
               else np.zeros((0, 3, 3), np.float32))
        rect_q = (np.stack([r[0] for r in self.rect]) if self.rect
                  else np.zeros((0, 4, 3), np.float32))
        disk_c = (np.stack([r[0] for r in self.disk]) if self.disk
                  else np.zeros((0, 3), np.float32))
        pts = [tri[:, 0], tri[:, 1], tri[:, 2], rect_q.reshape(-1, 3), disk_c]
        if self.sph:
            c = np.stack([s[0] for s in self.sph])
            r = np.array([s[1] for s in self.sph], np.float32)
            pts += [c - r[:, None], c + r[:, None]]
        for fam in self.families:
            lo = fam["tris"].reshape(-1, 3).min(0)
            hi = fam["tris"].reshape(-1, 3).max(0)
            for off, scale, _m, _l in fam["inst"]:
                pts.append(np.stack([lo * scale + off, hi * scale + off]))
        allpts = np.concatenate([p for p in pts if len(p)]
                                or [np.zeros((1, 3), np.float32)])
        bmin, bmax = allpts.min(0), allpts.max(0)
        center = 0.5 * (bmin + bmax)
        radius = float(np.linalg.norm(bmax - center))
        self.world_center = np.asarray(center, np.float32)
        self.world_radius = np.asarray(radius, np.float32)
        self.ray_eps = np.asarray(max(float(2.0 * radius) * RAY_EPS_REL,
                                      1e-30), np.float32)

    def static_lights(self) -> tuple:
        """Each light's descriptor, static_black where its radiance is 0
        (NEE skips it)."""
        return tuple(dataclasses.replace(lm, static_black=True)
                     if float(np.abs(c).sum()) == 0.0 else lm
                     for lm, c, _p, _d in self.lights)


class RefScene:
    """The reference's scene on one device in one float type: the fields
    that the copied shading and light code read (the program's pack and
    meta names), the brute-force shapes and the BVH meshes."""

    def __init__(self, layout: Layout, device, dtype=torch.float32):
        self.layout = layout
        self.device = torch.device(device)
        self.dtype = dtype
        f = lambda x, shape=(3,): torch.as_tensor(
            np.asarray(x, np.float32).reshape((-1,) + shape),
            device=device).to(dtype)
        i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32),
                                        device=device)
        L = layout
        tri = (np.stack(L.tris) if L.tris
               else np.zeros((0, 3, 3), np.float32))
        self.tri_p0, self.tri_p1, self.tri_p2 = (f(tri[:, k]) for k in range(3))
        self.tri_n = f(np.concatenate([face_normals(tri[k:k + 1], fl)
                                       for k, fl in enumerate(L.tri_flip)])
                       if L.tris else np.zeros((0, 3)))
        self.tri_mat = i32(L.tri_mat)
        self.tri_light = i32(L.tri_light)
        self.sph_c = f([s[0] for s in L.sph])
        self.sph_r = f([s[1] for s in L.sph], ())
        self.sph_mat = i32([s[2] for s in L.sph])
        self.sph_light = i32([s[3] for s in L.sph])
        self.rect_q = f([r[0] for r in L.rect], (4, 3))
        self.rect_n = f([r[1] for r in L.rect])
        self.rect_mat = i32([r[2] for r in L.rect])
        self.rect_light = i32([r[3] for r in L.rect])
        self.disk_c = f([r[0] for r in L.disk])
        self.disk_n = f([r[1] for r in L.disk])
        self.disk_r = f([r[2] for r in L.disk], ())
        self.disk_mat = i32([r[3] for r in L.disk])
        self.disk_light = i32([r[4] for r in L.disk])
        self.mat_kind = i32([m[0] for m in L.mats])
        self.mat_c0 = f([m[1] for m in L.mats])
        self.mat_c1 = f([m[2] for m in L.mats])
        self.mat_s0 = f([m[3] for m in L.mats], ())
        self.mat_s1 = f([m[4] for m in L.mats], ())
        self.mat_remap = torch.as_tensor([m[5] for m in L.mats],
                                         dtype=torch.bool, device=device)
        self.mat_mf = i32([m[6] for m in L.mats])
        self.light_c = f([c for _l, c, _p, _d in L.lights])
        self.light_pos = f([p for _l, _c, p, _d in L.lights])
        self.light_dir = f([d for _l, _c, _p, d in L.lights])
        self.world_radius = torch.as_tensor(L.world_radius,
                                            device=device).to(dtype)
        self.ray_eps = torch.as_tensor(L.ray_eps, device=device).to(dtype)
        self.lights = L.static_lights()
        self.n_lights = len(self.lights)
        self.env_light_indices = tuple(i for i, lt in enumerate(self.lights)
                                       if lt.kind == LIGHT_ENV)
        kinds = {m[0] for m in L.mats}
        self.present_lobes = tuple(sorted({lb for k in kinds
                                           for lb in _LOBES_OF[k]}))
        self.present_mf_kinds = tuple(sorted({
            m[6] for m in L.mats if m[0] in (bsdf_ops.MAT_PLASTIC,
                                             bsdf_ops.MAT_METAL,
                                             bsdf_ops.MAT_ROUGHGLASS)}))
        # BVH meshes: the triangle soup (where the builder gives it a BVH)
        # and each instanced family; no emissive instances here
        self.inst_em_tris, self.inst_em_n = (), ()
        self.meshes = []    # (kind, tree, n_tris, off [I,3], scl [I], mat, light)
        if L.use_bvh and L.tris:
            tree = bvh_ops.to_tree(bvh_ops.build(tri), device, dtype)
            self.meshes.append((KIND_TRI, tree, len(tri),
                                torch.zeros((1, 3), dtype=dtype,
                                            device=device),
                                torch.ones((1,), dtype=dtype, device=device),
                                None, None))
        for mi, fam in enumerate(L.families):
            tree = bvh_ops.to_tree(bvh_ops.build(fam["tris"]), device, dtype)
            self.meshes.append((
                KIND_INST + mi, tree, len(fam["tris"]),
                f([r[0] for r in fam["inst"]]),
                f([r[1] for r in fam["inst"]], ()),
                i32([r[2] for r in fam["inst"]]),
                i32([r[3] for r in fam["inst"]])))
        self.family_n = [f(fam["n"]) for fam in L.families]
        self.brute_tri = bool(L.tris) and not L.use_bvh

    def with_params(self, **fields) -> "RefScene":
        """A shallow copy with some fields (mat_c0, light_c) replaced."""
        out = object.__new__(RefScene)
        out.__dict__.update(self.__dict__)
        out.__dict__.update(fields)
        return out
