"""Host-side scene construction -> packed tensors.

PyTorch counterpart of jet_pbrt_tpu/scene/builder.py (reference:
src/scene.h:66-124, src/scene.cc:11-97). Rows accumulate in numpy and
`build()` lays them out exactly as the reference's CPU build does (same BVH
leaf size, so triangle order is identical on both sides), routes every BVH
mesh (a use_bvh soup, each instanced family) as the reference's TPU build
would (`sweep_route`), and scene/convert.py builds the one traversal layout
of its route: the 8-wide tables or the cull-sweep tables. Textures are
rows of one table, images padded to the largest (ops/texture.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import bsdf as bsdf_ops
from ..ops import microfacet as mf_ops
from ..ops import sweep_bvh, texture as tex_ops, wide_bvh
from ..ops.bvh import build_bvh, build_box_bvh, pack_node_table
from ..ops.linalg import RAY_EPS_REL
from .pack import (KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST,
                   LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_AREA, LIGHT_ENV,
                   LightMeta, SceneMeta, ScenePack)


@dataclasses.dataclass
class CameraConfig:
    lookfrom: tuple
    front: tuple
    vup: tuple
    vfov: float


@dataclasses.dataclass
class Scene:
    meta: SceneMeta
    pack: ScenePack
    camera: CameraConfig

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, pack=self.pack.to(device))


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
_MF_MATS = {bsdf_ops.MAT_PLASTIC, bsdf_ops.MAT_METAL, bsdf_ops.MAT_ROUGHGLASS}

# the leaf size of the reference TPU build, whose tables its routing gate
# measures (jet_pbrt_tpu/scene/builder.py:426-428)
WIDE_LEAF = 16
# instance fields of the TPU kernels are 5 bits (builder.py:578)
MAX_SWEEP_INST = 32


def sweep_route(n_wide: int, n_rows: int, n_inst: int | None = None) -> bool:
    """True exactly where the reference's TPU build sends a mesh to the
    cull-sweep kernel (builder.py:544-600): its tables at the wide leaf of
    16 (n_wide 8-wide nodes, TLAS nodes included for a family; n_rows
    triangle rows) exceed the wide kernel's VMEM/SMEM budget, the rows fit
    the sweep's 8192 groups, and a family has fewer than 32 instances.
    Everywhere else the port takes the wide kernel: where the reference
    takes its XLA skip-link walk (more groups, more instances, or its CPU
    build) the wide kernel is that walk's counterpart in the port."""
    if n_inst is not None and n_inst >= MAX_SWEEP_INST:
        return False
    if wide_bvh.fits_vmem(n_wide, n_rows, WIDE_LEAF):
        return False
    return (n_rows + sweep_bvh.GROUP - 1) // sweep_bvh.GROUP \
        <= sweep_bvh.max_groups()


def _wide_leaf_counts(p0, p1, p2) -> tuple[int, int]:
    """(8-wide nodes, triangle rows) of the mesh's tables at WIDE_LEAF, the
    counts the reference's gate reads. Evaluating the gate on the port's
    own leaf-4 tables would let the SMEM term bind near 110k triangles
    instead of 350k."""
    bvh, order = build_bvh(p0, p1, p2, leaf_size=WIDE_LEAF)
    return wide_bvh.collapse_wide(bvh, WIDE_LEAF)[0].shape[0], len(order)


def _face_normals(tris: np.ndarray, flip: bool) -> np.ndarray:
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30),
                 np.array([0, 0, 1], np.float32))
    return (-n if flip else n).astype(np.float32)


class SceneBuilder:
    def __init__(self, name: str):
        self.name = name
        self.camera: CameraConfig | None = None
        self._tri_blocks = []
        self._tri_count = 0
        self._tri_lights = {}   # global tri index -> light id
        self._sph = []          # rows: (c, r, mat, light)
        self._rect = []         # rows: (q[4,3], n, mat, light)
        self._disk = []         # rows: (c, n, r, mat, light)
        self._mat = []          # rows: (kind, c0, c1, s0, s1, remap, tex, mf)
        self._lights = []       # rows: (LightMeta, c, pos, dir)
        self._tex = []          # rows: (kind, c0, c1, scale, image or None)
        self._inst_meshes = []  # per family: local mesh + instance rows

    def set_camera(self, lookfrom, lookat=None, front=None, vup=(0, 1, 0),
                   vfov=60.0):
        if front is None:
            front = (np.asarray(lookat, np.float64)
                     - np.asarray(lookfrom, np.float64))
        self.camera = CameraConfig(
            lookfrom=tuple(lookfrom), front=tuple(np.asarray(front, np.float64)),
            vup=tuple(vup), vfov=float(vfov))

    # -- textures (reference: src/texture.h, wired into materials) ----------
    def _add_tex(self, kind, c0=(0, 0, 0), c1=(0, 0, 0), scale=1.0,
                 image=None) -> int:
        self._tex.append((kind, np.asarray(c0, np.float32),
                          np.asarray(c1, np.float32), float(scale), image))
        return len(self._tex) - 1

    def add_solid_texture(self, color) -> int:
        return self._add_tex(tex_ops.TEX_SOLID, color)

    def add_checker_texture(self, c0, c1, scale: float = 10.0) -> int:
        """3D sine checker (reference: src/texture.cc:26-35; the default
        scale is its fixed frequency)."""
        return self._add_tex(tex_ops.TEX_CHECKER, c0, c1, scale)

    def add_image_texture(self, image, bilinear: bool = False) -> int:
        """image: [H,W,3] floats in [0,1], uint8 (scaled by 1/255 as
        src/texture.cc:70 does), or a file path: a .ppm through
        utils/image.read_ppm, any other format through PIL (imported here,
        so its absence raises only on such a path)."""
        if isinstance(image, str):
            if image.lower().endswith(".ppm"):
                from ..utils.image import read_ppm
                image = read_ppm(image)
            else:
                from PIL import Image
                image = np.asarray(Image.open(image).convert("RGB"))
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        kind = tex_ops.TEX_IMAGE_BILINEAR if bilinear else tex_ops.TEX_IMAGE
        return self._add_tex(kind, image=image.astype(np.float32))

    # -- materials (reference: src/material.h) ------------------------------
    def _add_mat(self, kind, c0, c1=(0, 0, 0), s0=0.0, s1=0.0,
                 remap=False, tex: int = -1, mf: int = mf_ops.GGX) -> int:
        self._mat.append((kind, np.asarray(c0, np.float32),
                          np.asarray(c1, np.float32), float(s0), float(s1),
                          bool(remap), int(tex), int(mf)))
        return len(self._mat) - 1

    @staticmethod
    def _mf_kind(distribution: str) -> int:
        try:
            return {"ggx": mf_ops.GGX, "beckmann": mf_ops.BECKMANN}[
                distribution]
        except KeyError:
            raise ValueError(f"unknown microfacet distribution "
                             f"{distribution!r}") from None

    def add_matte(self, color, tex: int = -1) -> int:
        return self._add_mat(bsdf_ops.MAT_MATTE, color, tex=tex)

    def add_mirror(self, color) -> int:
        return self._add_mat(bsdf_ops.MAT_MIRROR, color)

    def add_glass(self, eta: float, kr=(1, 1, 1), kt=(1, 1, 1)) -> int:
        return self._add_mat(bsdf_ops.MAT_GLASS, kr, kt, eta)

    def add_plastic(self, kd, ks, roughness: float, remap: bool = False,
                    tex: int = -1, distribution: str = "ggx") -> int:
        return self._add_mat(bsdf_ops.MAT_PLASTIC, kd, ks, roughness,
                             roughness, remap, tex=tex,
                             mf=self._mf_kind(distribution))

    def add_metal(self, eta, k, urough: float, vrough: float,
                  remap: bool = False, distribution: str = "ggx") -> int:
        return self._add_mat(bsdf_ops.MAT_METAL, eta, k, urough, vrough, remap,
                             mf=self._mf_kind(distribution))

    def add_roughglass(self, eta: float, roughness: float, kr=(1, 1, 1),
                       kt=(1, 1, 1), remap: bool = False,
                       distribution: str = "ggx") -> int:
        """Rough dielectric: microfacet reflection and transmission
        (reference: src/bsdf.cc:80-145)."""
        return self._add_mat(bsdf_ops.MAT_ROUGHGLASS, kr, kt, roughness, eta,
                             remap, mf=self._mf_kind(distribution))

    def add_phong(self, ks, exponent: float) -> int:
        """Energy-conserving modified Phong reflection (reference:
        src/bsdf.h:555-631)."""
        return self._add_mat(bsdf_ops.MAT_PHONG, ks, s0=exponent)

    # -- shapes -----------------------------------------------------------
    def _add_tri_block(self, tris, mat: int, flip_normal: bool, uvs=None):
        tris = np.asarray(tris, np.float32)
        k = len(tris)
        if uvs is None:
            uvs = np.zeros((k, 3, 2), np.float32)
        self._tri_blocks.append(dict(
            p0=tris[:, 0], p1=tris[:, 1], p2=tris[:, 2],
            n=_face_normals(tris, flip_normal),
            uv=np.asarray(uvs, np.float32), mat=mat))
        start = self._tri_count
        self._tri_count += k
        return [(KIND_TRI, start + i) for i in range(k)]

    def add_triangle(self, p0, p1, p2, mat: int, flip_normal=False, uv=None):
        """uv: optional per-vertex texcoords [3,2]."""
        tri = np.stack([np.asarray(p, np.float32) for p in (p0, p1, p2)])
        uvs = None if uv is None else np.asarray(uv, np.float32)[None]
        return self._add_tri_block(tri[None], mat, flip_normal, uvs)[0]

    def add_mesh(self, tris, mat: int, flip_normal=False,
                 flip_handedness=False, offset=(0, 0, 0), scale=1.0,
                 uvs=None):
        """tris: [T,3,3] vertex soup (+ optional uvs [T,3,2]); z-flip, then
        scale, then offset (reference: src/shape.cc:48-61)."""
        tris = np.asarray(tris, np.float32).copy()
        if flip_handedness:
            tris[..., 2] *= -1.0
        tris = tris * np.float32(scale) + np.asarray(offset, np.float32)
        return self._add_tri_block(tris, mat, flip_normal, uvs)

    def add_instanced_mesh(self, tris, instances, flip_normal=False,
                           flip_handedness=False, uvs=None):
        """One mesh family shared by many (offset, scale, mat) instances. A
        fourth entry, a radiance, makes that instance an emissive mesh: one
        area light over its whole surface (reference package
        builder.py:202-240)."""
        tris = np.asarray(tris, np.float32).copy()
        if flip_handedness:
            tris[..., 2] *= -1.0
        if uvs is None:
            uvs = np.zeros((len(tris), 3, 2), np.float32)
        mesh_idx = len(self._inst_meshes)
        rows = []
        for entry in instances:
            off, scale, mat = entry[:3]
            if not float(scale) > 0.0:
                raise ValueError("instance scale must be positive")
            light_id = -1
            if len(entry) > 3:
                light_id = self._add_light(
                    LightMeta(LIGHT_AREA, shape_kind=KIND_INST + mesh_idx,
                              shape_idx=len(rows)), entry[3])
            rows.append((np.asarray(off, np.float32), float(scale), int(mat),
                         light_id))
        self._inst_meshes.append(dict(
            tris=tris, n=_face_normals(tris, flip_normal),
            uv=np.asarray(uvs, np.float32), inst=rows))
        return mesh_idx, list(range(len(rows)))

    def add_sphere(self, center, radius: float, mat: int):
        self._sph.append([np.asarray(center, np.float32), float(radius), mat, -1])
        return (KIND_SPHERE, len(self._sph) - 1)

    def add_rect(self, q0, q1, q2, q3, mat: int, flip_normal=False):
        q = np.stack([np.asarray(p, np.float32) for p in (q0, q1, q2, q3)])
        n = np.cross(q[1] - q[0], q[2] - q[0])
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        self._rect.append([q, n.astype(np.float32), mat, -1])
        return (KIND_RECT, len(self._rect) - 1)

    def add_rect_xy(self, x0, x1, y0, y1, z, mat: int, flip_normal=False):
        """(reference: src/shape.cc:76-81)"""
        return self.add_rect((x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z),
                             mat, flip_normal)

    def add_rect_xz(self, x0, x1, z0, z1, y, mat: int, flip_normal=False):
        """(reference: src/shape.cc:83-88)"""
        return self.add_rect((x0, y, z0), (x0, y, z1), (x1, y, z1), (x1, y, z0),
                             mat, flip_normal)

    def add_rect_yz(self, y0, y1, z0, z1, x, mat: int, flip_normal=False):
        """(reference: src/shape.cc:90-95)"""
        return self.add_rect((x, y0, z0), (x, y1, z0), (x, y1, z1), (x, y0, z1),
                             mat, flip_normal)

    def add_disk(self, center, normal, radius: float, mat: int):
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        self._disk.append([np.asarray(center, np.float32), n, float(radius),
                           mat, -1])
        return (KIND_DISK, len(self._disk) - 1)

    # -- lights -----------------------------------------------------------
    def _add_light(self, lm: LightMeta, c, pos=(0, 0, 0),
                   direction=(0, 0, 1)) -> int:
        self._lights.append((lm, np.asarray(c, np.float32),
                             np.asarray(pos, np.float32),
                             np.asarray(direction, np.float32)))
        return len(self._lights) - 1

    def add_point_light(self, pos, intensity) -> int:
        return self._add_light(LightMeta(LIGHT_POINT), intensity, pos=pos)

    def add_directional_light(self, direction, irradiance) -> int:
        d = np.asarray(direction, np.float64)
        return self._add_light(LightMeta(LIGHT_DIRECTIONAL), irradiance,
                               direction=d / np.linalg.norm(d))

    def add_env_light(self, radiance) -> int:
        return self._add_light(LightMeta(LIGHT_ENV), radiance)

    def add_area_light(self, shape_ref, radiance) -> int:
        """(reference: src/scene.cc:66-77 CreateAreaLight)"""
        kind, idx = shape_ref
        light_id = self._add_light(
            LightMeta(LIGHT_AREA, shape_kind=kind, shape_idx=idx), radiance)
        if kind == KIND_TRI:
            self._tri_lights[idx] = light_id
        else:
            store, col = {KIND_SPHERE: (self._sph, 3), KIND_RECT: (self._rect, 3),
                          KIND_DISK: (self._disk, 4)}[kind]
            store[idx][col] = light_id
        return light_id

    def add_area_light_mesh(self, shape_refs, radiance) -> list:
        return [self.add_area_light(r, radiance) for r in shape_refs]

    # -- build --------------------------------------------------------------
    def build(self, use_bvh: bool | None = None, bvh_leaf_size: int = 4,
              prune_black_nee: bool = True,
              ray_eps: float | None = None) -> Scene:
        """prune_black_nee marks lights of zero radiance static_black (NEE
        skips them, and their radiance loses its NEE gradient); ray_eps
        pins the spawn / shadow epsilon (default: RAY_EPS_REL of the scene's
        diameter)."""
        from .convert import pack_from_arrays

        if self.camera is None:
            raise ValueError("scene needs a camera")

        def stack(rows, i, shape, dtype=np.float32):
            if rows:
                return np.stack([np.asarray(r[i], dtype) for r in rows])
            return np.zeros((0,) + shape, dtype)

        def col(rows, i, dtype):
            return np.array([r[i] for r in rows], dtype)

        def cat(field, shape):
            if self._tri_blocks:
                return np.concatenate([b[field] for b in self._tri_blocks])
            return np.zeros((0,) + shape, np.float32)

        a = {}
        tri_p0, tri_p1, tri_p2 = cat("p0", (3,)), cat("p1", (3,)), cat("p2", (3,))
        tri_n, tri_uv = cat("n", (3,)), cat("uv", (3, 2))
        tri_mat = np.concatenate(
            [np.full(len(b["p0"]), b["mat"], np.int32) for b in self._tri_blocks]
            or [np.zeros(0, np.int32)])
        tri_light = np.full(self._tri_count, -1, np.int32)
        for gi, lid in self._tri_lights.items():
            tri_light[gi] = lid

        a["sph_c"] = stack(self._sph, 0, (3,))
        a["sph_r"] = col(self._sph, 1, np.float32)
        a["sph_mat"] = col(self._sph, 2, np.int32)
        a["sph_light"] = col(self._sph, 3, np.int32)
        a["rect_q"] = stack(self._rect, 0, (4, 3))
        a["rect_n"] = stack(self._rect, 1, (3,))
        a["rect_mat"] = col(self._rect, 2, np.int32)
        a["rect_light"] = col(self._rect, 3, np.int32)
        a["disk_c"] = stack(self._disk, 0, (3,))
        a["disk_n"] = stack(self._disk, 1, (3,))
        a["disk_r"] = col(self._disk, 2, np.float32)
        a["disk_mat"] = col(self._disk, 3, np.int32)
        a["disk_light"] = col(self._disk, 4, np.int32)
        a["mat_kind"] = col(self._mat, 0, np.int32)
        a["mat_c0"] = stack(self._mat, 1, (3,))
        a["mat_c1"] = stack(self._mat, 2, (3,))
        a["mat_s0"] = col(self._mat, 3, np.float32)
        a["mat_s1"] = col(self._mat, 4, np.float32)
        a["mat_remap"] = col(self._mat, 5, bool)
        a["mat_tex"] = col(self._mat, 6, np.int32)
        a["mat_mf"] = col(self._mat, 7, np.int32)
        # the texture table, images padded to the largest
        images = [t[4] for t in self._tex]
        th = max([im.shape[0] for im in images if im is not None] or [1])
        tw = max([im.shape[1] for im in images if im is not None] or [1])
        a["tex_kind"] = col(self._tex, 0, np.int32)
        a["tex_c0"] = stack(self._tex, 1, (3,))
        a["tex_c1"] = stack(self._tex, 2, (3,))
        a["tex_scale"] = col(self._tex, 3, np.float32)
        a["tex_image"] = np.zeros((len(images), th, tw, 3), np.float32)
        a["tex_wh"] = np.ones((len(images), 2), np.int32)
        for i, im in enumerate(images):
            if im is not None:
                a["tex_image"][i, :im.shape[0], :im.shape[1]] = im
                a["tex_wh"][i] = (im.shape[1], im.shape[0])
        a["light_c"] = stack(self._lights, 1, (3,))
        a["light_pos"] = stack(self._lights, 2, (3,))
        a["light_dir"] = stack(self._lights, 3, (3,))

        # world bounding sphere (reference: src/scene.cc:35-45)
        sph_c, sph_r = a["sph_c"], a["sph_r"]
        pts = [tri_p0, tri_p1, tri_p2, a["rect_q"].reshape(-1, 3), a["disk_c"]]
        if len(sph_c):
            pts += [sph_c - sph_r[:, None], sph_c + sph_r[:, None]]
        for fam in self._inst_meshes:
            lo = fam["tris"].reshape(-1, 3).min(0)
            hi = fam["tris"].reshape(-1, 3).max(0)
            for off, scale, _m, _l in fam["inst"]:
                pts.append(np.stack([lo * scale + off, hi * scale + off]))
        allpts = np.concatenate([p for p in pts if len(p)]
                                or [np.zeros((1, 3), np.float32)])
        bmin, bmax = allpts.min(0), allpts.max(0)
        center = 0.5 * (bmin + bmax)
        radius = float(np.linalg.norm(bmax - center))
        a["world_center"] = np.asarray(center, np.float32)
        a["world_radius"] = np.asarray(radius, np.float32)
        a["ray_eps"] = np.asarray(
            ray_eps if ray_eps is not None
            else max(float(2.0 * radius) * RAY_EPS_REL, 1e-30), np.float32)

        n_tri = self._tri_count
        if use_bvh is None:
            use_bvh = n_tri > 64
        pallas_bvh = False
        if use_bvh and n_tri:
            pallas_bvh = sweep_route(
                *_wide_leaf_counts(tri_p0, tri_p1, tri_p2))
            bvh, order = build_bvh(tri_p0, tri_p1, tri_p2,
                                   leaf_size=bvh_leaf_size)
            tri_p0, tri_p1, tri_p2 = tri_p0[order], tri_p1[order], tri_p2[order]
            tri_n, tri_mat = tri_n[order], tri_mat[order]
            tri_light, tri_uv = tri_light[order], tri_uv[order]
            # area lights on triangles follow the reorder
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            self._lights = [
                (LightMeta(LIGHT_AREA, KIND_TRI, int(inv[lm.shape_idx]))
                 if lm.kind == LIGHT_AREA and lm.shape_kind == KIND_TRI else lm,
                 c, p, d) for lm, c, p, d in self._lights]
            a["bvh_nodes"] = pack_node_table(bvh, len(order), bvh_leaf_size)
            a["bvh_tris"] = np.concatenate(
                [tri_p0, tri_p1 - tri_p0, tri_p2 - tri_p0], axis=1
            ).astype(np.float32)
        else:
            use_bvh = False
            a["bvh_nodes"] = np.zeros((0, 8), np.float32)
            a["bvh_tris"] = np.zeros((0, 9), np.float32)
        a.update(tri_p0=tri_p0, tri_p1=tri_p1, tri_p2=tri_p2, tri_n=tri_n,
                 tri_uv=tri_uv, tri_mat=tri_mat, tri_light=tri_light)

        fams = {k: [] for k in ("blas_nodes", "blas_tris", "blas_n", "blas_uv",
                                "inst_off", "inst_scale", "inst_mat",
                                "inst_light", "tlas_nodes", "inst_em_tris",
                                "inst_em_n")}
        pallas_blas = []
        inst_newpos = []   # per family: instance id -> row after the TLAS order
        for m in self._inst_meshes:
            rows = m["inst"]
            f_off = np.stack([r[0] for r in rows])
            f_scale = np.array([r[1] for r in rows], np.float32)
            f_mat = np.array([r[2] for r in rows], np.int32)
            f_light = np.array([r[3] for r in rows], np.int32)
            t0, t1, t2 = m["tris"][:, 0], m["tris"][:, 1], m["tris"][:, 2]
            blas, border = build_bvh(t0, t1, t2, leaf_size=bvh_leaf_size)
            t0, t1, t2 = t0[border], t1[border], t2[border]
            blas_nodes = pack_node_table(blas, len(border), bvh_leaf_size)
            # TLAS over instance world boxes (BLAS root box scaled + offset)
            ib_lo = blas_nodes[0, :3][None] * f_scale[:, None] + f_off
            ib_hi = blas_nodes[0, 3:6][None] * f_scale[:, None] + f_off
            tlas, torder = build_box_bvh(ib_lo, ib_hi, leaf_size=1)
            routed = False
            if len(rows) < MAX_SWEEP_INST:
                n_w, n_rows = _wide_leaf_counts(*m["tris"].transpose(1, 0, 2))
                n_w += wide_bvh.collapse_wide(tlas, 1)[0].shape[0]
                routed = sweep_route(n_w, n_rows, len(rows))
            pallas_blas.append(routed)
            fams["blas_nodes"].append(blas_nodes)
            fams["blas_tris"].append(np.concatenate(
                [t0, t1 - t0, t2 - t0], axis=1).astype(np.float32))
            fams["blas_n"].append(m["n"][border])
            fams["blas_uv"].append(m["uv"][border])
            fams["inst_off"].append(f_off[torder])
            fams["inst_scale"].append(f_scale[torder])
            fams["inst_mat"].append(f_mat[torder])
            fams["inst_light"].append(f_light[torder])
            fams["tlas_nodes"].append(pack_node_table(tlas, len(torder), 1))
            newpos = np.empty(len(torder), np.int64)
            newpos[np.asarray(torder)] = np.arange(len(torder))
            inst_newpos.append(newpos)
            # the raw mesh, one row per triangle, for emissive-instance
            # sampling (blas_tris pads leaves with duplicates)
            if (f_light >= 0).any():
                r0 = m["tris"][:, 0]
                fams["inst_em_tris"].append(np.concatenate(
                    [r0, m["tris"][:, 1] - r0, m["tris"][:, 2] - r0],
                    axis=1).astype(np.float32))
                fams["inst_em_n"].append(m["n"].astype(np.float32))
            else:
                fams["inst_em_tris"].append(np.zeros((0, 9), np.float32))
                fams["inst_em_n"].append(np.zeros((0, 3), np.float32))
        a.update({k: tuple(v) for k, v in fams.items()})

        present_lobes = tuple(sorted({lb for m in self._mat
                                      for lb in _LOBES_OF[m[0]]}))
        present_mf_kinds = tuple(sorted({m[7] for m in self._mat
                                         if m[0] in _MF_MATS}))
        light_metas = []
        for lm, c, _pos, _dir in self._lights:
            if prune_black_nee and float(np.abs(c).sum()) == 0.0:
                lm = dataclasses.replace(lm, static_black=True)
            if lm.kind == LIGHT_AREA and lm.shape_kind >= KIND_INST:
                mi = lm.shape_kind - KIND_INST
                lm = dataclasses.replace(
                    lm, shape_idx=int(inst_newpos[mi][lm.shape_idx]))
            light_metas.append(lm)
        meta = SceneMeta(
            name=self.name, n_tri=n_tri, n_sph=len(self._sph),
            n_rect=len(self._rect), n_disk=len(self._disk),
            n_mat=len(self._mat), lights=tuple(light_metas),
            use_bvh=bool(use_bvh), n_tex=len(self._tex),
            present_lobes=present_lobes, present_mf_kinds=present_mf_kinds,
            n_bvh_nodes=int(a["bvh_nodes"].shape[0]),
            n_bvh_tris=int(a["bvh_tris"].shape[0]),
            n_inst=tuple(len(s) for s in a["inst_scale"]),
            n_blas_nodes=tuple(int(x.shape[0]) for x in a["blas_nodes"]),
            n_blas_tris=tuple(int(x.shape[0]) for x in a["blas_tris"]),
            n_tlas_nodes=tuple(int(x.shape[0]) for x in a["tlas_nodes"]),
            pallas_bvh=pallas_bvh, pallas_blas=tuple(pallas_blas),
            n_groups_blas=(0,) * len(self._inst_meshes),
            bvh_leaf_size=bvh_leaf_size,
            blas_leaf_size=(bvh_leaf_size,) * len(self._inst_meshes))
        meta, pack = pack_from_arrays(meta, a)
        return Scene(meta=meta, pack=pack, camera=self.camera)
