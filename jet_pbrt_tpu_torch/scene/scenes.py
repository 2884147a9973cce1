"""Authored reference scenes: the Cornell box and the four-bunny garden.

PyTorch counterpart of jet_pbrt_tpu/scene/scenes.py (reference:
src/main.cc:13-111), with the same geometry, materials and lights. The
bunny mesh is a generated OBJ under assets/ (`bunny_obj`).
"""
from __future__ import annotations

import os

import numpy as np

from . import assets, objio
from .builder import Scene, SceneBuilder

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")

# Tungsten-style 3-term light radiance (reference: src/main.cc:35)
LIGHT_RADIANCE = (
    8.0 * np.array([0.747 + 0.058, 0.747 + 0.258, 0.747])
    + 15.6 * np.array([0.740 + 0.287, 0.740 + 0.160, 0.740])
    + 18.4 * np.array([0.737 + 0.642, 0.737 + 0.159, 0.737])
)


def _quad(b: SceneBuilder, q0, q1, q2, q3, mat, light_radiance=None):
    t1 = b.add_triangle(q0, q1, q2, mat)
    t2 = b.add_triangle(q0, q2, q3, mat)
    if light_radiance is not None:
        b.add_area_light_mesh([t1, t2], light_radiance)
    return [t1, t2]


def cornell_box(lambert_only: bool = False,
                use_bvh: bool | None = None) -> Scene:
    """The Cornell box (reference: src/main.cc:13-62); lambert_only swaps
    the golden metal tall box for white matte."""
    b = SceneBuilder("cornell_box_scene")
    b.set_camera(lookfrom=(278, 273, 960), lookat=(278, 273, 0),
                 vup=(0, 1, 0), vfov=60.0)
    b.add_env_light((0.0, 0.0, 0.0))
    red = b.add_matte((0.63, 0.065, 0.05))
    green = b.add_matte((0.14, 0.45, 0.091))
    white = b.add_matte((0.725, 0.71, 0.68))
    golden = white if lambert_only else b.add_metal(
        (0.18, 0.15, 0.81), (0.11, 0.11, 0.11), 0.2, 0.2, remap=False)
    mat_light = b.add_matte((0.65, 0.65, 0.65))

    _quad(b, (213, 548, 332.2), (213, 548, 227.2), (343, 548, 227.2),
          (343, 548, 332.2), mat_light, light_radiance=LIGHT_RADIANCE)
    _quad(b, (552.8, 0, 559.2), (0, 0, 559.2), (0, 0, 0), (549.6, 0, 0), white)
    _quad(b, (556, 548.8, 559.2), (556, 548.8, 0), (0, 548.8, 0),
          (0, 548.8, 559.2), white)
    _quad(b, (549.6, 0, 0), (0, 0, 0), (0, 548.8, 0), (556, 548.8, 0), white)
    _quad(b, (552.8, 0, 559.2), (549.6, 0, 0), (556, 548.8, 0),
          (556, 548.8, 559.2), red)
    _quad(b, (0, 0, 0), (0, 0, 559.2), (0, 548.8, 559.2), (0, 548.8, 0), green)
    # short block (white, front-right)
    _quad(b, (130, 165, 494.2), (82, 165, 334.2), (240, 165, 287.2),
          (290, 165, 445.2), white)
    _quad(b, (290, 0, 445.2), (290, 165, 445.2), (240, 165, 287.2),
          (240, 0, 287.2), white)
    _quad(b, (130, 0, 494.2), (130, 165, 494.2), (290, 165, 445.2),
          (290, 0, 445.2), white)
    _quad(b, (82, 0, 334.2), (82, 165, 334.2), (130, 165, 494.2),
          (130, 0, 494.2), white)
    _quad(b, (240, 0, 287.2), (240, 165, 287.2), (82, 165, 334.2),
          (82, 0, 334.2), white)
    # tall block (golden metal, mid-left)
    _quad(b, (423, 330, 312.2), (265, 330, 263.2), (314, 330, 103.2),
          (472, 330, 153.2), golden)
    _quad(b, (423, 0, 312.2), (423, 330, 312.2), (472, 330, 153.2),
          (472, 0, 153.2), golden)
    _quad(b, (472, 0, 153.2), (472, 330, 153.2), (314, 330, 103.2),
          (314, 0, 103.2), golden)
    _quad(b, (314, 0, 103.2), (314, 330, 103.2), (265, 330, 263.2),
          (265, 0, 263.2), golden)
    _quad(b, (265, 0, 263.2), (265, 330, 263.2), (423, 330, 312.2),
          (423, 0, 312.2), golden)
    return b.build(use_bvh=use_bvh)


def bunny_obj(target_tris: int = assets.BUNNY_TRIS,
              path: str | None = None) -> str:
    """Path of a generated bunny OBJ, written at first use (never
    committed): `path` if given, else assets/bunny.obj at the default
    target and assets/bunny_<target_tris>.obj at any other."""
    if path is None:
        name = ("bunny.obj" if target_tris == assets.BUNNY_TRIS
                else f"bunny_{target_tris}.obj")
        path = os.path.join(ASSET_DIR, name)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        assets.generate_bunny_obj(path, target_tris)
    return path


def bunny_scene(use_bvh: bool | None = None, bunny_path: str | None = None,
                instancing: bool = True, bvh_leaf_size: int = 4) -> Scene:
    """The four-bunny scene (reference: src/main.cc:64-111), with the
    reference package's parameters: a rect area light, a green floor, a
    constant blue environment and four copies of the mesh at bunny_path
    (default assets/bunny.obj; a missing file is generated at the default
    target). instancing=True shares one BLAS across the copies under a
    TLAS; instancing=False flattens them into one triangle soup with a
    single BVH."""
    bunny_tris, bunny_uvs = objio.load_obj(bunny_obj(path=bunny_path))

    b = SceneBuilder("bunny_scene")
    b.set_camera(lookfrom=(-300, 300, -300), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=60.0)
    b.add_env_light((0.1, 0.1, 0.5))
    red = b.add_matte((0.63, 0.065, 0.05))
    green = b.add_matte((0.14, 0.45, 0.091))
    mat_light = b.add_matte((0.65, 0.65, 0.65))
    plastic = b.add_plastic((0.35, 0.12, 0.48), (1 - 0.35, 1 - 0.12, 1 - 0.48),
                            0.1, remap=False)
    golden = b.add_metal((0.18, 0.15, 0.81), (0.11, 0.11, 0.11), 0.2, 0.2,
                         remap=False)
    glass = b.add_glass(1.5, (0.98, 0.98, 0.98), (0.98, 0.98, 0.98))

    light_rect = b.add_rect_xz(-100, 100, -100, 100, 350, mat_light,
                               flip_normal=True)
    b.add_area_light(light_rect, LIGHT_RADIANCE)
    b.add_rect_xz(-200, 200, -200, 200, 0, green)
    placements = [((0, 0, 0), red), ((-100, 0, -100), plastic),
                  ((0, 0, -100), golden), ((-100, 0, 0), glass)]
    if instancing:
        b.add_instanced_mesh(
            bunny_tris, [(offset, 500.0, mat) for offset, mat in placements],
            flip_normal=True, flip_handedness=True, uvs=bunny_uvs)
    else:
        for offset, mat in placements:
            b.add_mesh(bunny_tris, mat, flip_normal=True, flip_handedness=True,
                       offset=offset, scale=500.0, uvs=bunny_uvs)
    return b.build(use_bvh=use_bvh, bvh_leaf_size=bvh_leaf_size)


# the CLI's scene ids (reference: src/main.cc:113-163)
SCENES = {0: cornell_box, 1: bunny_scene}
