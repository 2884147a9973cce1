"""A configuration's scene as the program's Scene: the configuration's
operations replayed on the program's public SceneBuilder, with every mesh
made in memory by the benchmark's own generator (reference/meshes.py), so
that the program and the reference are handed the same data.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .reference import meshes


def _material(b, op):
    kind = op["kind"]
    dist = op.get("distribution", "ggx")
    remap = bool(op.get("remap", False))
    if kind == "matte":
        return b.add_matte(op["color"])
    if kind == "mirror":
        return b.add_mirror(op["color"])
    if kind == "glass":
        return b.add_glass(op["eta"], op["kr"], op["kt"])
    if kind == "plastic":
        return b.add_plastic(op["kd"], op["ks"], op["roughness"], remap=remap,
                             distribution=dist)
    if kind == "metal":
        return b.add_metal(op["eta"], op["k"], op["urough"], op["vrough"],
                           remap=remap, distribution=dist)
    if kind == "roughglass":
        return b.add_roughglass(op["eta"], op["roughness"], op["kr"],
                                op["kt"], remap=remap, distribution=dist)
    if kind == "phong":
        return b.add_phong(op["ks"], op["exponent"])
    raise ValueError(f"unknown material kind {kind!r}")


def build(config: dict):
    """The program's Scene (jet_pbrt_tpu_torch.scene.builder.Scene) of a
    configuration, on the host."""
    from jet_pbrt_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder(config["name"])
    cam = config["camera"]
    b.set_camera(lookfrom=cam["lookfrom"], lookat=cam["lookat"],
                 vup=cam["vup"], vfov=cam["vfov"])
    mats = {}
    for op in config["scene"]:
        kind = op["op"]
        light = op.get("light")
        if kind == "material":
            mats[op["name"]] = _material(b, op)
        elif kind == "env_light":
            b.add_env_light(op["radiance"])
        elif kind == "point_light":
            b.add_point_light(op["position"], op["intensity"])
        elif kind == "directional_light":
            b.add_directional_light(op["direction"], op["irradiance"])
        elif kind in ("triangle", "quad"):
            pts = op["points"]
            groups = ([pts] if kind == "triangle"
                      else [(pts[0], pts[1], pts[2]), (pts[0], pts[2], pts[3])])
            refs = [b.add_triangle(*g, mats[op["material"]],
                                   flip_normal=op.get("flip_normal", False))
                    for g in groups]
            if light is not None:
                b.add_area_light_mesh(refs, light)
        elif kind in ("rect", "rect_xz", "sphere", "disk"):
            flip = op.get("flip_normal", False)
            m = mats[op["material"]]
            if kind == "rect":
                ref = b.add_rect(*op["points"], m, flip_normal=flip)
            elif kind == "rect_xz":
                ref = b.add_rect_xz(*op["x"], *op["z"], op["y"], m,
                                    flip_normal=flip)
            elif kind == "sphere":
                ref = b.add_sphere(op["center"], op["radius"], m)
            else:
                ref = b.add_disk(op["center"], op["normal"], op["radius"], m)
            if light is not None:
                b.add_area_light(ref, light)
        elif kind == "instanced_mesh":
            tris = np.asarray(meshes.make(op["mesh"]), np.float32)
            b.add_instanced_mesh(
                tris, [(i["offset"], float(i["scale"]), mats[i["material"]])
                       for i in op["instances"]],
                flip_normal=op.get("flip_normal", False),
                flip_handedness=op.get("flip_handedness", False))
        else:
            raise ValueError(f"unknown scene operation {kind!r}")
    build_opts = config.get("build", {})
    return b.build(use_bvh=build_opts.get("use_bvh"),
                   bvh_leaf_size=int(build_opts.get("bvh_leaf_size", 4)))


def with_view(scene, lookfrom, front):
    """The scene seen from another camera position and direction."""
    cam = dataclasses.replace(scene.camera, lookfrom=tuple(lookfrom),
                              front=tuple(front))
    return dataclasses.replace(scene, camera=cam)
