"""Generated assets: counterpart of jet_pbrt_tpu/scene/assets.py, vertex
for vertex and file for file. `python -m jet_pbrt_tpu_torch.scene.assets
[dir]` writes bunny.obj and cornellbox/*.obj (default dir: assets/).

The reference renderer's scenes load OBJ files its repo does not ship
(reference: src/main.cc:94), so the bunny is synthesised from UV-sphere
parts (body, head, ears, tail, feet) at the Stanford bunny's scale: about
0.16 units tall, a ~75-unit bunny under the scene's x500 scale.
"""
from __future__ import annotations

import numpy as np

from . import objio

BUNNY_TRIS = 70000      # the default target: ~66k triangles


def _uv_sphere(n_theta: int, n_phi: int) -> np.ndarray:
    """Unit-sphere triangle soup [T,3,3] from a lat-long grid, y up."""
    theta = np.linspace(0.0, np.pi, n_theta + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    tg, pg = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack([np.sin(tg) * np.cos(pg), np.cos(tg),
                    np.sin(tg) * np.sin(pg)], axis=-1)
    tris = []
    for i in range(n_theta):
        a, b = pts[i, :-1], pts[i + 1, :-1]
        c, d = pts[i + 1, 1:], pts[i, 1:]
        tris.append(np.stack([a, b, c], axis=1))
        tris.append(np.stack([a, c, d], axis=1))
    return np.concatenate(tris).astype(np.float32)


def _part(base: np.ndarray, scale, rotate_x: float = 0.0,
          translate=(0, 0, 0)) -> np.ndarray:
    t = base * np.asarray(scale, np.float32)
    if rotate_x:
        c, s = np.cos(rotate_x), np.sin(rotate_x)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        t = t @ rot.T
    return t + np.asarray(translate, np.float32)


def bunny_mesh(target_tris: int = BUNNY_TRIS) -> np.ndarray:
    """Bunny-like mesh [T,3,3], y up, facing +z, sitting on y = 0, with a
    triangle count near target_tris."""
    s = np.sqrt(target_tris / 70000.0)
    body = _uv_sphere(int(110 * s), int(150 * s))
    head = _uv_sphere(int(70 * s), int(90 * s))
    ear = _uv_sphere(int(40 * s), int(44 * s))
    foot = _uv_sphere(int(22 * s), int(28 * s))
    tail = _uv_sphere(int(22 * s), int(28 * s))
    return np.concatenate([
        _part(body, (0.055, 0.048, 0.068), translate=(0, 0.048, -0.01)),
        _part(head, (0.034, 0.034, 0.036), translate=(0, 0.095, 0.045)),
        _part(ear, (0.011, 0.042, 0.016), rotate_x=-0.35,
              translate=(-0.018, 0.142, 0.028)),
        _part(ear, (0.011, 0.042, 0.016), rotate_x=-0.35,
              translate=(0.018, 0.142, 0.028)),
        _part(tail, (0.016, 0.016, 0.016), translate=(0, 0.045, -0.075)),
        _part(foot, (0.018, 0.012, 0.028), translate=(-0.032, 0.012, 0.025)),
        _part(foot, (0.018, 0.012, 0.028), translate=(0.032, 0.012, 0.025)),
    ])


def generate_bunny_obj(path: str, target_tris: int = BUNNY_TRIS) -> int:
    """Write bunny_mesh(target_tris) to path; returns its triangle count."""
    mesh = bunny_mesh(target_tris)
    objio.save_obj(path, mesh)
    return len(mesh)


def generate_cornell_objs(dirpath: str) -> None:
    """The Cornell box's triangles as one OBJ per part (light.obj,
    floor.obj, ...), the file set the reference renderer loads
    (reference: src/main.cc:34-54)."""
    import os
    from .scenes import cornell_box

    os.makedirs(dirpath, exist_ok=True)
    pack = cornell_box(use_bvh=False).pack
    tris = np.stack([np.asarray(pack.tri_p0), np.asarray(pack.tri_p1),
                     np.asarray(pack.tri_p2)], axis=1)
    groups = {"light.obj": range(0, 2), "floor.obj": range(2, 4),
              "ceiling.obj": range(4, 6), "back.obj": range(6, 8),
              "left.obj": range(8, 10), "right.obj": range(10, 12),
              "shortbox.obj": range(12, 22), "tallbox.obj": range(22, 32)}
    for name, rows in groups.items():
        objio.save_obj(os.path.join(dirpath, name), tris[list(rows)])


if __name__ == "__main__":
    import os
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "..", "assets")
    os.makedirs(out, exist_ok=True)
    n = generate_bunny_obj(os.path.join(out, "bunny.obj"))
    print(f"wrote bunny.obj with {n} triangles")
    generate_cornell_objs(os.path.join(out, "cornellbox"))
    print("wrote cornellbox/*.obj")
