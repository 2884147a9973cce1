"""Meshes a configuration names by generator, made in memory from their
parameters (nothing is written to disk).

`bunny_mesh` is a frozen copy of jet_pbrt_tpu_torch/scene/assets.py::
bunny_mesh at commit 77f45ea: the reference renderer's scene loads a bunny
OBJ its repository does not ship (src/main.cc:94), so the bunny is
synthesised from UV-sphere parts (body, head, ears, tail, feet) at the
Stanford bunny's scale, about 0.16 units tall (a ~75-unit bunny under the
scene's x500 scale), 56,336 triangles at the default target.
"""
from __future__ import annotations

import json

import numpy as np

BUNNY_TRIS = 70000


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


GENERATORS = {"bunny": lambda p: bunny_mesh(int(p.get("target_tris",
                                                       BUNNY_TRIS)))}


_MADE: dict = {}


def make(spec: dict) -> np.ndarray:
    """The [T, 3, 3] float32 mesh of a configuration's mesh entry
    ({"generator": name, ...its parameters}), made once a process: the
    program's scene and the reference's are handed the same array, which
    neither changes (both copy it)."""
    key = json.dumps(spec, sort_keys=True)
    if key not in _MADE:
        mesh = GENERATORS[spec["generator"]](spec)
        mesh.setflags(write=False)
        _MADE[key] = mesh
    return _MADE[key]
