"""Wavefront OBJ reading and writing on the host.

Counterpart of jet_pbrt_tpu/scene/objio.py (reference: src/shape.cc:23-68):
faces are fan-triangulated, loaded normals are dropped (shading recomputes
face normals from the winding), and missing texcoords come back as zeros.
The native parser takes over where native/libjetpbrt.so is built.
"""
from __future__ import annotations

import numpy as np

from ..utils.native import try_load_obj_native


def load_obj(path: str):
    """Parse an OBJ file -> (tris [T,3,3] float32, uvs [T,3,2] float32)."""
    native = try_load_obj_native(path)
    if native is not None:
        return native

    positions, texcoords, tri_pos, tri_uv = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                texcoords.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                for v in line.split()[1:]:
                    comp = v.split("/")
                    vi = int(comp[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = -1
                    if len(comp) > 1 and comp[1]:
                        t = int(comp[1])
                        ti = t - 1 if t > 0 else len(texcoords) + t
                    idx.append((vi, ti))
                for k in range(1, len(idx) - 1):   # fan triangulation
                    tri_pos.append((idx[0][0], idx[k][0], idx[k + 1][0]))
                    tri_uv.append((idx[0][1], idx[k][1], idx[k + 1][1]))

    pos = np.asarray(positions, np.float32)
    tris = (pos[np.asarray(tri_pos, np.int64)] if tri_pos
            else np.zeros((0, 3, 3), np.float32))
    if texcoords:
        tc = np.asarray(texcoords, np.float32)
        uv_idx = np.asarray(tri_uv, np.int64)
        uvs = np.where((uv_idx >= 0)[..., None],
                       tc[np.clip(uv_idx, 0, len(tc) - 1)], 0.0
                       ).astype(np.float32)
    else:
        uvs = np.zeros((len(tris), 3, 2), np.float32)
    return tris, uvs


def save_obj(path: str, tris: np.ndarray) -> None:
    """Write a triangle soup [T,3,3] as an OBJ, one vertex per corner."""
    with open(path, "w") as f:
        f.write(f"# jet_pbrt_tpu generated mesh: {len(tris)} triangles\n")
        for t in tris:
            for v in t:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for i in range(len(tris)):
            b = 3 * i
            f.write(f"f {b + 1} {b + 2} {b + 3}\n")
