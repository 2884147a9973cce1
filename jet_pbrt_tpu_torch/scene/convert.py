"""Scene arrays -> the port's ScenePack, and a reference scene carried
across.

`pack_from_arrays` turns numpy arrays laid out like the reference's
ScenePack into tensors and builds each BVH mesh's traversal tables from its
row tables: the 8-wide tables from the skip-link rows (bvh_nodes,
blas_nodes, tlas_nodes; a row is bmin, bmax, miss link, leaf code =
leaf_first / leaf_size * 32 + count, ops/bvh.py pack_node_table, which is
enough to recover the binary BVH that `collapse_wide` takes), or the
cull-sweep tables from the triangle rows (bvh_tris, blas_tris).

`scene_from_arrays` takes a reference scene given as
`dataclasses.asdict(scene.meta)` plus `{field: np.asarray(value)}` of its
ScenePack (a per-family field may be a tuple of arrays or one stacked
array), and the camera.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import sweep_bvh, wide_bvh
from ..ops.bvh import unpack_node_table
from .pack import LightMeta, SceneMeta, ScenePack

FAMILY_FIELDS = ("blas_nodes", "blas_tris", "blas_n", "blas_uv", "inst_off",
                 "inst_scale", "inst_mat", "inst_light", "tlas_nodes",
                 "inst_em_tris", "inst_em_n")
# fields built here from the row tables rather than carried across
_TABLE_FIELDS = ("bvh_wide", "inst_wide", "bvh_sweep", "inst_sweep",
                 "bvh_s_root", "inst_s_root")


def pack_from_arrays(meta: SceneMeta, arrays: dict) -> tuple[SceneMeta, ScenePack]:
    """Tensors + one traversal layout per BVH mesh, by the route the meta
    names: the cull-sweep tables where meta.pallas_bvh / pallas_blas[mi]
    is set, else the 8-wide tables. Returns the meta with the routing
    fields (wide_*, pallas_*, n_groups_*) filled in from the tables."""
    def t(x):
        return torch.from_numpy(np.array(x))

    def rows(name, x):
        x = np.asarray(x)
        if not len(x):
            raise ValueError(f"{name} is empty; rebuild the scene on the CPU")
        return x

    soup = bool(meta.use_bvh and meta.n_tri)
    bvh_wide = bvh_sweep = None
    if soup and meta.pallas_bvh:
        bvh_sweep = sweep_bvh.sweep_tables(
            rows("the soup's triangle rows (bvh_tris)", arrays["bvh_tris"]))
    elif soup:
        bvh_wide = wide_bvh.wide_tables(
            unpack_node_table(rows("the soup's skip-link rows (bvh_nodes)",
                                   arrays["bvh_nodes"]), meta.bvh_leaf_size),
            np.asarray(arrays["bvh_tris"], np.float32), meta.bvh_leaf_size)
    inst_wide, inst_sweep = [], []
    for mi in range(len(meta.n_inst)):
        leaf = meta.blas_leaf_size[mi]
        tris = rows(f"family {mi}: the BLAS triangle rows",
                    arrays["blas_tris"][mi]).astype(np.float32)
        if meta.pallas_blas[mi]:
            inst_wide.append(None)
            inst_sweep.append(sweep_bvh.sweep_tables(
                tris, arrays["inst_off"][mi], arrays["inst_scale"][mi]))
            continue
        inst_sweep.append(None)
        inst_wide.append(wide_bvh.wide_tables_instanced(
            unpack_node_table(arrays["tlas_nodes"][mi], 1),
            unpack_node_table(rows(f"family {mi}: the BLAS skip-link rows",
                                   arrays["blas_nodes"][mi]), leaf),
            tris, arrays["inst_off"][mi], arrays["inst_scale"][mi], leaf))
    fields = {}
    for f in ScenePack._fields:
        if f in _TABLE_FIELDS:
            continue
        if f in FAMILY_FIELDS:
            fields[f] = tuple(t(x) for x in arrays[f])
        else:
            fields[f] = t(arrays[f])
    pack = ScenePack(
        bvh_wide=bvh_wide, inst_wide=tuple(inst_wide), bvh_sweep=bvh_sweep,
        inst_sweep=tuple(inst_sweep),
        bvh_s_root=torch.from_numpy(sweep_bvh.mesh_root_sphere(
            arrays["bvh_tris"])),
        inst_s_root=tuple(torch.from_numpy(sweep_bvh.mesh_root_sphere(x))
                          for x in arrays["blas_tris"]),
        **fields)
    meta = dataclasses.replace(
        meta, wide_bvh=bvh_wide is not None, pallas_bvh=bvh_sweep is not None,
        n_groups_bvh=bvh_sweep.n_groups if bvh_sweep is not None else 0,
        wide_blas=tuple(w is not None for w in inst_wide),
        pallas_blas=tuple(s is not None for s in inst_sweep),
        n_groups_blas=tuple(s.n_groups if s is not None else 0
                            for s in inst_sweep),
        wide_blas_root=tuple(w.blas_root if w is not None else 0
                             for w in inst_wide))
    return meta, pack


def scene_from_arrays(meta: dict, arrays: dict, camera):
    """A reference scene (asdict of its meta, numpy arrays of its pack) as the
    port's Scene. Its routing flags are carried across: a mesh the
    reference sends to the sweep (pallas_*) takes the port's sweep, any
    other BVH mesh the port's wide kernel. The reference's traversal tables
    are ignored; the port rebuilds its own from the row tables."""
    from .builder import CameraConfig, Scene

    m = dict(meta)
    m["lights"] = tuple(lt if isinstance(lt, LightMeta) else LightMeta(**lt)
                        for lt in m["lights"])
    for k, v in m.items():
        if isinstance(v, list):
            m[k] = tuple(v)
    names = {f.name for f in dataclasses.fields(SceneMeta)}
    port_meta = SceneMeta(**{k: v for k, v in m.items() if k in names})
    a = dict(arrays)
    for f in FAMILY_FIELDS:
        a[f] = tuple(np.asarray(x) for x in a[f])
    port_meta, pack = pack_from_arrays(port_meta, a)
    cam = CameraConfig(lookfrom=tuple(camera.lookfrom),
                       front=tuple(camera.front), vup=tuple(camera.vup),
                       vfov=float(camera.vfov))
    return Scene(meta=port_meta, pack=pack, camera=cam)
