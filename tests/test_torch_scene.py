"""The port's scene layer (jet_pbrt_tpu_torch/scene) against the JAX build:
the same builder calls give the same meta and bit-identical ScenePack
arrays, and a JAX scene carried across with `scene_from_arrays` gives the
port's own traversal tables."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from jet_pbrt_tpu.ops import wide_bvh as JW
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.ops import sweep_bvh as TS
from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder
from jet_pbrt_tpu_torch.scene.convert import scene_from_arrays
from jet_pbrt_tpu_torch.scene.pack import ScenePack

torch.set_num_threads(2)

# meta fields that name the traversal route: the reference's CPU build
# takes its XLA walk, the port sends these small meshes through the wide
# kernel (both leave the sweep's pallas_* fields unset)
ROUTING = {"wide_bvh", "wide_blas", "wide_blas_root"}
# the port's own traversal tables, which the reference's pack lays out
# differently
TABLES = ("bvh_wide", "inst_wide", "bvh_sweep", "inst_sweep")


def _mesh(t=400, seed=11):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return np.stack([v0, v0 + rng.uniform(-0.35, 0.35, (t, 3)),
                     v0 + rng.uniform(-0.35, 0.35, (t, 3))],
                    axis=1).astype(np.float32)


INSTANCES = [((0, 0, 0), 1.0), ((2.5, 0, 0), 1.8), ((0, 2.5, 0), 0.7),
             ((-2.5, -1, 1), 1.3)]


def instanced_scene(builder, instanced=True):
    """The small scene of tests/test_instancing.py."""
    tris = _mesh()
    b = builder("inst" if instanced else "flat")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=60)
    b.add_env_light((0.2, 0.3, 0.5))
    mats = [b.add_matte((0.7, 0.3, 0.2)), b.add_matte((0.2, 0.6, 0.3))]
    light = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-2, 2, -2, 2, 6, light, flip_normal=True)
    b.add_area_light(r, (12.0, 12.0, 12.0))
    placed = [(off, s, mats[i % 2]) for i, (off, s) in enumerate(INSTANCES)]
    if instanced:
        b.add_instanced_mesh(tris, placed)
    else:
        for off, s, m in placed:
            b.add_mesh(tris, m, offset=off, scale=s)
    return b.build(use_bvh=not instanced)


def emissive_scene(builder):
    """The instanced scene with two of its four instances emissive (the
    fourth entry of an instance is its radiance), a dim environment and
    the rect light."""
    tris = _mesh(t=160, seed=12)
    b = builder("emissive")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=60)
    b.add_env_light((0.05, 0.05, 0.08))
    mats = [b.add_matte((0.7, 0.3, 0.2)), b.add_matte((0.2, 0.6, 0.3))]
    light = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-2, 2, -2, 2, 6, light, flip_normal=True)
    b.add_area_light(r, (6.0, 6.0, 6.0))
    placed = [(off, s, mats[i % 2]) for i, (off, s) in enumerate(INSTANCES)]
    placed[1] += ((4.0, 3.0, 1.0),)
    placed[3] += ((1.0, 2.0, 5.0),)
    b.add_instanced_mesh(tris, placed)
    return b.build()


def materials_scene(builder):
    """Every builder call of the reference's that the port's first lacked:
    mirror, rough glass (GGX and Beckmann), Phong, Beckmann plastic and
    metal, textured matte and plastic, solid / checker / image textures
    (float and uint8 images of two sizes, padded to the larger),
    add_rect_xy / add_rect_yz, a triangle with uvs, and a build that keeps
    its black light and pins ray_eps."""
    rs = np.random.default_rng(13)
    b = builder("materials")
    b.set_camera(lookfrom=(0, 1, 6), lookat=(0, 0, 0), vfov=50)
    b.add_env_light((0.0, 0.0, 0.0))
    solid = b.add_solid_texture((0.2, 0.4, 0.6))
    checker = b.add_checker_texture((0.9, 0.1, 0.1), (0.1, 0.1, 0.9), 4.0)
    img = b.add_image_texture(rs.uniform(size=(3, 5, 3)).astype(np.float32),
                              bilinear=True)
    img8 = b.add_image_texture(rs.integers(0, 256, (4, 2, 3), dtype=np.uint8))
    mats = [b.add_matte((0.5, 0.5, 0.5), tex=checker),
            b.add_mirror((0.9, 0.8, 0.7)),
            b.add_roughglass(1.5, 0.3, remap=True, distribution="beckmann"),
            b.add_roughglass(1.33, 0.1, kr=(0.9, 0.9, 0.9), kt=(0.8, 0.9, 1)),
            b.add_phong((0.6, 0.6, 0.6), 20.0),
            b.add_plastic((0.3, 0.2, 0.1), (0.5, 0.5, 0.5), 0.2, tex=img,
                          distribution="beckmann"),
            b.add_metal((0.2, 0.9, 1.1), (3.9, 2.4, 2.1), 0.1, 0.3,
                        remap=True, distribution="beckmann"),
            b.add_matte((0.7, 0.7, 0.7), tex=img8),
            b.add_matte((1.0, 1.0, 1.0), tex=solid)]
    b.add_rect_xy(-3, 3, -1.5, 2.5, -2, mats[0])
    b.add_rect_yz(-1.5, 2.5, -2, 2, 3, mats[1], flip_normal=True)
    b.add_rect_xz(-3, 3, -2, 2, -1.5, mats[7])
    b.add_triangle((-2.5, -1, 0), (-0.5, -1, 0.5), (-1.5, 0.5, 0.2), mats[5],
                   uv=((0, 0), (1, 0), (0.5, 1)))
    for i, m in enumerate(mats[2:7]):
        b.add_sphere((-2 + i, -0.9 + 0.3 * (i % 2), 0.5 * (i % 3)), 0.45, m)
    light = b.add_rect_xz(-0.7, 0.7, -0.7, 0.7, 2.4, mats[8],
                          flip_normal=True)
    b.add_area_light(light, (6.0, 6.0, 6.0))
    return b.build(prune_black_nee=False, ray_eps=1e-3)


def _arrays(pack):
    """{field: numpy array or tuple of arrays} of a JAX ScenePack."""
    out = {}
    for f, v in zip(pack._fields, pack):
        out[f] = (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                  else np.asarray(v))
    return out


def _assert_same_scene(js, ts):
    jm, tm = dataclasses.asdict(js.meta), dataclasses.asdict(ts.meta)
    for k, v in jm.items():
        if k not in ROUTING:
            assert tm[k] == v, (k, tm[k], v)
    ja = _arrays(js.pack)
    for f in ScenePack._fields:
        if f in TABLES:
            continue
        tv = getattr(ts.pack, f)
        if isinstance(tv, tuple):
            assert len(tv) == len(ja[f]), f
            for x, y in zip(tv, ja[f]):
                np.testing.assert_array_equal(x.numpy(), y, err_msg=f)
        else:
            np.testing.assert_array_equal(tv.numpy(), ja[f], err_msg=f)
    assert js.camera.vfov == ts.camera.vfov
    np.testing.assert_array_equal(js.camera.front, ts.camera.front)


SCENES = {
    "cornell": lambda B, mod: mod.cornell_box(),
    "cornell_lambert_bvh": lambda B, mod: mod.cornell_box(lambert_only=True,
                                                          use_bvh=True),
    "instanced": lambda B, mod: instanced_scene(B, True),
    "flattened": lambda B, mod: instanced_scene(B, False),
    "emissive_instances": lambda B, mod: emissive_scene(B),
    "materials_textures": lambda B, mod: materials_scene(B),
}


@pytest.fixture(scope="module")
def built():
    return {k: (f(JBuilder, jscenes), f(TBuilder, tscenes))
            for k, f in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_builder_matches_reference(built, name):
    _assert_same_scene(*built[name])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_wide_tables_match_reference_collapse(built, name):
    """The port's wide tables hold the reference's collapse of the same
    binary BVH (bounds exactly, child codes as its push templates)."""
    js, ts = built[name]
    if ts.meta.wide_bvh:
        tb = ts.pack.bvh_wide
        jb, jm = JW.collapse_wide(_rows_to_bvh(js.pack.bvh_nodes,
                                               js.meta.bvh_leaf_size),
                                  js.meta.bvh_leaf_size)
        np.testing.assert_array_equal(tb.bounds.numpy(), jb)
        assert tb.blas_root == 0
    for mi, tb in enumerate(ts.pack.inst_wide):
        leaf = js.meta.blas_leaf_size[mi]
        tlas = _rows_to_bvh(js.pack.tlas_nodes[mi], 1)
        blas = _rows_to_bvh(js.pack.blas_nodes[mi], leaf)
        _, _, _, _, n_w, root = JW.wide_tables_instanced(
            tlas, blas, np.asarray(js.pack.blas_tris[mi]),
            np.asarray(js.pack.inst_off[mi]),
            np.asarray(js.pack.inst_scale[mi]), leaf)
        assert tb.bounds.shape[0] == n_w and tb.blas_root == root
        assert ts.meta.wide_blas_root[mi] == root
        np.testing.assert_array_equal(tb.tris.numpy(),
                                      np.asarray(js.pack.blas_tris[mi]))
    if not ts.meta.wide_bvh and not ts.pack.inst_wide:
        assert ts.pack.bvh_wide is None and not ts.meta.use_bvh


def _rows_to_bvh(nodes, leaf):
    from jet_pbrt_tpu_torch.ops.bvh import unpack_node_table
    return unpack_node_table(np.asarray(nodes), leaf)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_arrays(built, name):
    """A JAX scene carried across gives the same pack and wide tables as
    the port's own build."""
    js, ts = built[name]
    cs = scene_from_arrays(dataclasses.asdict(js.meta), _arrays(js.pack),
                           js.camera)
    assert cs.meta == ts.meta
    for f, x, y in zip(ScenePack._fields, cs.pack, ts.pack):
        if f in TABLES:
            xs = list(x) if isinstance(x, tuple) else [x]
            ys = list(y) if isinstance(y, tuple) else [y]
            assert len(xs) == len(ys), f
            for a, b in zip(xs, ys):
                assert type(a) is type(b), f
                if isinstance(a, TW.WideTables):
                    assert a.blas_root == b.blas_root and a.depth == b.depth
                if isinstance(a, (TW.WideTables, TS.SweepTables)):
                    for u, v in zip(a, b):
                        if isinstance(u, torch.Tensor):
                            assert torch.equal(u, v), f
                        else:
                            assert u == v, f
        elif x is None or y is None:
            assert x is None and y is None, f
        elif isinstance(x, tuple):
            assert all(torch.equal(u, v) for u, v in zip(x, y)), f
        else:
            assert torch.equal(x, y), f
    assert dataclasses.asdict(cs.camera) == dataclasses.asdict(ts.camera)


def test_pack_moves_between_devices(built):
    _, ts = built["instanced"]
    moved = ts.to("cpu")
    assert isinstance(moved.pack.inst_wide[0], TW.WideTables)
    assert moved.pack.inst_wide[0].blas_root == ts.pack.inst_wide[0].blas_root


@pytest.mark.parametrize("target", [2000, 70000])
def test_bunny_obj_matches_reference(tmp_path, target):
    """The port's generated bunny OBJ is the reference's, byte for byte,
    and the port's bunny_mesh is the reference's, bit for bit."""
    from jet_pbrt_tpu.scene import assets as jassets
    from jet_pbrt_tpu_torch.scene import assets as tassets
    np.testing.assert_array_equal(tassets.bunny_mesh(target),
                                  jassets.bunny_mesh(target))
    jp, tp = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    assert jassets.generate_bunny_obj(jp, target) == \
        tassets.generate_bunny_obj(tp, target)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()


OBJ_TEXT = {
    "positions": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3\nf 1 3 4\n",
    "quad_uvs_negative": ("v 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 0.25\n"
                          "vt 0 0\nvt 1 0\nvt 1 1\n"
                          "f -4/1 -3/2 -2/3 -1\nvn 0 0 1\n"
                          "f 1/1/1 3//1 4/3/1\n"),
}


@pytest.mark.parametrize("name", sorted(OBJ_TEXT))
def test_load_obj_matches_reference(tmp_path, name):
    """The port's OBJ reader gives the reference's triangles and texcoords
    (fan triangulation, negative indices, missing texcoords)."""
    from jet_pbrt_tpu.scene import objio as jobjio
    from jet_pbrt_tpu_torch.scene import objio as tobjio
    path = tmp_path / f"{name}.obj"
    path.write_text(OBJ_TEXT[name])
    (jt, ju), (tt, tu) = jobjio.load_obj(str(path)), tobjio.load_obj(str(path))
    assert tt.dtype == np.float32 and tu.dtype == np.float32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tu, ju)


def test_bunny_obj_generates_at_first_use(tmp_path, monkeypatch):
    """bunny_obj names assets/bunny.obj at the default target and
    assets/bunny_<n>.obj at another, writes each once, and bunny_scene
    generates a missing bunny_path at the default target as the reference
    does."""
    monkeypatch.setattr(tscenes, "ASSET_DIR", str(tmp_path / "assets"))
    calls = []
    real = tscenes.assets.generate_bunny_obj
    monkeypatch.setattr(tscenes.assets, "generate_bunny_obj",
                        lambda p, n: calls.append((p, n)) or real(p, 300))
    p = tscenes.bunny_obj(600)
    assert p == str(tmp_path / "assets" / "bunny_600.obj")
    assert tscenes.bunny_obj(600) == p
    assert tscenes.bunny_obj().endswith(os.path.join("assets", "bunny.obj"))
    given = str(tmp_path / "sub" / "mine.obj")
    tscenes.bunny_scene(bunny_path=given, instancing=False)
    assert calls == [(p, 600),
                     (str(tmp_path / "assets" / "bunny.obj"), 70000),
                     (given, 70000)]


def test_bunny_scene_signature_matches_reference():
    import inspect
    sig = lambda f: [(p.name, p.default) for p in
                     inspect.signature(f).parameters.values()]
    assert sig(tscenes.bunny_scene) == sig(jscenes.bunny_scene)


@pytest.mark.parametrize("instancing", [False, True],
                         ids=["soup", "instanced"])
def test_bunny_scene_from_obj_matches_reference(tmp_path, instancing):
    """bunny_scene(bunny_path=...) on a small generated OBJ: the soup
    (four flattened copies through add_mesh with their uvs) and the
    instanced family give the reference's row tables bit for bit."""
    from jet_pbrt_tpu.scene.assets import generate_bunny_obj
    path = str(tmp_path / "bunny.obj")
    generate_bunny_obj(path, 2000)
    js = jscenes.bunny_scene(bunny_path=path, instancing=instancing)
    ts = tscenes.bunny_scene(bunny_path=path, instancing=instancing)
    assert ts.meta.n_tri == js.meta.n_tri
    assert ts.meta.n_inst == js.meta.n_inst == ((4,) if instancing else ())
    fields = (("blas_tris", "blas_nodes", "blas_uv", "inst_off") if instancing
              else ("tri_p0", "tri_p1", "tri_p2", "tri_uv", "bvh_nodes",
                    "bvh_tris"))
    for f in fields:
        x, y = getattr(ts.pack, f), getattr(js.pack, f)
        xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        for u, v in zip(xs, ys):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v),
                                          err_msg=f)
    _assert_same_scene(js, ts)


def test_add_mesh_uvs_match_reference():
    """add_mesh(uvs=...) carries per-vertex texcoords through the BVH
    reorder as the reference's does."""
    tris = _mesh(t=300, seed=2)
    uvs = np.random.default_rng(2).uniform(size=(300, 3, 2)).astype(
        np.float32)
    built = []
    for builder in (JBuilder, TBuilder):
        b = builder("uvs")
        b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0))
        b.add_mesh(tris, b.add_matte((0.5, 0.5, 0.5)), flip_handedness=True,
                   offset=(1, 2, 3), scale=2.0, uvs=uvs)
        built.append(b.build(use_bvh=True))
    js, ts = built
    assert np.asarray(js.pack.tri_uv).any()
    _assert_same_scene(js, ts)


def test_materials_scene_tables(built):
    """The scene of every new builder call: its textures padded to the
    largest image, the black light kept, ray_eps pinned, Beckmann present."""
    from jet_pbrt_tpu_torch.ops import microfacet as tmf
    _, ts = built["materials_textures"]
    m, p = ts.meta, ts.pack
    assert m.n_tex == 4 and tuple(p.tex_image.shape) == (4, 4, 5, 3)
    assert p.tex_wh.tolist() == [[1, 1], [1, 1], [5, 3], [2, 4]]
    assert float(p.tex_image[3].max()) <= 1.0 and p.mat_tex.max() == 3
    assert not m.lights[0].static_black and float(p.ray_eps) == np.float32(1e-3)
    assert m.present_mf_kinds == (tmf.GGX, tmf.BECKMANN)


def test_image_texture_from_ppm_path(tmp_path):
    """add_image_texture(<.ppm path>) reads the file as the reference does
    (each package through its own read_ppm), and an unknown microfacet
    distribution raises in both."""
    from jet_pbrt_tpu_torch.utils.image import write_ppm
    path = str(tmp_path / "t.ppm")
    write_ppm(path, np.random.default_rng(1).uniform(size=(3, 4, 3)))
    built = []
    for builder in (JBuilder, TBuilder):
        b = builder("ppm")
        b.set_camera(lookfrom=(0, 0, 5), lookat=(0, 0, 0))
        b.add_rect_xy(-1, 1, -1, 1, 0, b.add_matte(
            (1, 1, 1), tex=b.add_image_texture(path)))
        with pytest.raises(ValueError, match="distribution"):
            b.add_metal((1, 1, 1), (1, 1, 1), 0.1, 0.1, distribution="phong")
        built.append(b.build())
    _assert_same_scene(*built)
    assert built[1].pack.tex_image.shape == (1, 3, 4, 3)
