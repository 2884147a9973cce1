"""The port's textures against the JAX package's on the CPU: taps of every
kind (bit for bit for solid, checker and nearest, 1 ulp for bilinear) and
their texel gradients, hit UVs of every shape kind (within 1e-6, the
instanced BLAS on the port's plain wide walk against the reference's XLA
walk), and the three scenes of tests/test_texture.py rendered against the
reference's op-by-op render under the pixel gate of
tests/test_torch_render.py.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.diff import params as JP
from jet_pbrt_tpu.models import camera as jcam
from jet_pbrt_tpu.models import integrators as jint
from jet_pbrt_tpu.models import render as jrender
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import rng as jrng
from jet_pbrt_tpu.ops import texture as jtex
from jet_pbrt_tpu.scene import pack as jpack
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.diff import params as TP
from jet_pbrt_tpu_torch.models import camera as tcam
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import rng as trng
from jet_pbrt_tpu_torch.ops import texture as ttex
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_render import _pixels_off
from test_torch_scene import INSTANCES, _mesh
from test_torch_slice import _inputs

torch.set_num_threads(2)

# one table of every kind: solid, checker, a 3x5 nearest image and a 4x2
# bilinear one, padded to 4x5 as the builder pads them
KINDS = {"solid": 0, "checker": 1, "nearest": 2, "bilinear": 3}


def _tables(seed=0):
    rs = np.random.default_rng(seed)
    image = np.zeros((4, 4, 5, 3), np.float32)
    image[2, :3, :5] = rs.uniform(size=(3, 5, 3))
    image[3, :4, :2] = rs.uniform(size=(4, 2, 3))
    return dict(
        tex_kind=np.array([0, 1, 2, 3], np.int32),
        tex_c0=rs.uniform(size=(4, 3)).astype(np.float32),
        tex_c1=rs.uniform(size=(4, 3)).astype(np.float32),
        tex_scale=np.array([1.0, 3.7, 1.0, 1.0], np.float32),
        tex_image=image,
        tex_wh=np.array([[1, 1], [1, 1], [5, 3], [2, 4]], np.int32))


def _taps(kind, n=512, seed=1):
    """tex ids of one kind, uvs over [-0.3, 1.3] with the edges 0 and 1 and
    texel boundaries of both images, and world points for the checker."""
    rs = np.random.default_rng(seed)
    uv = rs.uniform(-0.3, 1.3, (n, 2))
    edges = np.array([0.0, 1.0, 0.2, 0.4, 0.25, 0.5, 0.75, 1 / 3, 2 / 3])
    uv[:81] = np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2)
    p = rs.uniform(-3, 3, (n, 3))
    tex_id = np.full(n, KINDS[kind], np.int32)
    return tex_id, uv.astype(np.float32), p.astype(np.float32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_texture_taps_match_reference(kind):
    tabs = _tables()
    tex_id, uv, p = _taps(kind)
    a = np.asarray(jtex.sample(
        types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in tabs.items()}),
        jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(p)))
    b = ttex.sample(
        types.SimpleNamespace(**{k: torch.from_numpy(v)
                                 for k, v in tabs.items()}),
        torch.from_numpy(tex_id), torch.from_numpy(uv),
        torch.from_numpy(p)).numpy()
    if kind == "bilinear":
        np.testing.assert_array_max_ulp(b, a, maxulp=1)
    else:
        np.testing.assert_array_equal(b, a)
    if kind == "checker":
        assert len({tuple(r) for r in b}) == 2


@pytest.mark.parametrize("kind", ["nearest", "bilinear"])
def test_texel_gradients_match_reference(kind):
    """d sum(w * tap) / d texels by autograd, against jax.vjp."""
    tabs = _tables()
    tex_id, uv, p = _taps(kind, seed=2)
    w = np.random.default_rng(3).uniform(size=(len(uv), 3)).astype(np.float32)

    def jf(image):
        pk = types.SimpleNamespace(**{**{k: jnp.asarray(v)
                                         for k, v in tabs.items()},
                                      "tex_image": image})
        return jnp.sum(jnp.asarray(w) * jtex.sample(
            pk, jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(p)))

    ga = np.asarray(jax.grad(jf)(jnp.asarray(tabs["tex_image"])))
    image = torch.from_numpy(tabs["tex_image"]).requires_grad_(True)
    pk = types.SimpleNamespace(**{**{k: torch.from_numpy(v)
                                     for k, v in tabs.items()},
                                  "tex_image": image})
    torch.sum(torch.from_numpy(w) * ttex.sample(
        pk, torch.from_numpy(tex_id), torch.from_numpy(uv),
        torch.from_numpy(p))).backward()
    gb = image.grad.numpy()
    assert np.abs(ga).sum() > 0
    np.testing.assert_allclose(gb, ga, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# hit UVs
# ---------------------------------------------------------------------------

def uv_scene(builder, kind):
    """One shape kind (with uvs where the kind takes them) under a camera,
    and one texture, so the scene computes hit UVs."""
    rs = np.random.default_rng(5)
    b = builder(f"uv-{kind}")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=50)
    b.add_env_light((0.3, 0.3, 0.3))
    m = b.add_matte((0.5, 0.5, 0.5), tex=b.add_checker_texture(
        (1, 0, 0), (0, 0, 1)))
    if kind in ("triangle", "triangle_bvh", "instanced"):
        t = 60 if kind == "triangle" else 300
        tris = _mesh(t=t, seed=7) * 2.5
        uvs = rs.uniform(-0.5, 1.5, (t, 3, 2)).astype(np.float32)
        if kind == "instanced":
            b.add_instanced_mesh(tris / 2.5, [((0, 0, 0), 2.0, m),
                                              ((2.0, 1.0, -1.0), 1.5, m)],
                                 uvs=uvs)
        else:
            b.add_mesh(tris, m, uvs=uvs)
        return b.build(use_bvh=kind == "triangle_bvh")
    if kind == "sphere":
        for c, r in (((0, 0, 0), 2.0), ((2.5, 1.5, 1.0), 1.0),
                     ((-2.0, -2.0, -1.0), 1.5)):
            b.add_sphere(c, r, m)
    elif kind == "rect":
        b.add_rect_xy(-3, 2, -2, 3, -1, m)
        b.add_rect_yz(-2, 2, -3, 1, 1.5, m)
        b.add_rect((-3, -3, 0), (0, -2.5, 1), (1, 0, 1.5), (-2, -0.5, 0.5), m)
    else:
        b.add_disk((0, 0, 0), (0.2, 0.3, 1.0), 2.5, m)
        b.add_disk((2, 2, 1), (-1.0, 0.5, 0.7), 1.0, m)
    return b.build(use_bvh=False)


UV_KINDS = ["triangle", "triangle_bvh", "instanced", "sphere", "rect", "disk"]


@pytest.mark.parametrize("kind", UV_KINDS)
def test_hit_uvs_match_reference(kind, monkeypatch):
    """The port's hit UVs against the reference's intersect on camera rays,
    within 1e-6 on every lane both hit on the same shape."""
    for name in ("intersect_bvh", "intersect_instances"):
        monkeypatch.setattr(jbvh, name, jax.jit(
            getattr(jbvh, name), static_argnames=("leaf_size", "any_hit")))
    js, ts = uv_scene(JBuilder, kind), uv_scene(TBuilder, kind)
    assert ts.meta.n_tex == js.meta.n_tex == 1
    o, d, _ = _inputs(js, 24, 9)
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    ha = jpack.intersect(js.meta, js.pack, *(jnp.asarray(x)
                                             for x in (o, d, tmin, tmax)))
    hb = tpack.intersect(ts.meta, ts.pack, *(torch.tensor(x)
                                             for x in (o, d, tmin, tmax)))
    va, vb = np.asarray(ha.valid), hb.valid.numpy()
    same = va & vb & (np.asarray(ha.mat_id) == hb.mat_id.numpy()) \
        & np.all(np.asarray(ha.normal) == hb.normal.numpy(), axis=1)
    assert (va == vb).mean() > 0.99 and same.sum() >= 40, same.sum()
    ua, ub = np.asarray(ha.uv)[same], hb.uv.numpy()[same]
    assert np.ptp(ub) > 0.5
    # the BVH walks round t differently from the reference's (a few ulp of
    # t move the hit point): 1e-6 where t is the same, 1e-4 elsewhere
    same_t = np.asarray(ha.t)[same] == hb.t.numpy()[same]
    assert same_t.mean() > 0.3, same_t.mean()
    np.testing.assert_allclose(ub[same_t], ua[same_t], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ub, ua, rtol=0, atol=1e-4)


def test_uvs_stay_zero_without_textures():
    """With no texture the scene computes no UVs (as the reference's static
    check)."""
    b = TBuilder("no-tex")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=50)
    b.add_sphere((0, 0, 0), 2.0, b.add_matte((0.5, 0.5, 0.5)))
    s = b.build()
    o, d, _ = _inputs(uv_scene(JBuilder, "sphere"), 8, 1)
    h = tpack.intersect(s.meta, s.pack, torch.from_numpy(o),
                        torch.from_numpy(d), torch.full((64,), 1e-3),
                        torch.full((64,), float("inf")))
    assert h.valid.any() and not h.uv.any()


# ---------------------------------------------------------------------------
# textured renders (the scenes of tests/test_texture.py)
# ---------------------------------------------------------------------------

def plane_scene(builder, make_tex):
    """Camera looking straight down at a unit-UV textured rect."""
    b = builder("tex")
    b.set_camera(lookfrom=(0, 5, 0.001), lookat=(0, 0, 0), vfov=40)
    m = b.add_matte((1.0, 1.0, 1.0), tex=make_tex(b))
    b.add_rect_xz(-2, 2, -2, 2, 0, m)
    b.add_point_light((0, 4, 0), (60.0, 60.0, 60.0))
    return b.build(use_bvh=False)


QUAD = np.array([[(1, 0, 0), (0, 1, 0)], [(0, 0, 1), (1, 1, 0)]], np.float32)
TEXTURED = {
    "checker": lambda b: b.add_checker_texture((1.0, 0.0, 0.0),
                                               (0.0, 0.0, 1.0), scale=3.0),
    "image_quadrants": lambda b: b.add_image_texture(QUAD),
    "solid": lambda b: b.add_solid_texture((0.25, 0.5, 0.75)),
}


@pytest.mark.parametrize("name", sorted(TEXTURED))
def test_textured_render_matches_reference(name):
    """render() of each textured scene against the reference's op-by-op
    render, 16^2 at 2 spp, depth 1: every pixel within rtol 1e-4 / atol 1e-5
    but at most 2, means within 1e-4 relative."""
    js = plane_scene(JBuilder, TEXTURED[name])
    ts = plane_scene(TBuilder, TEXTURED[name])
    with jax.disable_jit():
        a = np.asarray(jrender.render(js, 16, 16, spp=2, max_depth=1,
                                      clamp=False, seed=0))
    b = render(ts, 16, 16, spp=2, max_depth=1, clamp=False, seed=0,
               device="cpu").numpy()
    off = _pixels_off(b, a)
    assert off.sum() <= 2, int(off.sum())
    assert abs(b.mean() - a.mean()) <= 1e-4 * a.mean()
    assert np.isfinite(b).all() and b.mean() > 0.01


def textured_instances(builder):
    """tests/test_torch_scene.py's instanced scene with uvs on its BLAS and
    a bilinear image texture on one of its two materials."""
    rs = np.random.default_rng(21)
    tris = _mesh()
    b = builder("textured-instances")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=60)
    b.add_env_light((0.2, 0.3, 0.5))
    tex = b.add_image_texture(rs.uniform(0.2, 0.9, (3, 4, 3)).astype(
        np.float32), bilinear=True)
    mats = [b.add_matte((0.7, 0.3, 0.2), tex=tex), b.add_matte((0.2, 0.6, 0.3))]
    light = b.add_matte((0.6, 0.6, 0.6))
    b.add_area_light(b.add_rect_xz(-2, 2, -2, 2, 6, light, flip_normal=True),
                     (12.0, 12.0, 12.0))
    b.add_instanced_mesh(tris, [(off, s, mats[i % 2])
                                for i, (off, s) in enumerate(INSTANCES)],
                         uvs=rs.uniform(size=(len(tris), 3, 2)))
    return b.build()


def test_instanced_kernel_routed_gradient(monkeypatch):
    """d mean(L) / d (texels, albedo, emission) of one wave of li_path at
    depth 2 on a textured instanced scene: the port's wide route (its plain
    walk on the CPU; the texels reached through the BLAS's hit UVs) against
    the reference's XLA walk, op by op, at rtol 1e-3 wherever |g| > 1e-4."""
    monkeypatch.setattr(jbvh, "intersect_instances", jax.jit(
        jbvh.intersect_instances, static_argnames=("leaf_size", "any_hit")))
    js, ts = textured_instances(JBuilder), textured_instances(TBuilder)
    assert ts.meta.wide_blas == (True,) and ts.meta.n_tex == 1
    fields = ("tex_image", "mat_c0", "light_c")
    res = 8
    ids = np.arange(res * res, dtype=np.int32)
    xy = np.stack([ids % res, ids // res], -1).astype(np.float32)
    jk = jrng.lane_keys(0, jnp.int32(0), jnp.asarray(ids))
    tk = trng.lane_keys(0, 0, torch.from_numpy(ids))
    jo, jd = jcam.generate_rays(
        jcam.make_camera(js.camera.lookfrom, js.camera.front, js.camera.vup,
                         js.camera.vfov, (res, res)),
        jnp.asarray(xy) + jrng.camera_jitter(jk))
    to, td = tcam.generate_rays(
        tcam.make_camera(ts.camera.lookfrom, ts.camera.front, ts.camera.vup,
                         ts.camera.vfov, (res, res), device="cpu"),
        torch.from_numpy(xy) + trng.camera_jitter(tk))
    ga = jax.grad(lambda p: jnp.mean(jint.li_path(
        js.meta, JP.with_params(js.pack, p), jo, jd, jk, 2)))(
        JP.get_params(js.pack, fields))
    _, gb = TP.value_and_grad(lambda p: torch.mean(tint.li_path(
        ts.meta, TP.with_params(ts.pack, p), to, td, tk, 2)),
        TP.get_params(ts.pack, fields))
    for k in fields:
        a, b = np.asarray(ga[k]), gb[k].numpy()
        big = np.abs(a) > 1e-4
        assert big.sum() >= 3, k
        np.testing.assert_allclose(b[big], a[big], rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(b[~big], a[~big], rtol=0, atol=1e-7,
                                   err_msg=k)
