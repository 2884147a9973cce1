"""The port's render path against the JAX package's on the CPU: the
exact-seed Cornell render and its golden, the float64 film, the Whitted,
debug-normal and MIS path integrators (injected uniforms and real keys),
`pdf_li` per light kind, an emissive-instance scene under MIS, and
resumable renders with checkpoints either package can load.

Tolerances. Every lane of the Cornell box must agree at the slice tests'
rtol 1e-4 / atol 1e-5 (op-by-op float32 on both sides). Whole renders are
held to that at the pixel level only where a few lanes may take another
path: torch's CPU sin, cos, pow and sqrt (SLEEF) round some arguments
differently from XLA's, and where a one-ulp difference meets
an edge or a coin the lane's path changes (2 of 2,048 lane samples of the
16^2 8-spp golden frame). The golden itself was rendered by the reference
under jit, where XLA contracts a * b + c into fused multiply-adds: the
reference's own op-by-op render misses it on 24 of 256 pixels, and the
port must miss it on no other pixel than those and the few where its
libm differs.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.models import integrators as jint
from jet_pbrt_tpu.models import render as jrender
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import lights as jlights
from jet_pbrt_tpu.ops import rng as jrng
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu.utils import checkpoint as jckpt
from jet_pbrt_tpu_torch.models import film as tfilm
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import lights as tlights
from jet_pbrt_tpu_torch.ops import rng as trng
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder
from jet_pbrt_tpu_torch.utils import checkpoint as tckpt

from test_torch_scene import emissive_scene
from test_torch_slice import DEPTH, _inputs, _lane_ok

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cornell_smoke_16.npz")
GOLDEN_ARGS = dict(spp=8, seed=42, max_depth=5)


def _pixels_off(a, b):
    return ~np.all(np.isclose(a, b, rtol=RTOL, atol=ATOL), axis=-1)


@pytest.fixture(scope="module")
def golden_frames():
    """(golden, the reference's op-by-op render, the port's render) of the
    exact-seed Cornell 16^2 frame."""
    golden = np.load(GOLDEN)["img"]
    with jax.disable_jit():
        eager = np.asarray(jrender.render(jscenes.cornell_box(), 16, 16,
                                          **GOLDEN_ARGS))
    port = render(tscenes.cornell_box(), 16, 16, device="cpu",
                  **GOLDEN_ARGS).numpy()
    return golden, eager, port


def test_exact_seed_render_matches_reference(golden_frames):
    """The port's frame against the reference's, same seed, same film:
    at least 99% of pixels within rtol 1e-4 / atol 1e-5, the mean within
    1e-4 relative."""
    _, eager, port = golden_frames
    off = _pixels_off(port, eager)
    print(f"port vs reference: {int(off.sum())} of {off.size} pixels outside")
    assert off.mean() <= 0.01, int(off.sum())
    assert abs(port.mean() - eager.mean()) <= 1e-4 * eager.mean()


def test_exact_seed_golden(golden_frames):
    """Against tests/golden/cornell_smoke_16.npz: the port misses the
    golden's tolerance only on pixels where the reference's own op-by-op
    render misses it too or where the port and that render differ (libm),
    and its mean is within 1e-4 relative."""
    golden, eager, port = golden_frames
    off_port = _pixels_off(port, golden)
    off_eager = _pixels_off(eager, golden)
    print(f"outside the golden's tolerance: port {int(off_port.sum())}, "
          f"reference op by op {int(off_eager.sum())} of {off_port.size}")
    assert not (off_port & ~off_eager & ~_pixels_off(port, eager)).any()
    assert abs(port.mean() - golden.mean()) <= 1e-4 * golden.mean()


def test_film_float64_matches_reference_accumulation():
    """The same per-sample outputs, accumulated by the port's film and by
    the reference's render loop (float64 in sample order, mean, float32,
    clamp), are bit-identical."""
    rs = np.random.default_rng(3)
    h, w, spp = 5, 7, 64
    samples = (rs.exponential(0.3, (spp, h * w, 3))
               * (rs.uniform(size=(spp, h * w, 1)) < 0.9)).astype(np.float32)
    accum = np.zeros((h * w, 3), np.float64)
    for s in range(spp):
        accum += np.asarray(samples[s], np.float64)
    for clamp in (True, False):
        ref = (accum / spp).reshape(h, w, 3).astype(np.float32)
        if clamp:
            ref = np.clip(ref, 0.0, 1.0)
        film = tfilm.new_film(w, h, "cpu")
        for s in range(spp):
            # in two pixel ranges, as waves split a frame
            tfilm.add_samples(film, torch.from_numpy(samples[s][:13]), 0)
            tfilm.add_samples(film, torch.from_numpy(samples[s][13:]), 13)
        got = tfilm.finalize(film, spp, clamp)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# integrators
# ---------------------------------------------------------------------------

def _keys(n, seed=7, sample=2):
    pix = np.arange(n, dtype=np.int32)
    return (jrng.lane_keys(seed, jnp.int32(sample), jnp.asarray(pix)),
            trng.lane_keys(seed, sample, torch.from_numpy(pix)))


def _run(name, js, ts, o, d, uj, ut):
    if name == "debug":
        return (np.asarray(jint.li_debug_normal(js.meta, js.pack, o, d)),
                tint.li_debug_normal(ts.meta, ts.pack, torch.tensor(o),
                                     torch.tensor(d)).numpy())
    if name == "whitted":
        return (np.asarray(jint.li_whitted(js.meta, js.pack, o, d, uj,
                                           DEPTH)),
                tint.li_whitted(ts.meta, ts.pack, torch.tensor(o),
                                torch.tensor(d), ut, DEPTH).numpy())
    return (np.asarray(jint.li_path(js.meta, js.pack, o, d, uj, DEPTH,
                                    mis=True)),
            tint.li_path(ts.meta, ts.pack, torch.tensor(o), torch.tensor(d),
                         ut, DEPTH, mis=True).numpy())


@pytest.mark.parametrize("streams", ["injected", "keys"])
@pytest.mark.parametrize("name", ["whitted", "debug", "mis"])
def test_integrators_cornell_every_lane(name, streams):
    """Whitted, debug normals and li_path(mis=True) against the
    reference's on every lane of the Cornell box, on the slice test's rays
    and uniforms (tests/test_torch_slice.py, seed 3)."""
    js, ts = jscenes.cornell_box(), tscenes.cornell_box()
    o, d, u = _inputs(js, 16, 3)
    if streams == "keys":
        uj, ut = _keys(o.shape[0])
    else:
        uj, ut = jnp.asarray(u), torch.tensor(u)
    a, b = _run(name, js, ts, jnp.asarray(o), jnp.asarray(d), uj, ut)
    assert np.isfinite(b).all() and a.mean() > 0.01
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# pdf_li and emissive instances
# ---------------------------------------------------------------------------

def light_scene(builder):
    """One light of every kind pdf_li tells apart: env, sphere, triangle,
    rect, disk, an emissive instance, and a point light (delta)."""
    rs = np.random.default_rng(4)
    mesh = (rs.uniform(-1, 1, (40, 1, 3))
            + rs.uniform(-0.4, 0.4, (40, 3, 3))).astype(np.float32)
    b = builder("lights")
    b.set_camera(lookfrom=(0, 0, 12), lookat=(0, 0, 0), vfov=60)
    b.add_env_light((0.1, 0.2, 0.3))
    m = b.add_matte((0.5, 0.5, 0.5))
    b.add_area_light(b.add_sphere((0, 3, 0), 1.5, m), (3, 3, 3))
    b.add_area_light(b.add_triangle((-4, -1, -2), (-2, -1, -2), (-3, 1, -2),
                                    m), (2, 2, 2))
    b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, -3, m), (4, 4, 4))
    b.add_area_light(b.add_disk((3, 0, 0), (-1, 0.2, 0), 1.2, m), (1, 2, 3))
    b.add_instanced_mesh(mesh, [((0, -6, 0), 1.5, m, (5, 4, 3)),
                                ((5, 5, 0), 0.8, m)])
    b.add_point_light((0, 0, 5), (9, 9, 9))
    return b.build()


LIGHT_CASES = {"env": (0, None), "sphere_out": (1, None),
               "sphere_in": (1, (0.0, 3.0, 0.0)), "triangle": (2, None),
               "rect": (3, None), "disk": (4, None), "instance": (5, None),
               "point": (6, None)}
# a point on each light the aimed half of the directions goes to
AIM = {1: (0, 3, 0), 2: (-3, -0.4, -2), 3: (0, -3, 0), 4: (3, 0, 0),
       5: (0, -6, 0), 6: (0, 0, 5), 0: (0, 0, 0)}


@pytest.fixture(scope="module")
def light_scenes():
    return light_scene(JBuilder), light_scene(TBuilder)


@pytest.mark.parametrize("case", sorted(LIGHT_CASES))
def test_pdf_li_per_light_kind(light_scenes, case):
    js, ts = light_scenes
    li, origin = LIGHT_CASES[case]
    rs = np.random.default_rng(li + 20)
    n = 512
    if origin is None:
        p = rs.uniform(-2.5, 2.5, (n, 3))
        p[:, 1] -= 2.0      # below the sphere, outside it
    else:
        p = np.asarray(origin) + rs.uniform(-0.7, 0.7, (n, 3))
    aim = np.asarray(AIM[li]) + rs.normal(0, 0.6, (n, 3)) - p
    wi = np.where(np.arange(n)[:, None] % 2 == 0, aim, rs.normal(size=(n, 3)))
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    p, wi = p.astype(np.float32), wi.astype(np.float32)
    a = np.asarray(jlights.pdf_li(js.meta, js.pack, li, jnp.asarray(p),
                                  jnp.asarray(wi)))
    b = tlights.pdf_li(ts.meta, ts.pack, li, torch.from_numpy(p),
                       torch.from_numpy(wi)).numpy()
    if case == "point":
        assert not b.any()
    else:
        assert (b > 0).mean() > 0.1, case
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_sample_li_emissive_instance(light_scenes):
    js, ts = light_scenes
    rs = np.random.default_rng(31)
    p = rs.uniform(-3, 3, (512, 3)).astype(np.float32)
    u = rs.uniform(size=(512, 2)).astype(np.float32)
    a = jlights.sample_li(js.meta, js.pack, 5, jnp.asarray(p), jnp.asarray(u))
    b = tlights.sample_li(ts.meta, ts.pack, 5, torch.from_numpy(p),
                          torch.from_numpy(u))
    for f in a._fields:
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    assert (b.pdf > 0).all()


def test_emissive_instance_scene_under_mis(monkeypatch):
    """The emissive-instance scene through li_path(mis=True), the port's
    wide kernel route against the reference's XLA walk: at least 99.5% of
    lanes agree and the means within 1e-4 relative (the instanced slice
    test's gates)."""
    monkeypatch.setattr(jbvh, "intersect_bvh", jax.jit(
        jbvh.intersect_bvh, static_argnames=("leaf_size", "any_hit")))
    js, ts = emissive_scene(JBuilder), emissive_scene(TBuilder)
    o, d, u = _inputs(js, 32, 6)
    a = np.asarray(jint.li_path(js.meta, js.pack, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(u), DEPTH,
                                mis=True))
    b = tint.li_path(ts.meta, ts.pack, torch.tensor(o), torch.tensor(d),
                     torch.tensor(u), DEPTH, mis=True).numpy()
    ok = _lane_ok(a, b)
    print(f"emissive instances under MIS: {int((~ok).sum())} of {len(ok)} "
          "lanes differ")
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(b.mean() - a.mean()) <= 1e-4 * a.mean(), (a.mean(), b.mean())
    assert a.mean() > 0.01


# ---------------------------------------------------------------------------
# render options and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [dict(integrator="debug"),
                                  dict(integrator="whitted"),
                                  dict(sampler="stratified"),
                                  dict(sampler="debug"),
                                  dict(mis=True), dict(nee=False)])
def test_render_options_match_reference(opts):
    """render(integrator=, sampler=, mis=, nee=) against the reference's
    op-by-op render of the same options, 8^2 at 2 spp: every pixel within
    tolerance but at most 2 (libm ties), means within 1e-4 relative."""
    js, ts = jscenes.cornell_box(), tscenes.cornell_box()
    with jax.disable_jit():
        a = np.asarray(jrender.render(js, 8, 8, 2, seed=3, max_depth=3,
                                      **opts))
    b = render(ts, 8, 8, 2, seed=3, max_depth=3, device="cpu", **opts).numpy()
    off = _pixels_off(b, a)
    assert off.sum() <= 2, int(off.sum())
    assert abs(b.mean() - a.mean()) <= 1e-4 * max(a.mean(), 1e-3)
    assert np.isfinite(b).all() and b.mean() > 0.01


def test_render_resumable_bit_for_bit(tmp_path):
    """Stopped after half the samples (a checkpoint at 2 of 4) and resumed,
    the frame equals the uninterrupted one and render()'s bit for bit."""
    scene = tscenes.cornell_box()
    full = tckpt.render_resumable(scene, 10, 10, 4, str(tmp_path / "a.npz"),
                                  checkpoint_every=1, seed=5, device="cpu")
    path = str(tmp_path / "b.npz")
    tckpt.render_resumable(scene, 10, 10, 2, path, seed=5, device="cpu")
    assert tckpt.load_render_state(path)[1] == 2
    resumed = tckpt.render_resumable(scene, 10, 10, 4, path, seed=5,
                                     device="cpu")
    assert torch.equal(resumed, full)
    assert torch.equal(full, render(scene, 10, 10, 4, seed=5, device="cpu"))
    assert tckpt.load_render_state(path)[1] == 4
    with pytest.raises(ValueError, match="seed"):
        tckpt.render_resumable(scene, 10, 10, 4, path, seed=6, device="cpu")


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by either package loads in the other: same
    keys, same film values (the reference writes float32), same counters
    and parameters."""
    rs = np.random.default_rng(8)
    film = rs.uniform(size=(12, 3))
    params = {"albedo": rs.uniform(size=(3,)).astype(np.float32)}
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_render_state(tp, torch.from_numpy(film), 3, 11, params)
    jckpt.save_render_state(jp, film, 3, 11, params)
    f, w, s, p = jckpt.load_render_state(tp)
    np.testing.assert_array_equal(f, film)
    assert (w, s) == (3, 11)
    np.testing.assert_array_equal(p["albedo"], params["albedo"])
    f, w, s, p = tckpt.load_render_state(jp)
    np.testing.assert_array_equal(f, film.astype(np.float32))
    assert (w, s) == (3, 11)
    np.testing.assert_array_equal(p["albedo"], params["albedo"])
    with np.load(tp) as zt, np.load(jp) as zj:
        assert sorted(zt.files) == sorted(zj.files)


def test_resume_from_reference_checkpoint(tmp_path):
    """A checkpoint the reference's render_resumable wrote after 2 of 4
    samples, resumed by the port: the frame agrees with the port's
    uninterrupted one up to the reference's float32 film (and its
    libm), at the render tolerance."""
    js, ts = jscenes.cornell_box(), tscenes.cornell_box()
    path = str(tmp_path / "ref.npz")
    with jax.disable_jit():
        jckpt.render_resumable(js, 8, 8, 2, path, seed=4, max_depth=3)
    got = tckpt.render_resumable(ts, 8, 8, 4, path, seed=4, max_depth=3,
                                 device="cpu").numpy()
    want = render(ts, 8, 8, 4, seed=4, max_depth=3, device="cpu").numpy()
    off = _pixels_off(got, want)
    assert off.sum() <= 1, int(off.sum())
