"""The port's main path end to end on the CPU: `li_path` against the JAX
package's on the same rays and the same injected uniforms [N, 6, S], a
`render()` smoke, and import hygiene (the port never imports JAX).

Tolerances: the Cornell box is traced by brute force on both sides, and
every lane must agree at rtol 1e-4 / atol 1e-5 (op-by-op float32 on both
sides; libm differences in sin/cos/pow reach the image only through
continuous weights). The instanced scene goes through the port's 8-wide
walk against the reference's XLA skip-link walk, whose accept rule rounds
differently on edge grazes and which breaks distance ties by visiting order:
a flipped hit sends a path elsewhere, so at least 99.5% of lanes must agree
at that tolerance and the image mean to 1e-4 relative.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.models import camera as jcam
from jet_pbrt_tpu.models import integrators as jint
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.models import camera as tcam
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_scene import instanced_scene

torch.set_num_threads(2)

DEPTH = 5
RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(scene, res, seed):
    """Camera rays through jittered pixels and uniforms [N, DEPTH+1, S]."""
    rs = np.random.default_rng(seed)
    cam = jcam.make_camera(scene.camera.lookfrom, scene.camera.front,
                           scene.camera.vup, scene.camera.vfov, (res, res))
    ids = np.arange(res * res)
    xy = np.stack([ids % res, ids // res], -1) + rs.uniform(size=(res * res, 2))
    o, d = jcam.generate_rays(cam, jnp.asarray(xy, jnp.float32))
    s = 4 + 2 * scene.meta.n_lights
    u = rs.uniform(size=(res * res, DEPTH + 1, s)).astype(np.float32)
    return np.asarray(o), np.asarray(d), u


def _both(js, ts, res, seed, nee=True):
    o, d, u = _inputs(js, res, seed)
    lj, sj = jint.li_path(js.meta, js.pack, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(u), DEPTH, nee=nee, with_stats=True)
    lt, st = tint.li_path(ts.meta, ts.pack, torch.tensor(o), torch.tensor(d),
                          torch.tensor(u), DEPTH, nee=nee, with_stats=True)
    return np.asarray(lj), lt.numpy(), sj, st


def _lane_ok(a, b):
    return np.all(np.isclose(b, a, rtol=RTOL, atol=ATOL), axis=1)


@pytest.mark.parametrize("variant", ["metal", "lambert", "no_nee"])
def test_li_path_cornell_every_lane(variant):
    """no_nee: emission credited at every bounce, the plain BSDF estimator
    the reference keeps as a cross-check of NEE."""
    js = jscenes.cornell_box(lambert_only=variant == "lambert")
    ts = tscenes.cornell_box(lambert_only=variant == "lambert")
    a, b, sj, st = _both(js, ts, 16, 3, nee=variant != "no_nee")
    assert np.isfinite(b).all() and a.mean() > 0.05
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    for k in ("rays_primary", "rays_bounce", "rays_shadow", "rays"):
        assert int(st[k]) == int(sj[k]), k


def test_li_path_instanced_scene(monkeypatch):
    # the reference's XLA walk, compiled once per mode: called eagerly it
    # recompiles its while loops on every call (same computation)
    monkeypatch.setattr(jbvh, "intersect_bvh", jax.jit(
        jbvh.intersect_bvh, static_argnames=("leaf_size", "any_hit")))
    js, ts = instanced_scene(JBuilder), instanced_scene(TBuilder)
    a, b, _, _ = _both(js, ts, 32, 4)
    ok = _lane_ok(a, b)
    print(f"instanced li_path: {int((~ok).sum())} of {len(ok)} lanes differ "
          "(BVH tie flips)")
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(b.mean() - a.mean()) <= 1e-4 * a.mean(), (a.mean(), b.mean())
    assert a.mean() > 0.01


def test_render_smoke():
    """16^2 render of the instanced scene through every layer: finite and
    non-negative."""
    img = render(instanced_scene(TBuilder), 16, 16, spp=1, seed=2, max_depth=3,
                 clamp=False, device="cpu")
    assert img.shape == (16, 16, 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert float(img.mean()) > 0.01


def test_render_independent_of_wave_size():
    """Uniforms are keyed by (seed, sample, pixel) alone and the film adds
    each sample in float64 in sample order, so any wave size gives the same
    image bit for bit; another seed gives another image."""
    scene = tscenes.cornell_box()
    img = render(scene, 10, 10, spp=3, seed=2, clamp=False, device="cpu")
    for chunk in (100, 37, 1000):
        assert torch.equal(
            render(scene, 10, 10, spp=3, seed=2, clamp=False, chunk=chunk,
                   device="cpu"), img), chunk
    assert not torch.equal(render(scene, 10, 10, spp=3, seed=3, clamp=False,
                                  device="cpu"), img)


def test_render_defaults_to_the_card(monkeypatch):
    """With no device, render and make_camera ask for the card; where there
    is none they raise and return no image: nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tscenes.cornell_box()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render(scene, 4, 4, spp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.make_camera(scene.camera.lookfrom, scene.camera.front,
                         scene.camera.vup, scene.camera.vfov, (4, 4))
    assert render(scene, 4, 4, spp=1, device="cpu").device.type == "cpu"


def test_port_never_imports_jax(tmp_path):
    """Every module of the port (diff/, ops/texture.py, parallel/ and
    entry.py among them),
    chip_smoke.py, sweep_ab.py, a render, a gradient of a textured
    render_fn and a bunny scene built from a generated OBJ import nothing
    of JAX and nothing of the JAX package."""
    obj = str(tmp_path / "bunny.obj")
    code = (
        "import importlib, pkgutil, sys\n"
        "import jet_pbrt_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "assert {'jet_pbrt_tpu_torch.diff.params',"
        " 'jet_pbrt_tpu_torch.diff.gradcheck',"
        " 'jet_pbrt_tpu_torch.ops.texture',"
        " 'jet_pbrt_tpu_torch.parallel.render',"
        " 'jet_pbrt_tpu_torch.parallel.multihost',"
        " 'jet_pbrt_tpu_torch.entry'} <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke, sweep_ab\n"
        "from jet_pbrt_tpu_torch.scene.scenes import bunny_obj, bunny_scene,"
        " cornell_box\n"
        "from jet_pbrt_tpu_torch.models.render import render, render_fn\n"
        "from jet_pbrt_tpu_torch.diff import params as P\n"
        "render(cornell_box(), 4, 4, spp=1, device='cpu')\n"
        "fn, pk = render_fn(chip_smoke.grad_scene('image'), 4, 4, 1,"
        " max_depth=1, device='cpu')\n"
        "P.value_and_grad(lambda q: fn(P.with_params(pk, q)).mean(),"
        " P.get_params(pk))\n"
        f"bunny_scene(bunny_path=bunny_obj(500, {obj!r}), instancing=False)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'jet_pbrt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


PORT_SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "jet_pbrt_tpu_torch"))
    for f in fs if f.endswith(".py")) + ["chip_smoke.py", "sweep_ab.py"]


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_port_source_names_no_jax_import(rel):
    """No import statement of the port or of chip_smoke.py, at module level
    or inside a function, names JAX or the JAX package: a lazy import would
    escape the import check above until its function runs."""
    import ast
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    named = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    named += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [m for m in named
           if m.split(".")[0] in ("jax", "jaxlib", "jet_pbrt_tpu")]
    assert not bad, f"{rel} imports {bad}"
