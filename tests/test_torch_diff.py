"""The port's differentiable path against the JAX package's on the CPU:
`render_fn` images and gradients (albedo, roughness, emission, texels)
against jax.grad of the reference's `render_fn` run op by op
(`jax.disable_jit()`: jitted XLA contracts a * b + c into FMAs), the
port's own finite-difference check, no gradient on any traversal input,
and three steps of `fit` (tests/test_torch_texture.py holds a gradient
through an instanced, kernel-routed scene).

Tolerances: gradients within rtol 1e-3 wherever |g| > 1e-4 on the scenes
of tests/test_grad.py (max_depth <= 2), rtol 1e-2 on the Cornell box at
depth 5 (Russian roulette and the metal's lobes); images within rtol
1e-4 / atol 1e-5; fit losses within 1e-4 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.diff import params as JP
from jet_pbrt_tpu.models import render as jrender
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.diff import params as TP
from jet_pbrt_tpu_torch.diff.gradcheck import check_grads
from jet_pbrt_tpu_torch.models.render import render, render_fn
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_scene import _mesh

torch.set_num_threads(2)

SIZE = 8


def tiny_scene(builder):
    """Matte floor under an area light (tests/test_grad.py::tiny_scene)."""
    b = builder("grad")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    m = b.add_matte((0.5, 0.4, 0.3))
    b.add_rect_xz(-10, 10, -10, 10, 0, m)
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


def metal_scene(builder, roughness=0.25):
    """GGX metal floor under an area light (tests/test_grad.py)."""
    b = builder("grad-rough")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    m = b.add_metal((0.2, 0.92, 1.1), (3.9, 2.45, 2.14), roughness,
                    roughness, remap=False)
    b.add_rect_xz(-10, 10, -10, 10, 0, m)
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


def textured_scene(builder):
    """Matte floor whose Kd is a 2x2 bilinear image (tests/test_grad.py)."""
    b = builder("grad-tex")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    tex = b.add_image_texture(
        np.asarray([[[0.7, 0.3, 0.2], [0.3, 0.7, 0.2]],
                    [[0.2, 0.3, 0.7], [0.5, 0.5, 0.5]]], np.float32),
        bilinear=True)
    m = b.add_matte((1.0, 1.0, 1.0), tex=tex)
    b.add_rect_xz(-10, 10, -10, 10, 0, m)
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


# name: (scene, max_depth, fields, gradient rtol)
CASES = {
    "albedo": (tiny_scene, 2, ("mat_c0", "light_c"), 1e-3),
    "roughness": (metal_scene, 1, ("mat_s0",), 1e-3),
    "texels": (textured_scene, 1, ("tex_image",), 1e-3),
    "cornell": (lambda B: (jscenes if B is JBuilder else tscenes).cornell_box(),
                5, ("mat_c0", "mat_s0", "light_c"), 1e-2),
}
FIELD_CASES = [(c, f) for c, v in CASES.items() for f in v[2]]


def _mean_fn(fn, pack, mean, with_params):
    return lambda p: mean(fn(with_params(pack, p)))


@pytest.fixture(scope="module")
def grads():
    """{case: (reference image, reference grads, port image, port grads)}
    of the mean pixel, one sample of SIZE^2 per case."""
    out = {}
    for name, (scene, depth, fields, _) in CASES.items():
        jfn, jpk = jrender.render_fn(scene(JBuilder), SIZE, SIZE, 1, seed=0,
                                     max_depth=depth)
        with jax.disable_jit():
            img, vjp = jax.vjp(lambda p: jfn(JP.with_params(jpk, p)),
                               JP.get_params(jpk, fields))
            (g,) = vjp(jnp.full(img.shape, 1.0 / img.size, jnp.float32))
        fn, pk = render_fn(scene(TBuilder), SIZE, SIZE, 1, seed=0,
                           max_depth=depth, device="cpu")
        _, tg = TP.value_and_grad(
            _mean_fn(fn, pk, torch.mean, TP.with_params),
            TP.get_params(pk, fields))
        out[name] = (np.asarray(img), {k: np.asarray(v) for k, v in g.items()},
                     fn(pk).numpy(), {k: v.numpy() for k, v in tg.items()})
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_fn_forward_matches_reference(grads, case):
    a, _, b, _ = grads[case]
    assert b.shape == (SIZE, SIZE, 3) and a.mean() > 0.01
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,field", FIELD_CASES)
def test_gradients_match_reference(grads, case, field):
    _, ga, _, gb = grads[case]
    a, b = ga[field], gb[field]
    rtol = CASES[case][3]
    big = np.abs(a) > 1e-4
    assert big.any() and np.isfinite(b).all()
    np.testing.assert_allclose(b[big], a[big], rtol=rtol)
    np.testing.assert_allclose(b[~big], a[~big], rtol=0, atol=1e-4 * rtol)


def test_render_fn_equals_render_at_one_sample():
    """With one sample the float64 film of render() rounds back to the
    float32 sum of render_fn: the two images are equal bit for bit."""
    scene = tscenes.cornell_box()
    fn, pk = render_fn(scene, 8, 8, 1, seed=3, max_depth=5, device="cpu")
    assert torch.equal(fn(pk), render(scene, 8, 8, 1, seed=3, clamp=False,
                                      device="cpu"))


@pytest.mark.parametrize("case,field", [(c, f) for c, f in FIELD_CASES
                                        if c != "cornell"])
def test_check_grads(case, field):
    """The port's finite-difference check on the scenes of
    tests/test_grad.py: rtol 5e-2, and 2e-2 for emission, which enters
    linearly (eps 1e-2 there, as the reference's test)."""
    scene, depth, _, _ = CASES[case]
    fn, pk = render_fn(scene(TBuilder), 6, 6, 4, seed=0, max_depth=depth,
                       device="cpu")
    f = _mean_fn(fn, pk, torch.mean, TP.with_params)
    linear = field == "light_c"
    g, _ = check_grads(f, TP.get_params(pk, (field,)),
                       rtol=2e-2 if linear else 5e-2,
                       eps=1e-2 if linear else 1e-3)
    assert float(g[field].abs().sum()) > 1e-4


def test_emission_gradient_is_linear():
    """L is linear in light_c: the gradient's sum is the image mean per
    unit of emission (tests/test_grad.py::test_emission_gradient_is_linear)."""
    fn, pk = render_fn(tiny_scene(TBuilder), 8, 8, 4, seed=0, max_depth=2,
                       device="cpu")
    f = _mean_fn(fn, pk, torch.mean, TP.with_params)
    _, g = TP.value_and_grad(f, {"light_c": pk.light_c})
    with torch.no_grad():
        base = float(f({"light_c": torch.zeros_like(pk.light_c)}))
        lin = float(f({"light_c": torch.ones_like(pk.light_c)})) - base
    assert abs(float(g["light_c"].sum()) - lin) / lin < 1e-3


def test_traversal_inputs_carry_no_gradient(monkeypatch):
    """Every cast of a render_fn backward through a kernel-routed scene
    whose roughness and albedo require grad (the sampled directions depend
    on both): no ray, tmin or tmax handed to traversal requires grad."""
    seen = []
    inner = tpack._kind_hits

    def record(meta, pack, o, d, tmin, tmax, **kw):
        seen.append(any(x.requires_grad for x in (o, d, tmin, tmax)))
        return inner(meta, pack, o, d, tmin, tmax, **kw)

    monkeypatch.setattr(tpack, "_kind_hits", record)
    b = TBuilder("rough-instances")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=60)
    b.add_env_light((0.4, 0.4, 0.5))
    m = b.add_plastic((0.5, 0.3, 0.2), (0.4, 0.4, 0.4), 0.3)
    b.add_rect_xz(-6, 6, -6, 6, -3, b.add_metal((0.2, 0.9, 1.1),
                                                (3.9, 2.4, 2.1), 0.3, 0.3))
    b.add_instanced_mesh(_mesh(t=200),
                         [((0, 0, 0), 1.5, m), ((2.5, 0, 0), 1.0, m)])
    scene = b.build()
    assert scene.meta.kernel_routed
    fn, pk = render_fn(scene, 8, 8, 1, max_depth=3, device="cpu")
    _, g = TP.value_and_grad(_mean_fn(fn, pk, torch.mean, TP.with_params),
                             TP.get_params(pk, ("mat_c0", "mat_s0")))
    assert len(seen) > 6 and not any(seen)
    # both rows finite (a dielectric lane's conductor Fresnel no longer
    # turns its zero gradient into NaN), and both used
    assert torch.isfinite(g["mat_s0"]).all() and (g["mat_s0"] != 0).all()


def test_fit_three_steps_match_reference():
    """Three steps of fit from a wrong albedo: the port's losses equal the
    reference's (run op by op) within 1e-4 relative, and fall."""
    kw = dict(fields=("mat_c0",), steps=3, lr=4.0)
    jfn, jpk = jrender.render_fn(tiny_scene(JBuilder), SIZE, SIZE, 1, seed=0,
                                 max_depth=2)
    fn, pk = render_fn(tiny_scene(TBuilder), SIZE, SIZE, 1, seed=0,
                       max_depth=2, device="cpu")
    with jax.disable_jit():
        target = jfn(jpk)
        _, ja = JP.fit(jfn, jpk._replace(
            mat_c0=jpk.mat_c0.at[0].set(jnp.asarray([0.9, 0.1, 0.7]))),
            target, **kw)
    wrong = pk.mat_c0.clone()
    wrong[0] = torch.tensor([0.9, 0.1, 0.7])
    params, tb = TP.fit(fn, pk._replace(mat_c0=wrong), fn(pk).detach(), **kw)
    np.testing.assert_allclose(tb, ja, rtol=1e-4)
    assert tb[2] < tb[1] < tb[0]
    assert float(params["mat_c0"].min()) >= 0.0
