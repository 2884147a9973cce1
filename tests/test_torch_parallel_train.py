"""The port's distributed fit (jet_pbrt_tpu_torch/parallel/train.py) over a
spawned 4-rank gloo world on the CPU, against the reference's jitted
build_train_step on the 8-virtual-device mesh (4, 2)
(tests/test_parallel.py::test_sharded_grad_fit) and against
diff.params.value_and_grad of the single-card render_fn.

The scene is the reference's Lambertian Cornell box carried across with
scene/convert.py, 16^2, 4 spp, depth 2, lr 2.0, the white wall's albedo
(mat_c0[2]) set to (0.2, 0.9, 0.2). Tolerances: the first 3 losses within
1e-3 relative of the reference's op-by-op fit (jax.value_and_grad of its
single-chip render_fn under jax.disable_jit(): the sharded step computes
the same loss and gradient), and within 1e-3 relative plus the
reference's own jit-vs-op-by-op gap of its jitted (4, 2) step: XLA's jit
contracts a * b + c into FMAs, which sends a few lanes down another path
and moves its loss by about 2e-3 relative on an x86 CPU. After 25
steps the loss is below a tenth of the first and the albedo within 0.1 of
the scene's (tests/test_parallel.py:68-85). At (1, 1) the sharded loss and
gradient equal value_and_grad's within rtol 1e-6.

The ranks run functions of this module, which imports JAX only inside the
reference fixture (spawned ranks must import no JAX).
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from jet_pbrt_tpu_torch.diff import params as P
from jet_pbrt_tpu_torch.models.render import render_fn
from jet_pbrt_tpu_torch.parallel import train as T
from jet_pbrt_tpu_torch.parallel.mesh import make_mesh
from jet_pbrt_tpu_torch.parallel.render import build_sharded_render
from jet_pbrt_tpu_torch.scene.convert import scene_from_arrays

from test_torch_multihost import run_world

TRAIN = dict(fields=("mat_c0",), lr=2.0, max_depth=2)
ALBEDO = (0.725, 0.71, 0.68)
WRONG = (0.2, 0.9, 0.2)


def _rank_train(rank, scene, wrong):
    """Every rank: 25 steps at (2, 2), 3 at (4, 1); rank 0 also the loss
    and gradient at (1, 1) beside value_and_grad's."""
    out = {}
    pack = scene.pack
    for shape, steps in (((2, 2), 25), ((4, 1), 3)):
        mesh = make_mesh(*shape, device="cpu")
        step, init, render, cam = T.build_train_step(scene, mesh, 16, 16, 4,
                                                     device="cpu", **TRAIN)
        target = render.frame(pack, cam)
        params, losses = {"mat_c0": wrong}, []
        for _ in range(steps):
            params, loss = step(params, target)
            losses.append(float(loss))
        out[shape] = {"losses": losses, "fitted": params["mat_c0"],
                      "init": init()["mat_c0"]}
    mesh = make_mesh(1, 1, ranks=[0], device="cpu")
    if rank == 0:
        render = build_sharded_render(scene.meta, mesh, 16, 16, 4,
                                      max_depth=2, device="cpu")
        out["sharded"] = T.value_and_grad(render, pack, cam,
                                          {"mat_c0": wrong}, target)
        fn, pk = render_fn(scene, 16, 16, 4, max_depth=2, device="cpu")
        img = target.view(16, 16, 3)
        out["single"] = P.value_and_grad(
            lambda p: torch.mean((fn(P.with_params(pk, p)) - img) ** 2),
            {"mat_c0": wrong})
    return out


def _reference(js, wrong):
    """The first 3 losses of the reference's jitted (4, 2) step and of its
    op-by-op single-chip fit."""
    import jax
    import jax.numpy as jnp
    from jet_pbrt_tpu.diff import params as JP
    from jet_pbrt_tpu.models.render import render_fn as jrender_fn
    from jet_pbrt_tpu.parallel.mesh import make_mesh as jmesh
    from jet_pbrt_tpu.parallel.train import build_train_step as jtrain

    step, _, render, cam = jtrain(js, jmesh(px=4, spp=2), 16, 16, 4, **TRAIN)
    target = render(js.pack, cam)
    params, ref = {"mat_c0": jnp.asarray(wrong)}, {"jit": [], "eager": []}
    for _ in range(3):
        params, loss = step(params, target)
        ref["jit"].append(float(loss))
    fn, pack = jrender_fn(js, 16, 16, 4, max_depth=TRAIN["max_depth"])
    with jax.disable_jit():
        img = fn(pack)
        loss = jax.value_and_grad(
            lambda p: jnp.mean((fn(JP.with_params(pack, p)) - img) ** 2))
        params = {"mat_c0": jnp.asarray(wrong)}
        for _ in range(3):
            val, g = loss(params)
            params = {"mat_c0": jnp.maximum(
                params["mat_c0"] - TRAIN["lr"] * g["mat_c0"], 0.0)}
            ref["eager"].append(float(val))
    return ref


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, the reference's): the world runs while the
    reference compiles."""
    from jet_pbrt_tpu.scene import scenes as jscenes

    js = jscenes.cornell_box(lambert_only=True, use_bvh=False)
    wrong = np.array(js.pack.mat_c0)
    wrong[2] = WRONG
    scene = scene_from_arrays(
        dataclasses.asdict(js.meta),
        {f: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else np.asarray(v)) for f, v in zip(js.pack._fields, js.pack)},
        js.camera)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _rank_train, 4, scene,
                            torch.from_numpy(wrong))
        ref = _reference(js, wrong)
        ranks = world.result()
    return ranks, ref


def test_train_losses_match_reference(runs):
    ranks, ref = runs
    losses = np.array(ranks[0][(2, 2)]["losses"][:3])
    jit, eager = np.array(ref["jit"]), np.array(ref["eager"])
    print(f"first 3 losses: port (2, 2) {losses.tolist()}, the reference's "
          f"jitted (4, 2) {jit.tolist()}, its op-by-op fit {eager.tolist()}")
    np.testing.assert_allclose(losses, eager, rtol=1e-3)
    assert np.all(np.abs(losses - jit) <= 1e-3 * jit + np.abs(eager - jit))
    for got in ranks:
        assert got[(2, 2)]["losses"] == ranks[0][(2, 2)]["losses"]


def test_train_losses_independent_of_layout(runs):
    """(4, 1) and (2, 2) take the same steps up to the spp sum's
    reassociation."""
    ranks, _ = runs
    np.testing.assert_allclose(ranks[0][(4, 1)]["losses"],
                               ranks[0][(2, 2)]["losses"][:3], rtol=1e-5)


def test_train_fits_albedo(runs):
    """25 steps at (2, 2): the loss falls tenfold and the white wall's
    albedo returns near the scene's; init() gives the pack's own values;
    every rank holds the same parameters."""
    ranks, _ = runs
    got = ranks[0][(2, 2)]
    assert got["losses"][-1] < 0.1 * got["losses"][0]
    assert np.allclose(got["fitted"][2].numpy(), ALBEDO, atol=0.1)
    assert np.allclose(got["init"][2].numpy(), ALBEDO)
    for other in ranks:
        assert torch.equal(other[(2, 2)]["fitted"], got["fitted"])


def test_train_gradient_equals_value_and_grad(runs):
    """At (1, 1) the sharded step's loss and gradient are the single-card
    ones of mean((render_fn(pack) - target)^2)."""
    (loss, g), (loss1, g1) = runs[0][0]["sharded"], runs[0][0]["single"]
    assert loss.dim() == 0 and loss1.dim() == 0
    loss, loss1 = float(loss), float(loss1)
    assert abs(loss - loss1) <= 1e-6 * loss1
    assert float(g["mat_c0"].abs().max()) > 0
    np.testing.assert_allclose(g["mat_c0"].numpy(), g1["mat_c0"].numpy(),
                               rtol=1e-6)
