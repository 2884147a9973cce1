"""The port's sharded renderer (jet_pbrt_tpu_torch/parallel/render.py and
mesh.py) over a spawned 4-rank gloo world on the CPU, against the port's
single-card render_fn and the reference's jitted shard_map program on the
8-virtual-device mesh (4, 2) (tests/test_parallel.py).

Tolerances. A px-only mesh renders the same lanes with the same streams
and sums each pixel's samples in the same order as render_fn: bit for bit.
A mesh with an spp axis sums partial films, which reassociates the
per-pixel sum: atol 2e-4 (tests/test_parallel.py:38-39). Against the
reference: at most 10% of pixels may lie outside rtol 1e-4 / atol 1e-5 of
its jitted frame, and every pixel within its sharded-vs-single-chip gate,
atol 5e-3 / rtol 1e-3 (tests/test_parallel.py:52), except where the
reference's own op-by-op render misses that gate too. Its jitted program
contracts a * b + c into FMAs, which sends a few lanes down another path
(3 of 256 pixels of the 16^2 frame past that gate, 1 and 3 of 64 for the
stratified and debug samplers, on an x86 CPU), so the frame is also
held to the reference's op-by-op render (jax.disable_jit()), which the
port reproduces: every pixel within atol 5e-3 / rtol 1e-3, all but
LIBM_PIXELS within rtol 1e-4 / atol 1e-5, the mean within 1e-4 relative
(and the mean over the pixels the jit left in place within 1e-4 of the
jitted frame's).

The ranks run functions of this module, which imports JAX only inside the
reference fixture (spawned ranks must import no JAX).
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from jet_pbrt_tpu_torch.models.render import render_fn
from jet_pbrt_tpu_torch.parallel.mesh import make_mesh
from jet_pbrt_tpu_torch.parallel.render import build_sharded_render, \
    render_sharded
from jet_pbrt_tpu_torch.scene import scenes as tscenes

from test_torch_multihost import run_world

RTOL, ATOL = 1e-4, 1e-5
# pixels where torch's CPU libm (SLEEF) rounds a lane onto another path
# than XLA's does (2 of 256 of the Cornell 16^2 golden frame,
# tests/test_torch_render.py)
LIBM_PIXELS = 2
LAYOUTS = {(1, 1): [0], (2, 1): [0, 1], (4, 1): None, (2, 2): None,
           (1, 4): None}
# (width, height, spp, seed) of the frames held against the reference
FRAMES = {"random": (16, 16, 8, 5), "stratified": (8, 8, 4, 3),
          "debug": (8, 8, 4, 3)}


def _rank_render(rank, scene):
    """Every rank: mesh shapes, the layouts' frames (Cornell 16^2, 8 spp,
    seed 5), refused splits, and the stratified and debug samplers at
    (2, 2)."""
    out = {"shapes": [tuple(make_mesh(device="cpu").shape),
                      tuple(make_mesh(px=2, spp=2, device="cpu").shape)]}
    for bad in (dict(px=3), dict(spp=3), dict(px=2, spp=1)):
        with pytest.raises(ValueError, match="rank"):
            make_mesh(device="cpu", **bad)
    for shape, ranks in LAYOUTS.items():
        mesh = make_mesh(*shape, ranks=ranks, device="cpu")
        if mesh.get_coordinate() is not None:
            out[shape] = render_sharded(scene, 16, 16, 8, mesh, seed=5,
                                        clamp=False, device="cpu")
    mesh = make_mesh(px=2, spp=2, device="cpu")
    for kw in (dict(width=15, height=15, spp=4),
               dict(width=8, height=8, spp=3)):
        with pytest.raises(ValueError, match="split"):
            build_sharded_render(scene.meta, mesh, device="cpu", **kw)
    for sampler in ("stratified", "debug"):
        w, h, spp, seed = FRAMES[sampler]
        out[sampler] = render_sharded(scene, w, h, spp, mesh, seed=seed,
                                      clamp=False, sampler=sampler,
                                      device="cpu")
    return out


def _reference():
    """Per sampler, the reference's jitted (4, 2) frame and its op-by-op
    single-chip frame."""
    import jax
    from jet_pbrt_tpu.models.render import render as jrender
    from jet_pbrt_tpu.parallel.mesh import make_mesh as jmesh
    from jet_pbrt_tpu.parallel.render import render_sharded as jsharded
    from jet_pbrt_tpu.scene import scenes as jscenes

    js = jscenes.cornell_box(lambert_only=True, use_bvh=False)
    mesh = jmesh(px=4, spp=2)
    ref = {}
    for sampler, (w, h, spp, seed) in FRAMES.items():
        jit = jsharded(js, w, h, spp, mesh, seed=seed, clamp=False,
                       sampler=sampler)
        with jax.disable_jit():
            eager = jrender(js, w, h, spp=spp, seed=seed, clamp=False,
                            sampler=sampler)
        ref[sampler] = np.asarray(jit), np.asarray(eager)
    return ref


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, the reference's): the world runs while the
    reference compiles."""
    scene = tscenes.cornell_box(lambert_only=True, use_bvh=False)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _rank_render, 4, scene)
        ref = _reference()
        ranks = world.result()
    return ranks, ref


@pytest.fixture(scope="module")
def single():
    fn, pack = render_fn(tscenes.cornell_box(lambert_only=True,
                                             use_bvh=False),
                         16, 16, 8, seed=5, device="cpu")
    with torch.no_grad():
        return fn(pack)


def _off(a, b, rtol=RTOL, atol=ATOL):
    return ~np.all(np.isclose(a, b, rtol=rtol, atol=atol), axis=-1)


def test_mesh_shapes(runs):
    """make_mesh() puts every rank on px, (4, 1); px=2, spp=2 gives
    (2, 2); a shape that does not cover the ranks raises, and so does a
    frame or spp that does not split over the mesh (checked in every
    rank)."""
    for got in runs[0]:
        assert got["shapes"] == [(4, 1), (2, 2)]


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (4, 1)])
def test_px_layouts_equal_render_fn(runs, single, shape):
    for rank, got in enumerate(runs[0]):
        if LAYOUTS[shape] is None or rank in LAYOUTS[shape]:
            assert torch.equal(got[shape], single), (shape, rank)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_spp_layouts_within_psum_tolerance(runs, single, shape):
    a = runs[0][0][shape]
    for got in runs[0]:
        assert torch.equal(got[shape], a)
    np.testing.assert_allclose(a.numpy(), single.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("sampler", ["random", "stratified", "debug"])
def test_matches_reference(runs, sampler):
    """The port's (2, 2) frame against the reference's jitted (4, 2) frame
    and its op-by-op single-chip frame."""
    ranks, ref = runs
    jit, eager = ref[sampler]
    port = ranks[0][(2, 2) if sampler == "random" else sampler].numpy()
    for got in ranks:
        assert np.array_equal(got[(2, 2) if sampler == "random"
                                  else sampler].numpy(), port)
    off = _off(port, jit)
    moved = _off(eager, jit, 1e-3, 5e-3)
    print(f"{sampler}: {int(off.sum())} of {off.size} pixels outside rtol "
          f"{RTOL} / atol {ATOL} of the jitted frame; past atol 5e-3 / rtol "
          f"1e-3: port {int(_off(port, jit, 1e-3, 5e-3).sum())}, the "
          f"reference's op-by-op render {int(moved.sum())}; outside rtol "
          f"{RTOL} / atol {ATOL} of the op-by-op render "
          f"{int(_off(port, eager).sum())}")
    assert off.mean() <= 0.1, int(off.sum())
    assert not (_off(port, jit, 1e-3, 5e-3) & ~moved).any()
    assert _off(port, eager).sum() <= LIBM_PIXELS
    assert not _off(port, eager, 1e-3, 5e-3).any()
    assert abs(port.mean() - eager.mean()) <= 1e-4 * eager.mean()
    kept = port[~moved].mean(), jit[~moved].mean()
    assert abs(kept[0] - kept[1]) <= 1e-4 * kept[1]
    if sampler == "random":
        assert abs(port.mean() - jit.mean()) <= 1e-4 * jit.mean()
