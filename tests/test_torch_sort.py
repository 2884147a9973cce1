"""The port's ray sort (jet_pbrt_tpu_torch/ops/sort.py) against the JAX
package, and the sort's one promise: it never changes the estimate.

* Keys: `morton3`, `ray_sort_key`, `bvh_needed` and `shadow_sort_key` equal
  the reference's exactly on random inputs, and `torch.argsort(...,
  stable=True)` gives `jnp.argsort`'s permutation.
* `li_path` / `render` with sort_rays on and off give bit-identical images,
  on soup and instanced scenes, wide- and sweep-routed, with LaneKeys and
  with injected uniforms; `occluded` with and without its shadow sort
  gives identical bits.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.ops import sort as jsort
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import sort as tsort
from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_scene import instanced_scene
from test_torch_slice import DEPTH, _inputs

torch.set_num_threads(2)

N = 4096


def _random_rays(scene, seed):
    """Origins over the world box and a margin around it, random unit
    directions, a third of the lanes dead, finite and infinite tmax."""
    rng = np.random.default_rng(seed)
    c = np.asarray(scene.pack.world_center)
    r = float(np.asarray(scene.pack.world_radius))
    o = (c + rng.uniform(-1.3 * r, 1.3 * r, (N, 3))).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rng.uniform(size=N) > 0.33
    tmin = np.where(active, 1e-3, np.inf).astype(np.float32)
    tmax = np.where(active, np.where(rng.uniform(size=N) < 0.5, np.inf,
                                     rng.uniform(0.1, 3 * r, N)),
                    -1.0).astype(np.float32)
    return o, d, active, tmin, tmax


@pytest.fixture(scope="module", params=["instanced", "flattened"])
def scenes(request):
    inst = request.param == "instanced"
    return instanced_scene(JBuilder, inst), instanced_scene(TBuilder, inst)


def test_morton_matches_reference():
    q = np.random.default_rng(0).integers(0, 128, (N, 3)).astype(np.int32)
    np.testing.assert_array_equal(tsort.morton3(torch.from_numpy(q)).numpy(),
                                  np.asarray(jsort.morton3(jnp.asarray(q))))


def test_keys_match_reference(scenes):
    js, ts = scenes
    o, d, active, tmin, tmax = _random_rays(js, 1)
    J, T = jnp.asarray, torch.from_numpy
    need_j = np.asarray(jsort.bvh_needed(js.meta, js.pack, J(o), J(d),
                                         J(tmin), J(tmax)))
    need_t = tsort.bvh_needed(ts.meta, ts.pack, T(o), T(d), T(tmin),
                              T(tmax))
    np.testing.assert_array_equal(need_t.numpy(), need_j)
    assert 0 < need_j.sum() < active.sum()

    lo = js.pack.world_center - js.pack.world_radius
    inv = jnp.broadcast_to(1.0 / jnp.maximum(2.0 * js.pack.world_radius,
                                             1e-12), (3,))
    t_lo = ts.pack.world_center - ts.pack.world_radius
    t_inv = (1.0 / torch.clamp_min(2.0 * ts.pack.world_radius,
                                   1e-12)).expand(3)
    for needs in (None, need_j):
        kj = np.asarray(jsort.ray_sort_key(
            J(active), J(o), J(d), lo, inv,
            needs_bvh=None if needs is None else J(needs)))
        kt = tsort.ray_sort_key(
            T(active), T(o), T(d), t_lo, t_inv,
            needs_bvh=None if needs is None else T(np.array(needs)))
        np.testing.assert_array_equal(kt.numpy(), kj)
        assert kt.dtype == torch.int32
        # many equal keys: the stable permutations must agree
        assert len(np.unique(kj)) < N
        np.testing.assert_array_equal(
            torch.argsort(kt, stable=True).numpy(), np.asarray(jnp.argsort(kj)))

    alive = J(tmax > 0)
    kj = np.asarray(jsort.shadow_sort_key(js.meta, js.pack, alive, J(o),
                                          J(d), J(tmin), J(tmax)))
    kt = tsort.shadow_sort_key(ts.meta, ts.pack, T(tmax > 0), T(o), T(d),
                               T(tmin), T(tmax))
    np.testing.assert_array_equal(kt.numpy(), kj)
    np.testing.assert_array_equal(torch.argsort(kt, stable=True).numpy(),
                                  np.asarray(jnp.argsort(kj)))


def _sweep_routed(monkeypatch, instanced):
    monkeypatch.setattr(TW, "_VMEM_BUDGET", 1024)
    scene = instanced_scene(TBuilder, instanced)
    assert scene.meta.pallas_blas == ((True,) if instanced else ())
    assert scene.meta.pallas_bvh == (not instanced)
    return scene


@pytest.mark.parametrize("route", ["wide", "sweep"])
@pytest.mark.parametrize("instanced", [True, False],
                         ids=["instanced", "soup"])
def test_sort_changes_nothing(monkeypatch, instanced, route):
    scene = (_sweep_routed(monkeypatch, instanced) if route == "sweep"
             else instanced_scene(TBuilder, instanced))
    assert scene.meta.kernel_routed
    on, st_on = render(scene, 16, 16, spp=2, seed=5, max_depth=DEPTH,
                       clamp=False, with_stats=True, device="cpu")
    off, st_off = render(scene, 16, 16, spp=2, seed=5, max_depth=DEPTH,
                         clamp=False, with_stats=True, sort_rays=False,
                         device="cpu")
    assert torch.equal(on, off)
    assert st_on["rays"] == st_off["rays"] and st_on["rays"] > 0
    assert float(on.mean()) > 0.01


def test_sort_changes_nothing_with_injected_uniforms(monkeypatch):
    scene = _sweep_routed(monkeypatch, True)
    o, d, u = _inputs(scene, 16, 8)
    args = (scene.meta, scene.pack, torch.tensor(o), torch.tensor(d),
            torch.tensor(u), DEPTH)
    a = tint.li_path(*args, sort_rays=True)
    b = tint.li_path(*args, sort_rays=False)
    assert torch.equal(a, b) and float(a.mean()) > 0.01


@pytest.mark.parametrize("instanced", [True, False], ids=["instanced", "soup"])
def test_shadow_sort_changes_nothing(instanced):
    scene = instanced_scene(TBuilder, instanced)
    rng = np.random.default_rng(6)
    p_from = torch.from_numpy(rng.uniform(-4, 4, (N, 3)).astype(np.float32))
    p_to = torch.from_numpy(rng.uniform(-4, 4, (N, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=N) > 0.3)
    a = tpack.occluded(scene.meta, scene.pack, p_from, p_to, mask, sort=True)
    b = tpack.occluded(scene.meta, scene.pack, p_from, p_to, mask, sort=False)
    assert torch.equal(a, b) and 0 < int(a.sum()) < N
    assert not a[~mask].any()
