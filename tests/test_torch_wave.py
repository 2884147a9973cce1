"""The wave's glue (ops/wave.py) against the JAX package on the CPU.

On CPU tensors each wrapper runs its plain version, the torch code the
kernels of csrc/wave.cu replace, and these tests hold it against the
reference's code on the same seeded numpy inputs:

- camera_rays: the film position of each pixel id with its jitter and the
  camera ray through it (jet_pbrt_tpu/models/render.py:34-42,
  models/camera.py:56-70) under the random, stratified and debug
  samplers' jitter, and li_path's initial state;
- permute_state: the reference's one gather of the state packed as [N, 19]
  (models/integrators.py:259-285), with the stream keys or the debug
  sampler's uniforms, on the identity, a reversal and a seeded perm;
- unsort_guard: L[argsort(lane)] and the invalid-sample guard
  (integrators.py:288-292), with NaN and inf lanes;
- li_path as a whole with its lanes sorted between bounces, on the Cornell
  box and on the instanced scene of tests/test_torch_scene.py, against
  the reference called eagerly, and its ray counts;
- the wrappers' input checks, and slab rows written in place by the casts
  (scene/pack.py::_kind_hits, occluded's out).

Tolerances: the camera's o and d rtol 1e-6 / atol 1e-7 (the same float32
operations op by op on both sides); the permute and the un-sort exactly (a
gather copies bits); li_path every lane of the Cornell box within rtol
1e-4 / atol 1e-5 and the counts exactly (tests/test_torch_slice.py's), and
on the instanced scene 99.5% of lanes within that and the mean within
1e-4 relative (test_li_path_instanced_scene's: BVH tie flips).
"""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.models import camera as jcam
from jet_pbrt_tpu.models import integrators as jint
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import rng as jrng
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.models import camera as tcam
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.ops import kernels
from jet_pbrt_tpu_torch.ops import rng as trng
from jet_pbrt_tpu_torch.ops import wave as W
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_scene import instanced_scene

torch.set_num_threads(2)

CAM_RTOL, CAM_ATOL = 1e-6, 1e-7
RTOL, ATOL = 1e-4, 1e-5
DEPTH = 5


def _cameras(scene, w, h):
    args = (scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
            scene.camera.vfov, (w, h))
    return jcam.make_camera(*args), tcam.make_camera(*args, device="cpu")


def _reference_camera(jc, ids, width, jitter):
    """jet_pbrt_tpu/models/render.py:39-41's film position and the
    reference's generate_rays."""
    x = (ids % width).astype(jnp.float32) + jitter[:, 0]
    y = (ids // width).astype(jnp.float32) + jitter[:, 1]
    return jcam.generate_rays(jc, jnp.stack([x, y], axis=-1))


@pytest.mark.parametrize("sampler", ["random", "stratified", "debug"])
def test_camera_rays_matches_reference(sampler):
    """Each sampler's jitter (the reference's draw on its keys; the port's
    equals it, tests/test_torch_rng.py) through the port's camera_rays and
    the reference's film position and generate_rays, on a 24 x 17 film
    with pixel ids past one row; the initial state as li_path made it."""
    w, h, spp = 24, 17, 5
    js = jscenes.cornell_box()
    jc, tc = _cameras(js, w, h)
    ids = np.arange(w * h, dtype=np.int32)
    sample = 3
    keys = jrng.lane_keys(11, jnp.int32(sample), jnp.asarray(ids))
    jitter = jrng.camera_jitter(keys, sampler=sampler,
                                sample_index=jnp.full(ids.shape, sample),
                                spp=spp)
    o_ref, d_ref = _reference_camera(jc, jnp.asarray(ids), w, jitter)
    eps = torch.tensor(1e-4, dtype=torch.float32)
    got = W.camera_rays(tc, torch.from_numpy(ids.astype(np.int64)), w,
                        torch.from_numpy(np.array(jitter)), eps)
    np.testing.assert_allclose(got.ray_o.numpy(), np.asarray(o_ref),
                               rtol=CAM_RTOL, atol=CAM_ATOL)
    np.testing.assert_allclose(got.ray_d.numpy(), np.asarray(d_ref),
                               rtol=CAM_RTOL, atol=CAM_ATOL)
    n = w * h
    assert torch.equal(got.L, torch.zeros((n, 3)))
    assert torch.equal(got.beta, torch.ones((n, 3)))
    assert got.active.all() and not got.prev_specular.any()
    assert torch.equal(got.prev_pdf, torch.zeros(n))
    assert torch.equal(got.lane, torch.arange(n))
    assert torch.equal(got.tmin, eps.expand(n))
    assert torch.isinf(got.tmax).all() and (got.tmax > 0).all()
    assert got.counts.dtype == torch.int64 and not got.counts.any()


def zlib_seed(*parts) -> int:
    return zlib.crc32(" ".join(parts).encode())


def _state(rs, n: int) -> W.WaveState:
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32))
    return W.WaveState(
        L=f(n, 3), beta=f(n, 3),
        active=torch.from_numpy(rs.uniform(size=n) < 0.6),
        prev_specular=torch.from_numpy(rs.uniform(size=n) < 0.3),
        prev_pdf=f(n), ray_o=f(n, 3), ray_d=f(n, 3),
        lane=torch.from_numpy(rs.permutation(n).astype(np.int64)),
        tmin=f(n), tmax=f(n), counts=torch.tensor([5, 6, 7, 18]))


def _perm(rs, n, which):
    return {"identity": np.arange(n), "reversed": np.arange(n)[::-1].copy(),
            "random": rs.permutation(n)}[which].astype(np.int64)


@pytest.mark.parametrize("which", ["identity", "reversed", "random"])
@pytest.mark.parametrize("streams", ["keys", "debug"])
def test_permute_state_matches_reference_packed_gather(which, streams):
    """The reference's [N, 19] packed gather by perm (L, beta, ray_o,
    ray_d, prev_pdf, active, prev_specular, lane and the key words as
    bitcast columns, integrators.py:272-285), against the port's permute
    of the same state: every row bit for bit, the counters unmoved; the
    debug sampler's uniforms [N, D+1, S] gathered as the reference gathers
    them (u[perm])."""
    rs = np.random.default_rng(zlib_seed(which, streams))
    n = 131
    state = _state(rs, n)
    perm = _perm(rs, n, which)
    if streams == "keys":
        jkeys = jrng.lane_keys(5, jnp.int32(1), jnp.arange(n,
                                                            dtype=jnp.int32))
        words = np.asarray(jax.random.key_data(jkeys)).astype(np.uint32)
        u = trng.LaneKeys(torch.from_numpy(words[:, 0].view(np.int32)),
                          torch.from_numpy(words[:, 1].view(np.int32)),
                          torch.from_numpy(rs.integers(0, 9, n)))
    else:
        u = torch.from_numpy(rs.uniform(size=(n, DEPTH + 1, 6))
                             .astype(np.float32))
    got, gu = W.permute_state(state, u, torch.from_numpy(perm))

    f32 = jnp.float32
    bc = lambda x: jax.lax.bitcast_convert_type(x, f32)
    j = lambda x: jnp.asarray(x.numpy())
    icols = [bc(j(state.lane).astype(jnp.int32))]
    if streams == "keys":
        icols += [bc(jnp.asarray(words))]
    packed = jnp.concatenate(
        [j(state.L), j(state.beta), j(state.ray_o), j(state.ray_d),
         j(state.prev_pdf)[:, None], j(state.active)[:, None].astype(f32),
         j(state.prev_specular)[:, None].astype(f32)]
        + [c if c.ndim == 2 else c[:, None] for c in icols], axis=1)[perm]
    ref = np.asarray(packed)
    same = lambda a, b: np.testing.assert_array_equal(
        a.view(np.int32), np.asarray(b).view(np.int32))
    same(got.L.numpy(), ref[:, 0:3])
    same(got.beta.numpy(), ref[:, 3:6])
    same(got.ray_o.numpy(), ref[:, 6:9])
    same(got.ray_d.numpy(), ref[:, 9:12])
    same(got.prev_pdf.numpy(), ref[:, 12])
    np.testing.assert_array_equal(got.active.numpy(), ref[:, 13] > 0.5)
    np.testing.assert_array_equal(got.prev_specular.numpy(), ref[:, 14] > 0.5)
    np.testing.assert_array_equal(
        got.lane.numpy(), ref[:, 15].view(np.int32).astype(np.int64))
    for name in ("tmin", "tmax"):
        same(getattr(got, name).numpy(), getattr(state, name).numpy()[perm])
    assert torch.equal(got.counts, state.counts)
    if streams == "keys":
        kw = ref[:, 16:18].view(np.uint32)
        np.testing.assert_array_equal(gu.k0.numpy().view(np.uint32), kw[:, 0])
        np.testing.assert_array_equal(gu.k1.numpy().view(np.uint32), kw[:, 1])
        np.testing.assert_array_equal(gu.sample.numpy(),
                                      u.sample.numpy()[perm])
    else:
        same(gu.numpy(), np.asarray(jnp.asarray(u.numpy())[perm]))


@pytest.mark.parametrize("which", ["none", "identity", "reversed", "random"])
def test_unsort_guard_matches_reference(which):
    """The reference's L[argsort(lane)] (no sort: L itself) and its guard
    where(isfinite(L), L, 0), with NaN, +inf and -inf lanes and -0.0,
    against the port's, bit for bit."""
    rs = np.random.default_rng(zlib_seed("unsort", which))
    n = 257
    L = rs.normal(size=(n, 3)).astype(np.float32)
    L[::7, 0] = np.nan
    L[3::11, 1] = np.inf
    L[5::13, 2] = -np.inf
    L[1::17] = -0.0
    lane = None if which == "none" else _perm(rs, n, which)
    ref = jnp.asarray(L)
    if lane is not None:
        ref = ref[jnp.argsort(jnp.asarray(lane))]
    ref = np.asarray(jnp.where(jnp.isfinite(ref), ref, 0.0))
    got = W.unsort_guard(torch.from_numpy(L.copy()),
                         None if lane is None else torch.from_numpy(lane))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))


def _rays(js, res, seed):
    rs = np.random.default_rng(seed)
    cam = jcam.make_camera(js.camera.lookfrom, js.camera.front,
                           js.camera.vup, js.camera.vfov, (res, res))
    ids = np.arange(res * res)
    xy = np.stack([ids % res, ids // res], -1) + rs.uniform(size=(res * res,
                                                                  2))
    o, d = jcam.generate_rays(cam, jnp.asarray(xy, jnp.float32))
    return np.array(o), np.array(d)


@pytest.mark.parametrize("streams", ["keys", "injected"])
def test_li_path_sorted_cornell_every_lane(streams):
    """li_path with sort_rays on the Cornell box (its lanes permuted after
    bounces 0-2, the state by permute_state, the colours back by
    unsort_guard) against the reference's li_path(sort_rays=True) on the
    same rays and streams: every lane, and the ray counts exactly."""
    js, ts = jscenes.cornell_box(), tscenes.cornell_box()
    o, d = _rays(js, 16, 9)
    n = o.shape[0]
    if streams == "keys":
        pix = np.arange(n, dtype=np.int32)
        uj = jrng.lane_keys(7, jnp.int32(2), jnp.asarray(pix))
        ut = trng.lane_keys(7, 2, torch.from_numpy(pix))
    else:
        u = np.random.default_rng(10).uniform(
            size=(n, DEPTH + 1, 4 + 2 * js.meta.n_lights)).astype(np.float32)
        uj, ut = jnp.asarray(u), torch.from_numpy(u)
    a, sj = jint.li_path(js.meta, js.pack, jnp.asarray(o), jnp.asarray(d), uj,
                         DEPTH, with_stats=True, sort_rays=True)
    b, st = tint.li_path(ts.meta, ts.pack, torch.from_numpy(o),
                         torch.from_numpy(d), ut, DEPTH, with_stats=True,
                         sort_rays=True)
    a, b = np.asarray(a), b.numpy()
    assert np.isfinite(b).all() and a.mean() > 0.01
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    for k in W.COUNTS:
        assert int(st[k]) == int(sj[k]), k
    assert st["rays"].dtype == torch.int64


def test_li_path_sorted_instanced_scene(monkeypatch):
    """The instanced scene (kernel-routed: its sorts default on) against the
    reference called eagerly, as test_li_path_instanced_scene holds it."""
    monkeypatch.setattr(jbvh, "intersect_bvh", jax.jit(
        jbvh.intersect_bvh, static_argnames=("leaf_size", "any_hit")))
    js, ts = instanced_scene(JBuilder), instanced_scene(TBuilder)
    assert ts.meta.kernel_routed
    o, d = _rays(js, 24, 12)
    n = o.shape[0]
    pix = np.arange(n, dtype=np.int32)
    a = np.asarray(jint.li_path(js.meta, js.pack, jnp.asarray(o),
                                jnp.asarray(d),
                                jrng.lane_keys(3, jnp.int32(0),
                                               jnp.asarray(pix)), DEPTH))
    b = tint.li_path(ts.meta, ts.pack, torch.from_numpy(o),
                     torch.from_numpy(d),
                     trng.lane_keys(3, 0, torch.from_numpy(pix)),
                     DEPTH).numpy()
    ok = np.all(np.isclose(b, a, rtol=RTOL, atol=ATOL), axis=1)
    print(f"sorted instanced li_path: {int((~ok).sum())} of {n} lanes differ")
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(b.mean() - a.mean()) <= 1e-4 * a.mean()
    assert a.mean() > 0.01


def test_li_path_takes_the_camera_state():
    """li_path given camera_rays' state equals li_path making its own from
    the same rays, bit for bit, with its counts."""
    ts = tscenes.cornell_box()
    _, tc = _cameras(ts, 12, 12)
    pix = torch.arange(144)
    keys = trng.lane_keys(4, 0, pix)
    init = W.camera_rays(tc, pix, 12, trng.camera_jitter(keys),
                         ts.pack.ray_eps)
    a, sa = tint.li_path(ts.meta, ts.pack, init.ray_o, init.ray_d, keys,
                         DEPTH, with_stats=True, init=init)
    b, sb = tint.li_path(ts.meta, ts.pack, init.ray_o, init.ray_d, keys,
                         DEPTH, with_stats=True)
    assert torch.equal(a, b)
    assert {k: int(v) for k, v in sa.items()} == {
        k: int(v) for k, v in sb.items()}


def test_wrappers_check_their_inputs():
    """Each wrapper raises on a tensor its kernel cannot take, and on the
    card where an input requires grad (no kernel has a backward) rather
    than fall back (a device without a route: tests/test_torch_kernels.py)."""
    ts = tscenes.cornell_box()
    _, tc = _cameras(ts, 4, 4)
    pix = torch.arange(16)
    jit = torch.full((16, 2), 0.5)
    with pytest.raises(ValueError, match="jitter"):
        W.check_camera_inputs(tc, pix, 4, jit[:, :1], ts.pack.ray_eps,
                              torch.device("cpu"))
    with pytest.raises(ValueError, match="pixel"):
        W.check_camera_inputs(tc, pix.int(), 4, jit, ts.pack.ray_eps,
                              torch.device("cpu"))
    with pytest.raises(ValueError, match="width"):
        W.check_camera_inputs(tc, pix, 0, jit, ts.pack.ray_eps,
                              torch.device("cpu"))
    rs = np.random.default_rng(0)
    state = _state(rs, 16)
    keys = trng.lane_keys(0, 0, pix)
    with pytest.raises(ValueError, match="perm"):
        W.check_permute_inputs(state, keys, pix.int(), torch.device("cpu"))
    with pytest.raises(ValueError, match="active"):
        W.check_permute_inputs(state._replace(active=state.active.int()),
                               keys, pix, torch.device("cpu"))
    with pytest.raises(ValueError, match="lane"):
        W.check_unsort_inputs(state.L, pix.int(), torch.device("cpu"))
    with pytest.raises(ValueError, match="require grad"):
        kernels.route("permute_state", torch.device("cuda"),
                      L=state.L.requires_grad_())


def test_casts_write_their_slab_rows():
    """A closest cast's kinds are rows of one [K, N] t, index and valid
    slab in _kind_hits order (the merge's tie order); a shadow cast's flags
    rows of one [F, N] slab; occluded writes its result into a given row;
    every value as the casts return it alone."""
    from chip_smoke import every_kind_scene
    scene = every_kind_scene(False)
    meta, pack = scene.meta, scene.pack
    rs = np.random.default_rng(2)
    n = 64
    c = pack.world_center.numpy()
    r = float(pack.world_radius)
    o = torch.from_numpy((c + rs.uniform(-0.8, 0.8, (n, 3)) * r)
                         .astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rs.normal(size=(n, 3)).astype(np.float32)), dim=1)
    tmin = pack.ray_eps.expand(n).contiguous()
    tmax = torch.full((n,), float("inf"))
    hits, kinds = tpack._kind_hits(meta, pack, o, d, tmin, tmax)
    assert kinds == [k for k, _ in tpack._kind_order(
        meta, tpack.brute_shapes(meta, pack))]
    assert len(kinds) >= 5
    t0 = hits[0].t
    for j, h in enumerate(hits):
        assert h.t.data_ptr() == t0.data_ptr() + 4 * n * j
        assert torch.equal(h.valid, torch.isfinite(h.t))
    flags, fk = tpack._kind_hits(meta, pack, o, d, tmin, tmax, any_hit=True)
    assert fk[0] is None and len(flags) == len(fk) >= 2
    assert all(f.data_ptr() == flags[0].data_ptr() + n * j
               for j, f in enumerate(flags))
    p_to = o + 3.0 * d
    want = tpack.occluded(meta, pack, o, p_to)
    row = torch.zeros((2, n), dtype=torch.bool)
    got = tpack.occluded(meta, pack, o, p_to, out=row[1])
    assert got.data_ptr() == row[1].data_ptr()
    assert torch.equal(row[1], want) and not row[0].any()
    assert 0 < int(want.sum()) < n
