"""The brute-force casts' parts that run without a card (ops/brute.py).

`brute_hits` on CPU tensors (its plain version, `brute_hits_plain`)
against the reference package's intersect_* functions on the same seeded
numpy inputs, per kind present (triangles only, rects only, all four,
none), closest hit (each kind's KindHit, then `merge_hits`) and any hit
(the OR of the kinds' valid), on random rays with finite tmax on a fifth
of the lanes, on shapes each present twice (ties: the lowest index keeps
the hit) and on a batch half of dead lanes (tmin = inf, tmax = -1) with
NaN and inf directions; on the closest-hit cases, every decision (index,
valid) equal to a float64 evaluation's and unmoved by a change of 2^-20 in
the rays, so that no rounding can make the reference and the port
disagree on them; `scene/pack.py::intersect` and `occluded` against
the reference's on a 4,096-ray Cornell batch and on the every-kind scene
(chip_smoke.every_kind_scene), and `_kind_hits`' kinds in the reference's
order, one brute_hits call per cast; the wrapper's input checks. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2d).

Tolerance: rtol 1e-5 / atol 1e-6 on t (tests/test_torch_ops.py's: both
sides op by op in float32 on the CPU), index, kind and valid exactly.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import intersect as jis
from jet_pbrt_tpu.scene import pack as jpack
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.ops import brute as TB
from jet_pbrt_tpu_torch.ops import intersect as tis
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene import scenes as tscenes

torch.set_num_threads(2)

N = 512
M = 24
RTOL, ATOL = 1e-5, 1e-6
KINDS = {"triangles": ("tri",), "rects": ("rect",),
         "all": ("tri", "sph", "rect", "disk"), "none": ()}
# BruteShapes field -> the reference's intersect function
JFN = {"tri": jis.intersect_triangles, "sph": jis.intersect_spheres,
       "rect": jis.intersect_rects, "disk": jis.intersect_disks}


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _shapes(rs, kinds, dup: bool) -> dict:
    """Seeded numpy shapes of each kind, M of each (with dup, each present
    twice, the copies after the originals)."""
    m = M
    out = {}
    for f in kinds:
        if f == "tri":
            p0 = rs.uniform(-2, 2, (m, 3)).astype(np.float32)
            x = (p0, p0 + rs.uniform(-1, 1, (m, 3)).astype(np.float32),
                 p0 + rs.uniform(-1, 1, (m, 3)).astype(np.float32))
        elif f == "sph":
            x = (rs.uniform(-2, 2, (m, 3)).astype(np.float32),
                 rs.uniform(0.1, 0.8, m).astype(np.float32))
        elif f == "rect":
            c = rs.uniform(-2, 2, (m, 1, 3)).astype(np.float32)
            sq = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                          np.float32)
            q = c + sq[None] * rs.uniform(0.2, 1.0, (m, 1, 1)).astype(
                np.float32)
            x = (q, np.tile(np.array([[0, 0, 1]], np.float32), (m, 1)))
        else:
            x = (rs.uniform(-2, 2, (m, 3)).astype(np.float32), _unit(rs, m),
                 rs.uniform(0.2, 1.0, m).astype(np.float32))
        out[f] = tuple(np.concatenate([a, a]) for a in x) if dup else x
    return out


def _rays(rs, case: str):
    o = rs.uniform(-3, 3, (N, 3)).astype(np.float32)
    # three lanes in four aimed into the shapes' box, the rest anywhere
    d = np.where((np.arange(N) % 4 != 0)[:, None],
                 rs.uniform(-1.5, 1.5, (N, 3)) - o, _unit(rs, N))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.full(N, 1e-3, np.float32)
    tmax = np.where(rs.uniform(size=N) < 0.8, np.inf,
                    rs.uniform(0.5, 5, N)).astype(np.float32)
    if case == "dead":
        dead = np.arange(N) % 2 == 1
        d[dead & (np.arange(N) % 4 == 1)] = np.nan
        d[dead & (np.arange(N) % 4 == 3)] = np.inf
        tmin[dead], tmax[dead] = np.inf, -1.0
    return o, d, tmin, tmax


def _reference(rays, shapes: dict):
    """The reference's KindHit per kind, in `BruteShapes.present` order."""
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)
    out = []
    for f in ("tri", "sph", "rect", "disk"):
        if f not in shapes:
            continue
        x = shapes[f]
        if f == "rect":
            x = (x[0][:, 0], x[0][:, 1], x[0][:, 2], x[0][:, 3], x[1])
        out.append(JFN[f](*j(rays), *j(x)))
    return out


def _port_shapes(shapes: dict) -> tis.BruteShapes:
    return tis.BruteShapes(**{f: tuple(torch.from_numpy(x) for x in
                                       shapes[f]) if f in shapes else None
                              for f in tis.BruteShapes._fields})


def _same_hit(a, b):
    """The reference's KindHit a and the port's b agree; a failure names
    the first lanes that differ with both sides' t, index and valid."""
    ta, ia, va = (np.asarray(x) for x in (a.t, a.index, a.valid))
    tb, ib, vb = b.t.numpy(), b.index.numpy(), b.valid.numpy()
    bad = (~np.isclose(tb, ta, rtol=RTOL, atol=ATOL, equal_nan=True)
           | (ib != ia) | (vb != va))
    msg = "; ".join(f"lane {i}: reference t {ta[i]!r} index {ia[i]} valid "
                    f"{va[i]}, port t {tb[i]!r} index {ib[i]} valid {vb[i]}"
                    for i in np.nonzero(bad)[0][:8])
    np.testing.assert_allclose(tb, ta, rtol=RTOL, atol=ATOL, err_msg=msg)
    np.testing.assert_array_equal(ib, ia, err_msg=msg)
    np.testing.assert_array_equal(vb, va, err_msg=msg)


@pytest.mark.parametrize("case", ["random", "duplicates", "dead"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kinds", sorted(KINDS))
def test_brute_hits_matches_reference(kinds, any_hit, case):
    rs = np.random.default_rng(zlib.crc32(f"{kinds} {case}".encode()))
    shapes = _shapes(rs, KINDS[kinds], case == "duplicates")
    rays = _rays(rs, case)
    want = _reference(rays, shapes)
    got = TB.brute_hits(*(torch.from_numpy(x) for x in rays),
                        _port_shapes(shapes), any_hit)
    if any_hit:
        occ = np.zeros(N, bool)
        for h in want:
            occ |= np.asarray(h.valid)
        np.testing.assert_array_equal(got.numpy(), occ)
        assert got.dtype == torch.bool and got.shape == (N,)
        if kinds != "none":
            assert 20 < occ.sum() < N - 20
        return
    assert len(got) == len(want) == len(KINDS[kinds])
    for a, b in zip(want, got):
        _same_hit(a, b)
    if not want:
        return
    kind_ids = list(range(len(want)))
    a = jis.merge_hits(want, kind_ids)
    b = tis.merge_hits(got, kind_ids)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=RTOL,
                               atol=ATOL)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    valid = b[3].numpy()
    assert valid.sum() > 20
    if case == "dead":
        assert not valid[1::2].any()
        assert all((h.index.numpy()[1::2] == 0).all()
                   and np.isinf(h.t.numpy()[1::2]).all() for h in got)
    if case == "duplicates":
        # each shape's copy sits M rows later: the first keeps a tie
        assert all((h.index.numpy()[h.valid.numpy()] < M).all()
                   for h in got)


@pytest.mark.parametrize("case", ["random", "duplicates", "dead"])
@pytest.mark.parametrize("kinds", ["all", "rects", "triangles"])
def test_brute_hits_decisions_hold_under_rounding(kinds, case):
    """The cases above hold no lane whose closest hit a rounding could
    move: every kind's index and valid equal a float64 evaluation of the
    same tests (the shapes and rays widened exactly), and a relative change
    of 2^-20 in o and d (several ulps of each) moves none of them. So the
    reference and the port, each op by op in float32 on any CPU, must agree
    on them, and a disagreement is a fault of one side, not a near-tie."""
    rs = np.random.default_rng(zlib.crc32(f"{kinds} {case}".encode()))
    shapes = _shapes(rs, KINDS[kinds], case == "duplicates")
    rays = _rays(rs, case)
    got = TB.brute_hits(*(torch.from_numpy(x) for x in rays),
                        _port_shapes(shapes), False)
    wide = tis.brute_hits_plain(
        *(torch.from_numpy(x).double() for x in rays),
        _port_shapes({f: tuple(x.astype(np.float64) for x in v)
                      for f, v in shapes.items()}), False)
    o, d, tmin, tmax = rays
    moved = [TB.brute_hits(torch.from_numpy(o * np.float32(s)),
                           torch.from_numpy(d * np.float32(s)),
                           torch.from_numpy(tmin), torch.from_numpy(tmax),
                           _port_shapes(shapes), False)
             for s in (1 + 2.0 ** -20, 1 - 2.0 ** -20)]
    for j, h in enumerate(got):
        for other in (wide[j], *(m[j] for m in moved)):
            np.testing.assert_array_equal(h.index.numpy(),
                                          other.index.numpy())
            np.testing.assert_array_equal(h.valid.numpy(),
                                          other.valid.numpy())
        assert h.valid.numpy().any()


# --------------------------------------------------------------------------
# scene level: intersect and occluded against the reference's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes(request):
    return {"cornell": (jscenes.cornell_box(), tscenes.cornell_box()),
            "every-kind": (chip_smoke.every_kind_scene(builder=JBuilder),
                           chip_smoke.every_kind_scene())}


def _scene_rays(ts, n: int, seed: int):
    """n rays from seeded points in the scene's world sphere, in seeded
    directions, and shadow segments to seeded points."""
    rs = np.random.default_rng(seed)
    c = ts.pack.world_center.numpy()
    r = float(ts.pack.world_radius)
    o = (c + rs.uniform(-0.6, 0.6, (n, 3)) * r).astype(np.float32)
    d = _unit(rs, n)
    p_to = (c + rs.uniform(-0.6, 0.6, (n, 3)) * r).astype(np.float32)
    return o, d, p_to


@pytest.fixture
def jax_walks(monkeypatch):
    """The reference's XLA BVH walks jitted (op by op they take minutes)."""
    for name in ("intersect_bvh", "intersect_instances"):
        monkeypatch.setattr(jbvh, name, jax.jit(
            getattr(jbvh, name), static_argnames=("leaf_size", "any_hit")))


@pytest.mark.parametrize("which", ["cornell", "every-kind"])
def test_scene_intersect_and_occluded_match_reference(scenes, which,
                                                      jax_walks, monkeypatch):
    """4,096 rays: the closest hit's valid, kind order, material and light
    exactly, t and position within the tolerance; occluded exactly, with
    one brute_hits call per cast."""
    js, ts = scenes[which]
    o, d, p_to = _scene_rays(ts, 4096, 3)
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.where(np.arange(n) % 3 == 0, np.float32(200.0),
                    np.inf).astype(np.float32)
    calls = []
    inner = TB.brute_hits

    def count(*a, **kw):
        calls.append(a[5])
        return inner(*a, **kw)

    monkeypatch.setattr(TB, "brute_hits", count)
    t_args = [torch.from_numpy(x) for x in (o, d, tmin, tmax)]
    ha = jpack.intersect(js.meta, js.pack, *(jnp.asarray(x)
                                             for x in (o, d, tmin, tmax)))
    hb = tpack.intersect(ts.meta, ts.pack, *t_args)
    assert calls == [False]
    va = np.asarray(ha.valid)
    np.testing.assert_array_equal(hb.valid.numpy(), va)
    assert 0.2 < va.mean() < 1.0
    for f in ("mat_id", "light_id"):
        np.testing.assert_array_equal(getattr(hb, f).numpy(),
                                      np.asarray(getattr(ha, f)))
    np.testing.assert_allclose(hb.t.numpy()[va], np.asarray(ha.t)[va],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hb.position.numpy(), np.asarray(ha.position),
                               rtol=RTOL, atol=1e-4)
    mask = np.arange(n) % 5 != 0
    oa = jpack.occluded(js.meta, js.pack, jnp.asarray(o), jnp.asarray(p_to),
                        mask=jnp.asarray(mask))
    ob = tpack.occluded(ts.meta, ts.pack, torch.from_numpy(o),
                        torch.from_numpy(p_to), mask=torch.from_numpy(mask))
    assert calls == [False, True]
    np.testing.assert_array_equal(ob.numpy(), np.asarray(oa))
    assert np.asarray(oa).any() and not np.asarray(oa).all()
    assert not ob.numpy()[~mask].any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_kind_hits_keep_the_references_kinds(scenes, jax_walks, any_hit):
    """The every-kind scene: closest-hit kinds in the reference's order
    (triangles, the instanced family, spheres, rects, disks), each kind's
    hit equal to the reference's; any hit: the brute-force kinds' one flag
    (kind None) equal to the OR of the reference's, then the instanced
    family's."""
    js, ts = scenes["every-kind"]
    o, d, _ = _scene_rays(ts, 1024, 4)
    n = o.shape[0]
    args = (o, d, np.full(n, 1e-3, np.float32), np.full(n, np.inf,
                                                        np.float32))
    ja, ka = jpack._kind_hits(js.meta, js.pack,
                              *(jnp.asarray(x) for x in args),
                              any_hit=any_hit)
    tb, kb = tpack._kind_hits(ts.meta, ts.pack,
                              *(torch.from_numpy(x) for x in args),
                              any_hit=any_hit)
    inst = tpack.KIND_INST
    if not any_hit:
        assert kb == ka == [tpack.KIND_TRI, inst, tpack.KIND_SPHERE,
                            tpack.KIND_RECT, tpack.KIND_DISK]
        for a, b, k in zip(ja, tb, kb):
            if k != inst:
                _same_hit(a, b)
            else:
                np.testing.assert_array_equal(b.valid.numpy(),
                                              np.asarray(a.valid))
        return
    assert kb == [None, inst]
    occ = np.zeros(n, bool)
    for a, k in zip(ja, ka):
        if k != inst:
            occ |= np.asarray(a.valid)
    np.testing.assert_array_equal(tb[0].numpy(), occ)
    assert tb[0].dtype == torch.bool and 0 < occ.sum() < n
    np.testing.assert_array_equal(
        tb[1].numpy(), np.asarray(ja[ka.index(inst)].valid))


def test_brute_shapes_of_each_route(scenes):
    """Brute-force triangles only where no BVH kernel takes them; a kind
    the scene lacks is None."""
    _, cornell = scenes["cornell"]
    s = tpack.brute_shapes(cornell.meta, cornell.pack)
    assert s.present == ("tri",) and s.tri[0].shape == (32, 3)
    bvh = tscenes.cornell_box(use_bvh=True)
    assert bvh.meta.wide_bvh
    assert tpack.brute_shapes(bvh.meta, bvh.pack).present == ()
    _, every = scenes["every-kind"]
    assert tpack.brute_shapes(every.meta, every.pack).present == (
        "tri", "sph", "rect", "disk")


# --------------------------------------------------------------------------
# the wrapper's checks
# --------------------------------------------------------------------------

def _inputs():
    rs = np.random.default_rng(9)
    rays = [torch.from_numpy(x) for x in _rays(rs, "random")]
    return rays, _port_shapes(_shapes(rs, KINDS["all"], False))


@pytest.mark.parametrize("name", ["o", "tmax", "tri_p0", "sph_r", "rect_q",
                                  "disk_n"])
def test_wrapper_refuses_an_input_that_requires_grad(name):
    """The kernel reads raw pointers and has no backward: a ray, interval
    or geometry tensor that requires grad raises, on every route."""
    rays, shapes = _inputs()
    t = dict(zip(("o", "d", "tmin", "tmax"), rays))
    t.update(TB.shape_tensors(shapes))
    t[name] = t[name].clone().requires_grad_(True)
    shapes = tis.BruteShapes(
        tri=(t["tri_p0"], t["tri_p1"], t["tri_p2"]),
        sph=(t["sph_c"], t["sph_r"]), rect=(t["rect_q"], t["rect_n"]),
        disk=(t["disk_c"], t["disk_n"], t["disk_r"]))
    before = TB.brute_hits.launches
    with pytest.raises(ValueError, match="require grad"):
        TB.brute_hits(t["o"], t["d"], t["tmin"], t["tmax"], shapes, False)
    assert TB.brute_hits.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "empty",
                                 "device"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    rays, shapes = _inputs()
    if bad == "dtype":
        rays[2] = rays[2].double()
    elif bad == "shape":
        shapes = shapes._replace(sph=(shapes.sph[0], shapes.sph[1][:, None]))
    elif bad == "contiguity":
        q = shapes.rect[0]
        shapes = shapes._replace(rect=(q.transpose(1, 2).contiguous()
                                       .transpose(1, 2), shapes.rect[1]))
    elif bad == "empty":
        shapes = shapes._replace(disk=tuple(x[:0] for x in shapes.disk))
    else:
        rays = [x.to("meta") for x in rays]
        shapes = tis.BruteShapes(*(None if v is None else tuple(
            x.to("meta") for x in v) for v in shapes))
    with pytest.raises(ValueError, match={
            "dtype": "expected a contiguous torch.float32", "shape": r"\[24\]",
            "contiguity": "not contiguous", "empty": "holds no shape",
            "device": "no brute_hits route"}[bad]):
        TB.brute_hits(*rays, shapes, False)


def test_kernel_is_registered():
    from jet_pbrt_tpu_torch.ops.kernels import REGISTRY
    assert REGISTRY["brute_hits_kernel"] == (TB.__name__, "brute_hits")
    assert isinstance(TB.brute_hits.launches, int)
