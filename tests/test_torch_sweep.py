"""The port's cull-sweep (jet_pbrt_tpu_torch/ops/sweep_bvh.py) and its
routing against the JAX package.

* Host tables: the spheres, root and group count of `build_sweep_tables`,
  `mesh_root_sphere`, `flat_inst` equal the reference's bit for bit, but
  for a group that holds a sliver the reference drops (both edges
  non-zero, |e1 x e2|^2 <= 1e-18), whose sphere must bound every row the
  port's test can accept; the rows the port tests are the (p0, e1, e2)
  rows themselves.
* The plain sweep against the reference's kernels in interpret mode and
  the XLA skip-link walks, closest hit and any hit, soup and 4 instances,
  with dead lanes, finite tmax and a partial last packet. Valid bits must
  be equal everywhere. The port tests a triangle by the wide route's
  Moller-Trumbore, rounded one operation at a time, so it equals the
  port's own wide walk bit for bit (t, valid bits, triangle and
  instance), and the reference's XLA walk evaluated op by op
  (jax.disable_jit, so no multiply-add is contracted) bit for bit too:
  the same Moller-Trumbore in the same order. The reference's sweep
  kernel tests by Baldwin-Weber rows and its jitted XLA walk contracts
  multiply-adds, so t lies within the reference's own sweep-against-walk
  tolerance, rtol 1e-4 (tests/test_sweep.py), of both: those rounding
  orders part by up to ~2e-5 relative on grazing rays. A hit index may differ from theirs only on a lane that the
  float64 forensic of chip_smoke explains as a near-tie or an edge graze.
* A sliver far from the rest of its group, which the reference's spheres
  leave out: the sweep finds its hit, as the wide walk does.
* The two-level cull's super-spheres: no (ray, group) pair that passes
  the kernel-rounded group test fails its super's test, on rays bisected
  onto each group test's float32 boundary, origins inside group spheres,
  tmin and tmax at a sphere's entry and exit and directions off unit
  length, on a dense generated bunny (4 instances too) and a soup; each
  packet's keys from a plain two-level cull equal the flat cull's; the
  table's shape and bounds on a ragged last super and a single one; the
  work counts of `sweep_work_plain` against numpy.
* Routing: `sweep_route` equals the reference's predicate on a grid of
  counts on both sides of each bound; a build with the budget lowered
  populates only the sweep layout; the gate reads leaf-16 tables; the same
  scene's frame through the sweep and through the wide kernel's plain walk
  is the same bit for bit.
* `li_path` on a sweep-routed scene against the JAX `li_path` on the same
  rays and uniforms, both sorting: at least 99.5% of lanes agree at the
  slice tolerances (rtol 1e-4, atol 1e-5) and the image mean to 1e-4.
* The primitives harness (scripts/sweep_prims.py): the plain version
  against the reference's kernel `kern` in interpret mode, bit for bit
  (trailing-window minima, as `pltpu.roll` leaves them; the reference
  harness's own numpy oracle takes aligned blocks and disagrees with its
  kernel), on main's inputs and on more seeds and keys tied across the
  window edges, and the CPU route of the port's entry point.
* chip_smoke's float64 forensic on two lanes recorded on the card: it
  explains a disagreement inside the float32 rounding of the triangle test
  and rejects one outside it.
"""
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from jet_pbrt_tpu.models import integrators as jint
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import sweep_bvh as JS
from jet_pbrt_tpu.ops import wide_bvh as JW
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import bvh as tbvh
from jet_pbrt_tpu_torch.ops import sweep_bvh as TS
from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from jet_pbrt_tpu_torch.scene import builder as tbuilder
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.convert import scene_from_arrays
from jet_pbrt_tpu_torch.scripts import sweep_prims

from test_torch_scene import _arrays, _mesh, instanced_scene
from test_torch_slice import _both, _lane_ok

torch.set_num_threads(2)

LEAF = 4
WALK_RTOL = 1e-4
OFF = np.array([[0, 0, 0], [25, 0, 0], [0, 25, 0], [25, 25, 0]], np.float32)
SCALE = np.array([1.0, 0.5, 2.0, 1.5], np.float32)


def _random_mesh(seed, t=800, spread=10.0, size=0.8):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 1, 3)).astype(np.float32)
    return base + rng.uniform(-size, size, (t, 3, 3)).astype(np.float32)


def _rows(tris, leaf=LEAF):
    """BVH-ordered (p0, e1, e2) rows and the skip-link node rows."""
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    bvh, order = jbvh.build_bvh(p0, p1, p2, leaf_size=leaf)
    p0, p1, p2 = p0[order], p1[order], p2[order]
    mt = np.concatenate([p0, p1 - p0, p2 - p0], axis=1).astype(np.float32)
    return mt, jbvh.pack_node_table(bvh, len(order), leaf)


MESHES = {
    # the meshes of tests/test_sweep.py at their leaf of 16, and with
    # degenerate rows (zero area, and all-zero) mixed in
    "soup800": lambda: _rows(_random_mesh(3), 16)[0],
    "blas500": lambda: _rows(_random_mesh(11, t=500), 16)[0],
    "degenerate": lambda: np.concatenate(
        [_rows(_random_mesh(5, t=300))[0], np.zeros((7, 9), np.float32),
         np.tile(np.array([[1, 2, 3, 1, 1, 1, 2, 2, 2]], np.float32),
                 (5, 1))]),
}


def _bounds(sphere, rows):
    """Every vertex of rows lies inside sphere ([8] row: c, |c|^2, r^2, r)."""
    v = np.concatenate([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                        rows[:, 0:3] + rows[:, 6:9]]).astype(np.float64)
    dist = np.linalg.norm(v - sphere[:3].astype(np.float64), axis=1)
    return bool((dist <= sphere[5]).all())


@pytest.mark.parametrize("name", sorted(MESHES))
def test_host_tables_match_reference(name):
    mt = MESHES[name]()
    rows, sph, root, ng = TS.build_sweep_tables(mt)
    _, j_sph, j_root, j_ng = JS.build_sweep_tables(mt)
    assert ng == j_ng
    # the port's spheres bound every row its triangle test can accept;
    # the reference's leave out its Baldwin-Weber degenerate rows. Where a
    # group holds no sliver (a row of the first kind and not of the
    # second), the two are equal bit for bit; where it does, the port's
    # sphere bounds each such row
    e1, e2 = mt[:, 3:6].astype(np.float64), mt[:, 6:9].astype(np.float64)
    accept = e1.any(1) & e2.any(1)
    sliver = accept & ((np.cross(e1, e2) ** 2).sum(1) <= 1e-18)
    assert sliver.any() == (name == "degenerate")
    for g in range(ng):
        s = slice(g * TS.GROUP, (g + 1) * TS.GROUP)
        if sliver[s].any():
            assert _bounds(sph[:, g], mt[s][accept[s]]), g
        else:
            np.testing.assert_array_equal(sph[:, g], j_sph[:, g])
    np.testing.assert_array_equal(sph[:, ng:], j_sph[:, ng:])
    if sliver.any():
        assert _bounds(root, mt[accept])
    else:
        np.testing.assert_array_equal(root, j_root)
    # the rows the port tests are the (p0, e1, e2) rows themselves, padded
    # with zeros
    tp = ng * TS.GROUP
    assert rows.shape == (9, tp) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, :mt.shape[0]], mt.T)
    assert not rows[:, mt.shape[0]:].any()
    np.testing.assert_array_equal(TS.mesh_root_sphere(mt),
                                  JS.mesh_root_sphere(mt))
    np.testing.assert_array_equal(TS.flat_inst(OFF, SCALE),
                                  JS.flat_inst(OFF, SCALE))
    np.testing.assert_array_equal(
        TS.flat_inst(np.zeros((0, 3)), np.zeros(0)),
        JS.flat_inst(np.zeros((0, 3), np.float32), np.zeros(0, np.float32)))
    assert TS.max_groups() == JS.max_groups()
    for t in (1, mt.shape[0], 250_000, 251_000, 1 << 20):
        assert TS.fits_vmem(t) == JS.fits_vmem(t), t


# ---------------------------------------------------------------------------
# plain sweep against the reference kernel (interpret mode) and XLA walk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    soup_mt, soup_nodes = _rows(_random_mesh(3))
    blas_mt, blas_nodes = _rows(_random_mesh(11, t=500))
    return {"soup": (soup_mt, soup_nodes, 0),
            "instanced": (blas_mt, blas_nodes, len(SCALE))}


def _rays(mt, n_inst, seed):
    """2*128+17 rays (a partial last packet) aimed at random points inside
    random triangles of random instances; every 5th lane dead, every 7th
    with a finite tmax."""
    rng = np.random.default_rng(seed)
    n = 2 * TS.RAYS + 17
    row = mt[rng.integers(0, mt.shape[0], n)]
    a, b = rng.uniform(0.1, 0.45, (2, n, 1))
    k = rng.integers(0, max(n_inst, 1), n)
    off = OFF[k] if n_inst else np.zeros((n, 3), np.float32)
    scl = SCALE[k] if n_inst else np.ones(n, np.float32)
    target = (row[:, 0:3] + a * row[:, 3:6] + b * row[:, 6:9]) \
        * scl[:, None] + off
    o = np.where(n_inst, (12.0, 12.0, 40.0), (0.0, 0.0, 12.0)) \
        + rng.normal(0, 1.0, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[1::7] = rng.uniform(5, 40, tmax[1::7].shape)
    tmin[::5], tmax[::5] = np.inf, -1.0
    return (o.astype(np.float32), d.astype(np.float32), tmin,
            tmax.astype(np.float32))


def _explained(o, d, tmin, tmax, hits, any_hit, mt, n_inst):
    inst = TS.flat_inst(OFF, SCALE) if n_inst else np.array(
        [0, 0, 0, 1, 0, 0, 0, 1], np.float32)
    return chip_smoke.explain_lane(
        o.astype(np.float64), d.astype(np.float64), float(tmin), float(tmax),
        hits, any_hit, mt.astype(np.float64),
        inst.reshape(-1, 4).astype(np.float64), mt.shape[0])


def _wide_plain(mt, nodes, n_inst, rays, any_hit):
    """The port's wide walk over the same rows: (its hit, and for instances
    the TLAS order, whose position p holds instance torder[p])."""
    blas = tbvh.unpack_node_table(nodes, LEAF)
    torder = None
    if n_inst:
        lo = nodes[0, :3][None] * SCALE[:, None] + OFF
        hi = nodes[0, 3:6][None] * SCALE[:, None] + OFF
        tlas, torder = tbvh.build_box_bvh(lo, hi, leaf_size=1)
        tables = TW.wide_tables_instanced(tlas, blas, mt, OFF[torder],
                                          SCALE[torder], LEAF)
    else:
        tables = TW.wide_tables(blas, mt, LEAF)
    h = TW.intersect_wide_plain(tables, *map(torch.from_numpy, rays),
                                any_hit=any_hit, has_inst=bool(n_inst),
                                leaf_size=LEAF, n_tris=mt.shape[0])
    return h, torder


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("which", ["soup", "instanced"])
def test_plain_sweep_matches_reference(meshes, which, any_hit):
    mt, nodes, n_inst = meshes[which]
    o, d, tmin, tmax = _rays(mt, n_inst, 7 if any_hit else 1)
    n_tris = mt.shape[0]
    if any_hit:
        # shadow segments: half end before the closest hit, half beyond it
        h = TS.intersect_sweep_plain(
            TS.sweep_tables(mt, OFF if n_inst else None,
                            SCALE if n_inst else None),
            *map(torch.from_numpy, (o, d, tmin, tmax)), any_hit=False,
            n_tris=n_tris)
        f = np.where(np.arange(len(o)) % 2 == 0, 0.9, 1.1)
        tmax = np.where(h.valid.numpy(), h.t.numpy() * f, tmax
                        ).astype(np.float32)
    bw, sph, root, ng = JS.build_sweep_tables(mt)
    inst = JS.flat_inst(OFF, SCALE) if n_inst else JS.flat_inst(
        np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    J = jnp.asarray
    h_ref = JS.intersect_sweep(J(sph), J(bw), J(inst), J(root), n_tris, ng,
                               J(o), J(d), J(tmin), J(tmax), n_inst=n_inst,
                               any_hit=any_hit, interpret=True, pps=1)

    def xla_walk():
        if n_inst:
            return jbvh.intersect_instances(
                J(OFF), J(SCALE), J(nodes), J(mt), J(o), J(d), J(tmin),
                J(tmax), leaf_size=LEAF, any_hit=any_hit)
        return jbvh.intersect_bvh(J(nodes), J(mt), J(o), J(d), J(tmin),
                                  J(tmax), leaf_size=LEAF, any_hit=any_hit)

    h_xla = xla_walk()
    tables = TS.sweep_tables(mt, OFF if n_inst else None,
                             SCALE if n_inst else None)
    before = TS.intersect_sweep.launches
    hp = TS.intersect_sweep(tables, *map(torch.from_numpy,
                                         (o, d, tmin, tmax)),
                            any_hit=any_hit, n_tris=n_tris)
    assert TS.intersect_sweep.launches == before  # CPU: the plain version
    vp, tp, ip = hp.valid.numpy(), hp.t.numpy(), hp.index.numpy()
    assert 40 < vp.sum() < len(vp) - 40
    assert not vp[::5].any()
    # the port's own wide walk tests by the same arithmetic: bit for bit
    hw, torder = _wide_plain(mt, nodes, n_inst, (o, d, tmin, tmax), any_hit)
    assert np.array_equal(hw.valid.numpy(), vp)
    if not any_hit:
        assert np.array_equal(hw.t.numpy()[vp], tp[vp])
        iw = hw.index.numpy().astype(np.int64)[vp]
        if n_inst:
            iw = torder[iw // n_tris] * n_tris + iw % n_tris
        assert np.array_equal(iw, ip[vp])
    # the reference's XLA walk tests by Moller-Trumbore too, in the same
    # order. Evaluated op by op (jax.disable_jit: no multiply-add
    # contracted, as in the eager reference that tests/golden is held to)
    # it rounds every product and sum as the port does: valid, t, triangle
    # and instance bit for bit
    if not any_hit:
        with jax.disable_jit():
            he = xla_walk()
        assert np.array_equal(np.asarray(he.valid), vp)
        assert np.array_equal(np.asarray(he.t)[vp], tp[vp])
        assert np.array_equal(np.asarray(he.index)[vp], ip[vp])
    # the reference's sweep kernel tests by Baldwin-Weber rows, and its
    # jitted XLA walk contracts multiply-adds: both within the reference's
    # own sweep-against-walk tolerance
    for h in (h_ref, h_xla):
        v, t, idx = (np.asarray(x) for x in (h.valid, h.t, h.index))
        assert np.array_equal(v, vp)
        if any_hit:
            continue
        np.testing.assert_allclose(t[vp], tp[vp], rtol=WALK_RTOL)
        for j in np.nonzero(vp & (idx != ip))[0]:
            assert _explained(o[j], d[j], tmin[j], tmax[j],
                              [(True, float(t[j]), idx[j]),
                               (True, float(tp[j]), ip[j])],
                              False, mt, n_inst), j


def test_plain_sweep_stats_shape(meshes):
    mt, _, n_inst = meshes["instanced"]
    o, d, tmin, tmax = map(torch.from_numpy, _rays(mt, n_inst, 3))
    hit, stats = TS.intersect_sweep(TS.sweep_tables(mt, OFF, SCALE), o, d,
                                    tmin, tmax, any_hit=False,
                                    n_tris=mt.shape[0], with_stats=True)
    assert stats.shape == (3, TS.STATS_COLS) and stats.dtype == torch.int64
    assert hit.valid.shape == (o.shape[0],)


# ---------------------------------------------------------------------------
# the kernel's root and sphere tests, and the work the inputs need
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _dot(a, b, c, x, y, z):
    return _fma(c, z, _fma(b, y, a * x))


def _inst_rows(n_inst):
    return (TS.flat_inst(OFF, SCALE).reshape(-1, 4)[1:] if n_inst
            else np.array([[0, 0, 0, 1]], np.float32))


def _super_numpy(sup, lx, ly, lz, dx, dy, dz, od, oo, tminc, capc):
    """csrc/sweep_bvh.cu's super_test in numpy: rays [R] against supers
    [8, S], float32 with each fused step rounded once."""
    R = lambda x: x[:, None]
    cx, cy, cz, cc, r2, rad, k1, f = (sup[k][None] for k in range(8))
    f32 = np.float32
    cd = _dot(R(dx), R(dy), R(dz), cx, cy, cz)
    co = _dot(R(lx), R(ly), R(lz), cx, cy, cz)
    tc = cd - R(od)
    m2 = _fma(-tc, tc, cc - f32(2) * co + R(oo))
    ss = _fma(tc, tc, cc + f32(2) * np.abs(co) + R(oo))
    e = R(np.abs(f32(1) - _dot(dx, dy, dz, dx, dy, dz)))
    slack = _fma(ss, _fma(_fma(f32(2.6), f, f32(2.1)), e, k1),
                 r2 * (f32(31) * f) * e)
    rt = _fma(np.sqrt(ss), f32(2.0 ** -16), rad * (f32(1) + e))
    return (e > f32(2.0 ** -7)) | ((m2 <= r2 + slack) & (tc + rt >= tminc)
                                   & (tc - rt <= capc) & (capc >= tminc))


def _work_numpy(mt, n_inst, o, d, tmin, tmax, t_final):
    """sweep_work_plain by brute force in numpy: every ray against every
    group and every super of every instance, float32 with each fused step
    rounded once."""
    _, sph, root, ng = JS.build_sweep_tables(mt)
    n_sup = -(-ng // 32)
    sup = TS.super_spheres(sph, ng)[:, :n_sup]
    size = np.minimum(ng - 32 * np.arange(n_sup), 32)
    cap = np.minimum(tmax, t_final)
    cx, cy, cz, cc, r2, rad = (sph[k, :ng][None] for k in range(6))
    R = lambda x: x[:, None]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    n_root = n_pairs = n_super = n_tests = 0
    for row in _inst_rows(n_inst):
        inv = np.float32(1) / row[3]
        lo = (o - row[:3]) * inv
        lx, ly, lz = lo[:, 0], lo[:, 1], lo[:, 2]
        tminl, capl = tmin * inv, cap * inv
        od, oo = _dot(lx, ly, lz, dx, dy, dz), _dot(lx, ly, lz, lx, ly, lz)
        ex, ey, ez = root[0] - lx, root[1] - ly, root[2] - lz
        rtc = _dot(ex, ey, ez, dx, dy, dz)
        rm2 = _fma(-rtc, rtc, _dot(ex, ey, ez, ex, ey, ez))
        rr = root[5]
        rhit = ((rm2 <= rr * rr * np.float32(1.0001) + np.float32(1e-5))
                & (rtc + rr >= tminl) & (rtc - rr <= capl) & (capl >= tminl))
        n_root += int(rhit.sum())
        far = np.float32(3e37)
        tminc, capc = R(np.minimum(tminl, far)), R(np.minimum(capl, far))
        cd = _dot(R(dx), R(dy), R(dz), cx, cy, cz)
        co = _dot(R(lx), R(ly), R(lz), cx, cy, cz)
        tc = cd - R(od)
        m2 = _fma(-tc, tc, cc - np.float32(2) * co + R(oo))
        slack = _fma(tc, tc, cc + np.float32(2) * np.abs(co) + R(oo)) \
            * np.float32(1e-6)
        entry = tc - rad
        ok = ((m2 <= r2 + slack) & (tc + rad >= tminc) & (entry <= capc)
              & (capc >= tminc) & R(rhit)
              & (np.maximum(entry, np.float32(0)) * row[3] <= R(cap)))
        n_pairs += int(ok.sum())
        sok = _super_numpy(sup, lx, ly, lz, dx, dy, dz, od, oo, tminc,
                           capc) & R(rhit)
        n_super += int(sok.sum())
        n_tests += int((sok * size).sum())
    return n_root, n_pairs, n_super, n_tests


@pytest.mark.parametrize("which", ["soup", "instanced"])
def test_sweep_work_plain_matches_brute_force(meshes, monkeypatch, which):
    """The input-side work count (the bound's numerator) against an
    independent numpy count, scales 0.5 to 2, chunked over rays."""
    mt, _, n_inst = meshes[which]
    o, d, tmin, tmax = _rays(mt, n_inst, 13)
    tables = TS.sweep_tables(mt, OFF if n_inst else None,
                             SCALE if n_inst else None)
    T = torch.from_numpy
    h = TS.intersect_sweep_plain(tables, T(o), T(d), T(tmin), T(tmax),
                                 any_hit=False, n_tris=mt.shape[0])
    monkeypatch.setattr(TS, "_CULL_ELEMS", 64)
    with np.errstate(invalid="ignore", over="ignore"):
        want = _work_numpy(mt, n_inst, o, d, tmin, tmax, h.t.numpy())
    got = TS.sweep_work_plain(tables, T(o), T(d), T(tmin), T(tmax), h.t)
    assert tuple(got) == want
    n_root, n_pairs, n_super, n_tests = got
    # every hit's group is a needed pair; dead lanes pass no root test
    assert int(h.valid.sum()) <= n_pairs < n_root * tables.n_groups
    assert n_root <= (len(o) - len(o[::5])) * max(n_inst, 1)
    # a needed pair's super passes, and the two-level cull tests no more
    # groups than the flat one (these meshes hold one super or two)
    assert 0 < n_super and n_pairs <= n_tests <= n_root * tables.n_groups


@pytest.mark.parametrize("which", ["soup", "instanced"])
def test_closest_hit_group_passes_own_sphere_test(meshes, which):
    """The kernel tests a group for a ray only where that ray's own sphere
    test passes (csrc/sweep_bvh.cu, the scan). So every closest hit that a
    float64 Moller-Trumbore recheck confirms must lie in a group whose
    sphere test, and whose instance's root test, pass for that ray under
    the kernel's float32 arithmetic and slack, with the cap the kernel has
    at that instance: min(tmax, the best hit of the earlier instances)."""
    mt, _, n_inst = meshes[which]
    o, d, tmin, tmax = _rays(mt, n_inst, 17)
    n_tris = mt.shape[0]
    tables = TS.sweep_tables(mt, OFF if n_inst else None,
                             SCALE if n_inst else None)
    T = torch.from_numpy
    rays = tuple(map(T, (o, d, tmin, tmax)))
    h = TS.intersect_sweep_plain(tables, *rays, any_hit=False, n_tris=n_tris)
    valid, t, idx = h.valid.numpy(), h.t.numpy(), h.index.numpy()
    checked = 0
    for i, row in enumerate(_inst_rows(n_inst)):
        best = torch.full_like(rays[3], float("inf"))
        if i:
            best = TS.intersect_sweep_plain(
                tables._replace(inst=tables.inst[:4 * (i + 1)], n_inst=i),
                *rays, any_hit=False, n_tris=n_tris).t
        cap = torch.minimum(rays[3], best)
        lo, tminl, capl, od, oo = TS.instance_rays(T(row), rays[0], rays[1],
                                                   rays[2], cap)
        rhit = TS.root_test(tables.root, lo, rays[1], tminl, capl).numpy()
        ok, _ = TS.sphere_test(tables.sph[:, :tables.n_groups], lo, rays[1],
                               tminl, capl, od, oo)
        for j in np.nonzero(valid & (idx // n_tris == i))[0]:
            r = int(idx[j] % n_tris)
            t64 = chip_smoke._mt64_all(
                (o[j].astype(np.float64) - row[:3]) / row[3],
                d[j].astype(np.float64), mt[r:r + 1].astype(np.float64))[0]
            if not abs(t64[0] * row[3] - t[j]) <= 1e-4 * t[j]:
                continue
            assert rhit[j], (j, i)
            assert bool(ok[j, r // TS.GROUP]), (j, i, r // TS.GROUP)
            checked += 1
    assert checked > 40


# ---------------------------------------------------------------------------
# the super-spheres of the two-level cull
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dense_rows():
    """The bunny generator at sweep density in BVH-DFS order (47,420
    triangles in 371 groups: 11 supers and a ragged twelfth of 19)."""
    from jet_pbrt_tpu_torch.scene import assets
    tris = assets.bunny_mesh(60_000).astype(np.float32)
    _, order = tbvh.build_bvh(tris[:, 0], tris[:, 1], tris[:, 2], leaf_size=4)
    t = tris[order]
    return np.concatenate([t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]],
                          axis=1).astype(np.float32)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _own_group_test(sph, g, off, scl, o, d, tmin, tmax):
    """The kernel-rounded group test of each world ray i against its own
    group g[i] of instance (off[i], scl[i]): [N] bool."""
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    inv = 1.0 / f(scl)
    lo = (f(o) - f(off)) * inv[:, None]
    d = f(d)
    dots = lambda a, b: TS._dot3((a[:, 0], a[:, 1], a[:, 2]), b[:, 0],
                                 b[:, 1], b[:, 2])
    ok, _ = TS.sphere_test(torch.from_numpy(sph[:, g]), lo, d,
                           f(tmin) * inv, f(tmax) * inv, dots(lo, d),
                           dots(lo, lo))
    return ok.diagonal()


def _adversarial_rays(sph, ng, rows, seed, n_groups_hit=160):
    """World rays built against group spheres of instances `rows` [(off.xyz,
    scale), ...]: lines at the group test's own float32 boundary (found by
    bisection on the line's distance from the centre, then a few ulps
    either side), from 2 to 3e4 radii away; origins inside a group's
    sphere; tmax and tmin a few ulps either side of the entry and the
    exit; directions a few ulps to 1e-3 off unit length. -> (o, d, tmin,
    tmax) float32 and each ray's target group; rays 9k..9k+3 are the
    boundary rays of group target[9k]."""
    rng = np.random.default_rng(seed)
    c = sph[0:3, :ng].T.astype(np.float64)
    r = sph[5, :ng].astype(np.float64)
    ulp = 2.0 ** -23
    groups = rng.choice(ng, min(n_groups_hit, ng), replace=False)
    pick = rng.integers(len(rows), size=len(groups))
    off = np.array([rows[k][0] for k in pick])
    scl = np.array([rows[k][1] for k in pick])
    # boundary rays: 4 distances back along the line, bisected together
    gb = np.repeat(groups, 4)
    ob, sb = np.repeat(off, 4, 0), np.repeat(scl, 4)
    dl = _unit(rng.normal(size=(len(gb), 3)))
    nrm = _unit(np.cross(dl, rng.normal(size=(len(gb), 3))))
    back = r[gb] * np.tile([2.0, 40.0, 1e3, 3e4], len(groups)) \
        * rng.uniform(0.5, 1.5, len(gb))
    ends = np.full(len(gb), 1e-3), np.full(len(gb), np.inf)

    def world(h):
        ol = c[gb] + nrm * h[:, None] - dl * back[:, None]
        return ol * sb[:, None] + ob

    def passes(h):
        return _own_group_test(sph, gb, ob, sb, world(h), dl,
                               *ends).numpy()

    lo_h, hi_h = np.zeros(len(gb)), r[gb].copy()
    for _ in range(80):
        more = passes(hi_h)
        if not more.any():
            break
        hi_h = np.where(more, 2 * hi_h, hi_h)
    for _ in range(60):
        mid = 0.5 * (lo_h + hi_h)
        ok = passes(mid)
        lo_h, hi_h = np.where(ok, mid, lo_h), np.where(ok, hi_h, mid)
    k = rng.integers(-3, 4, len(gb))
    bound = world(lo_h * (1 + k * ulp))
    o, d, tmin, tmax, tg = [], [], [], [], []
    for j, g in enumerate(groups):
        o.extend(bound[4 * j:4 * j + 4])
        d.extend(dl[4 * j:4 * j + 4])
        tmin.extend([1e-3] * 4)
        tmax.extend([np.inf] * 4)
        tg.extend([g] * 4)
        for kind in range(4, 9):
            dk = _unit(rng.normal(size=3))
            nk = _unit(np.cross(dk, rng.normal(size=3)))
            lo_, hi = 1e-3, np.inf
            if kind == 4:     # inside the sphere
                ol = c[g] + _unit(rng.normal(size=3)) * r[g] \
                    * rng.uniform(0, 0.9)
            else:             # through the sphere, capped at its entry or
                # starting at its exit
                ol = c[g] + nk * r[g] * rng.uniform(0, 0.99) \
                    - dk * r[g] * rng.uniform(1.5, 30)
                tc = float(dk @ (c[g] - ol))
                kk = 1 + rng.integers(-4, 5) * ulp
                if kind in (5, 6):
                    hi = (tc - r[g]) * scl[j] * kk
                else:
                    lo_ = max((tc + r[g]) * scl[j] * kk, 1e-3)
            if kind in (6, 8):
                dk = dk * (1 + rng.choice([-1, 1])
                           * rng.choice([1e-7, 1e-6, 1e-5, 1e-3]))
            o.append(ol * scl[j] + off[j])
            d.append(dk)
            tmin.append(lo_)
            tmax.append(hi)
            tg.append(g)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    return f(o), f(d), f(tmin), f(tmax), np.array(tg)


def _inst_rows_of(n_inst):
    return ([(OFF[k].astype(np.float64), float(SCALE[k]))
             for k in range(len(SCALE))] if n_inst
            else [(np.zeros(3), 1.0)])


@pytest.mark.parametrize("which", ["dense", "dense-instanced", "soup"])
def test_super_test_never_drops_a_pair_the_group_test_passes(meshes, which):
    """The kernel-rounded group test against the kernel-rounded super test
    (ops/sweep_bvh.py sphere_test and super_test, csrc/sweep_bvh.cu's
    arithmetic) on every (ray, group) pair of adversarial rays: no pair
    that passes its group's test fails its super's. The rays graze group
    spheres within a few ulps, start inside them, are capped or start a
    few ulps from a sphere's entry or exit, start up to 3e4 radii away,
    and some have directions off unit length."""
    mt = _dense_rows() if which.startswith("dense") else meshes["soup"][0]
    n_inst = len(SCALE) if which.endswith("instanced") else 0
    tables = TS.sweep_tables(mt, OFF if n_inst else None,
                             SCALE if n_inst else None)
    ng = tables.n_groups
    sph, sup = tables.sph[:, :ng], tables.sup[:, :-(-ng // TS.SUPER)]
    o, d, tmin, tmax, target = _adversarial_rays(
        tables.sph.numpy(), ng, _inst_rows_of(n_inst), 41)
    passed = failed_super = 0
    # a tangent ray against its own group: both sides of the boundary
    tangent = torch.from_numpy(np.arange(len(target)) % 9 < 4)
    sides = set()
    for row in tables.inst.view(-1, 4)[1:] if n_inst else tables.inst.view(
            -1, 4)[:1]:
        lo, tminl, capl, od, oo = TS.instance_rays(row, o, d, tmin, tmax)
        ok, _ = TS.sphere_test(sph, lo, d, tminl, capl, od, oo)
        sok = TS.super_test(sup, lo, d, tminl, capl, od, oo)
        sok = sok.repeat_interleave(TS.SUPER, dim=1)[:, :ng]
        passed += int(ok.sum())
        failed_super += int((ok & ~sok).sum())
        own = ok[torch.arange(len(target)), torch.from_numpy(target)]
        sides |= set(own[tangent].tolist())
    assert failed_super == 0
    assert passed > len(target) and sides == {False, True}
    # the supers cull: most (ray, super) pairs fail where the mesh has
    # several supers
    if ng > TS.SUPER:
        assert float(sok.float().mean()) < 0.5


@pytest.mark.parametrize("case", ["ragged", "single", "one-group"])
def test_super_table_shape_and_bounds(case):
    """`sweep_tables`' super table: [8, Gp / 32]; a ragged last super
    (n_groups % 32 != 0) and a single super hold only their real groups
    (the padding columns of sph are ignored; the columns past the last
    super are zero); each super's test radii bound every member group's
    sphere (float64), its factor F is at least 1, its slack positive."""
    rows = {"ragged": lambda: _random_mesh(7, t=70 * TS.GROUP - 50),
            "single": lambda: _random_mesh(3),
            "one-group": lambda: _random_mesh(3, t=60)}[case]()
    mt = np.concatenate([rows[:, 0], rows[:, 1] - rows[:, 0],
                         rows[:, 2] - rows[:, 0]], 1).astype(np.float32)
    tables = TS.sweep_tables(mt)
    ng = tables.n_groups
    gp = tables.sph.shape[1]
    n_sup = -(-ng // TS.SUPER)
    sup = tables.sup.numpy()
    assert sup.shape == (8, gp // TS.SUPER) and sup.dtype == np.float32
    assert ng % TS.SUPER != 0 and n_sup == {"ragged": 3, "single": 1,
                                            "one-group": 1}[case]
    assert not sup[:, n_sup:].any()
    sph = tables.sph.numpy().astype(np.float64)
    for s in range(n_sup):
        g = np.arange(s * TS.SUPER, min((s + 1) * TS.SUPER, ng))
        dist = np.linalg.norm(sph[0:3, g].T - sup[0:3, s].astype(np.float64),
                              axis=1)
        reach = (dist + sph[5, g]).max()
        assert reach <= sup[5, s] and reach ** 2 <= sup[4, s], s
        assert sup[7, s] >= 1 and sup[6, s] > 0
    # groups past the last are not part of any super
    junk = tables.sph.numpy().copy()
    junk[:, ng:] = 1e3
    np.testing.assert_array_equal(TS.super_spheres(junk, ng), sup)


def _packet_keys(tables, o, d, tmin, tmax, two_level):
    """Per packet of RAYS rays and per instance, each group's packed cull
    key (entry-distance bits & ~GMASK) | group over the packet's rays past
    the root test (capped at tmax): by the flat cull (every group against
    every such ray) or by a plain two-level cull (a group against the rays
    that pass its super's test)."""
    ng = tables.n_groups
    sph = tables.sph[:, :ng]
    sup = tables.sup[:, :-(-ng // TS.SUPER)]
    far = int(torch.tensor(float(TS.FAR)).view(torch.int32)) & ~TS.GMASK
    gid = torch.arange(ng, dtype=torch.int32)
    inst = tables.inst.view(-1, 4)
    keys = []
    for p0 in range(0, o.shape[0], TS.RAYS):
        q = slice(p0, p0 + TS.RAYS)
        for i in range(max(tables.n_inst, 1)):
            row = inst[i + 1] if tables.n_inst else inst[0]
            lo, tminl, capl, od, oo = TS.instance_rays(row, o[q], d[q],
                                                       tmin[q], tmax[q])
            live = TS.root_test(tables.root, lo, d[q], tminl, capl)
            args = tuple(x[live] for x in (lo, d[q], tminl, capl, od, oo))
            ok, entry = TS.sphere_test(sph, *args)
            if two_level:
                sok = TS.super_test(sup, *args)
                ok = ok & sok.repeat_interleave(TS.SUPER, dim=1)[:, :ng]
            bits = (entry.clamp(min=0.0) * row[3]).view(torch.int32) \
                & ~TS.GMASK
            key = torch.where(ok, bits, torch.full_like(bits, far))
            key = (key.amin(0) if key.shape[0] else torch.full_like(gid, far))
            keys.append(torch.minimum(key, torch.full_like(key, far)) | gid)
    return torch.stack(keys)


@pytest.mark.parametrize("which", ["soup", "instanced", "dense-instanced"])
def test_two_level_cull_keys_equal_the_flat_cull(meshes, which):
    """Each packet's group keys from a plain two-level cull (a group
    tested only for the rays that pass its super) equal the flat cull's,
    on the sweep tests' rays and on adversarial ones: the scan pops the
    same groups in the same order."""
    if which == "dense-instanced":
        mt, n_inst = _dense_rows(), len(SCALE)
    else:
        mt, _, n_inst = meshes[which]
    tables = TS.sweep_tables(mt, OFF if n_inst else None,
                             SCALE if n_inst else None)
    rays = list(map(torch.from_numpy, _rays(mt, n_inst, 23)))
    adv = _adversarial_rays(tables.sph.numpy(), tables.n_groups,
                            _inst_rows_of(n_inst), 43, n_groups_hit=40)
    rays = [torch.cat([a, b]) for a, b in zip(rays, adv[:4])]
    flat = _packet_keys(tables, *rays, two_level=False)
    two = _packet_keys(tables, *rays, two_level=True)
    assert torch.equal(flat, two)
    far = int(torch.tensor(float(TS.FAR)).view(torch.int32)) & ~TS.GMASK
    assert int(((flat & ~TS.GMASK) < far).sum()) > 10


def test_sweep_checks_its_arguments(meshes):
    mt, _, _ = meshes["soup"]
    tables = TS.sweep_tables(mt)
    o, d, tmin, tmax = map(torch.from_numpy, _rays(mt, 0, 2))
    with pytest.raises(ValueError, match="do not fill"):
        TS.intersect_sweep(tables, o, d, tmin, tmax, any_hit=False,
                           n_tris=mt.shape[0] + TS.GROUP)
    with pytest.raises(ValueError, match="float32"):
        TS.intersect_sweep(tables, o.double(), d, tmin, tmax, any_hit=False,
                           n_tris=mt.shape[0])


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _reference_route(n_wide, n_rows, n_inst):
    """The reference TPU build's decision (builder.py:544-600): 'sweep',
    'wide', or its XLA walk."""
    if n_inst is not None and not n_inst < 32:
        return "walk"
    if JW.fits_vmem(n_wide, n_rows, 16):
        return "wide"
    if (n_rows + 127) // 128 <= JS.max_groups():
        return "sweep"
    return "walk"


@pytest.mark.parametrize("n_inst", [None, 1, 4, 31, 32, 40])
def test_route_matches_reference_predicate(n_inst):
    # SMEM binds at 8192 wide nodes, VMEM near 23.5k leaves of 16, the
    # group cap at 8192 * 128 rows
    walls = [1, 1000, 8191, 8192, 8193, 20000]
    rows = [16, 100_000, 360_000, 370_000, 376_832, 377_000, 8192 * 128,
            8192 * 128 + 1, 2_000_000]
    for n_w in walls:
        for n_r in rows:
            assert TW.fits_vmem(n_w, n_r, 16) == JW.fits_vmem(n_w, n_r, 16)
            want = _reference_route(n_w, n_r, n_inst) == "sweep"
            assert tbuilder.sweep_route(n_w, n_r, n_inst) == want, (n_w, n_r)


@pytest.mark.parametrize("instanced", [True, False],
                         ids=["instanced", "flattened"])
def test_routed_build_populates_only_the_sweep(monkeypatch, instanced):
    monkeypatch.setattr(TW, "_VMEM_BUDGET", 1024)
    scene = instanced_scene(TBuilder, instanced)
    m, p = scene.meta, scene.pack
    assert m.kernel_routed
    if instanced:
        rows = m.n_blas_tris[0]
        assert m.pallas_blas == (True,) and m.wide_blas == (False,)
        assert m.n_groups_blas == ((rows + 127) // 128,)
        assert p.inst_wide == (None,) and isinstance(p.inst_sweep[0],
                                                     TS.SweepTables)
        assert p.inst_sweep[0].n_inst == 4
    else:
        rows = m.n_bvh_tris
        assert m.pallas_bvh and not m.wide_bvh
        assert m.n_groups_bvh == (rows + 127) // 128
        assert p.bvh_wide is None and p.bvh_sweep.n_inst == 0
    img = render(scene, 12, 12, spp=1, seed=3, max_depth=3, clamp=False,
                 device="cpu")
    assert torch.isfinite(img).all() and float(img.mean()) > 0.01


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_sweep_bounds_slivers_the_reference_drops(any_hit):
    """A sliver (|e1 x e2| = 5e-10, under the reference's Baldwin-Weber
    degenerate bound, so outside its spheres) far from the rest of its
    group: Moller-Trumbore hits it (|det| 5e-10 > 1e-12), so the port's
    group and root spheres bound it, and the sweep finds the hit the wide
    walk finds."""
    sliver = np.array([[[100, 0, 0], [101, 0, 0], [100.5, 5e-10, 0]]],
                      np.float32)
    mt, nodes = _rows(np.concatenate([_random_mesh(5, t=300), sliver]))
    n_tris = mt.shape[0]
    k = int(np.nonzero(mt[:, 0] == 100.0)[0][0])
    g = k // TS.GROUP
    assert (mt[g * TS.GROUP:(g + 1) * TS.GROUP, 0] < 20).sum() > 1
    assert not _bounds(JS.build_sweep_tables(mt)[1][:, g], mt[k:k + 1])
    o, d, tmin, tmax = _rays(mt, 0, 5)
    rays = (np.concatenate([o, [[100.5, 2e-10, 5.0]]]).astype(np.float32),
            np.concatenate([d, [[0.0, 0.0, -1.0]]]).astype(np.float32),
            np.append(tmin, np.float32(1e-3)),
            np.append(tmax, np.float32(np.inf)))
    hs = TS.intersect_sweep_plain(TS.sweep_tables(mt),
                                  *map(torch.from_numpy, rays),
                                  any_hit=any_hit, n_tris=n_tris)
    hw, _ = _wide_plain(mt, nodes, 0, rays, any_hit)
    assert bool(hw.valid[-1]) and torch.equal(hs.valid, hw.valid)
    if not any_hit:
        assert int(hs.index[-1]) == k
        assert torch.equal(hs.t[hs.valid], hw.t[hw.valid])
        assert torch.equal(hs.index[hs.valid], hw.index[hw.valid])


@pytest.mark.parametrize("instanced", [True, False],
                         ids=["instanced", "flattened"])
def test_sweep_and_wide_routes_agree(monkeypatch, instanced):
    """The sweep tests a triangle by the wide route's Moller-Trumbore,
    rounded alike: the same scene's frame through either route is the
    same, bit for bit (a mesh's image does not depend on its triangle
    count's route)."""
    frames = []
    for budget in (TW._VMEM_BUDGET, 1024):
        monkeypatch.setattr(TW, "_VMEM_BUDGET", budget)
        scene = instanced_scene(TBuilder, instanced)
        m = scene.meta
        swept = any(m.pallas_blas) or m.pallas_bvh
        assert swept == (budget == 1024)
        frames.append(render(scene, 12, 12, spp=2, seed=5, max_depth=5,
                             clamp=False, device="cpu"))
    assert float(frames[0].mean()) > 0.01
    assert torch.equal(frames[0], frames[1])


def test_gate_reads_leaf16_tables(monkeypatch):
    """With the SMEM budget between the mesh's leaf-16 and leaf-4 wide node
    counts, the reference keeps it on the wide kernel, and so does the
    port."""
    tris = _mesh(t=1000, seed=4)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    n16 = tbuilder._wide_leaf_counts(p0, p1, p2)[0]
    bvh4, _ = jbvh.build_bvh(p0, p1, p2, leaf_size=4)
    n4 = TW.collapse_wide(bvh4, 4)[0].shape[0]
    assert n16 < n4
    monkeypatch.setattr(TW, "_SMEM_BUDGET", n16 * TW.WIDTH * 4)
    b = TBuilder("gate")
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0))
    b.add_mesh(tris, b.add_matte((0.5, 0.5, 0.5)))
    m = b.build(use_bvh=True).meta
    assert m.wide_bvh and not m.pallas_bvh
    monkeypatch.setattr(TW, "_SMEM_BUDGET", n16 * TW.WIDTH * 4 - 1)
    m = b.build(use_bvh=True).meta
    assert m.pallas_bvh and not m.wide_bvh


# ---------------------------------------------------------------------------
# li_path on a sweep-routed scene against the reference
# ---------------------------------------------------------------------------

def test_li_path_sweep_routed_matches_reference(monkeypatch):
    js = instanced_scene(JBuilder)
    blas = np.asarray(js.pack.blas_tris[0])
    bw, sph, _root, ng = JS.build_sweep_tables(blas)
    pack = js.pack._replace(
        inst_s_sph=(jnp.asarray(sph),),
        inst_s_bw=(jnp.asarray(np.pad(bw, ((0, 4), (0, 0)))),),
        inst_s_tbl=(jnp.asarray(JS.flat_inst(js.pack.inst_off[0],
                                             js.pack.inst_scale[0])),))
    meta = dataclasses.replace(js.meta, pallas_blas=(True,),
                               n_groups_blas=(ng,))
    js = dataclasses.replace(js, meta=meta, pack=pack)
    # the reference kernel in interpret mode, compiled once per mode
    kernel = jax.jit(JS.intersect_sweep, static_argnums=(4, 5),
                     static_argnames=("n_inst", "any_hit", "interpret",
                                      "with_stats", "stream_bw", "pps"))
    monkeypatch.setattr(JS, "intersect_sweep",
                        functools.partial(kernel, interpret=True, pps=1))
    ts = scene_from_arrays(dataclasses.asdict(meta), _arrays(pack), js.camera)
    assert ts.meta.pallas_blas == (True,) and ts.meta.n_groups_blas == (ng,)
    assert meta.kernel_routed and ts.meta.kernel_routed  # both sides sort
    a, b, sj, st = _both(js, ts, 16, 5)
    ok = _lane_ok(a, b)
    print(f"sweep-routed li_path: {int((~ok).sum())} of {len(ok)} lanes "
          "differ")
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(b.mean() - a.mean()) <= 1e-4 * a.mean(), (a.mean(), b.mean())
    assert a.mean() > 0.01
    assert int(st["rays"]) == int(sj["rays"])


def test_sweep_prims_plain_matches_oracle(capsys):
    before = sweep_prims.sweep_prims.launches
    err = sweep_prims.main("cpu")
    assert "all primitives OK" in capsys.readouterr().out
    assert err == 0.0 and sweep_prims.sweep_prims.launches == before


def _reference_prims():
    """The reference harness scripts/sweep_prims.py, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        "reference_sweep_prims", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "sweep_prims.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def test_sweep_prims_plain_matches_reference_kernel(monkeypatch):
    """The reference harness's `kern`, run by its own main in interpret
    mode on main's inputs, equals sweep_prims_plain bit for bit. The
    harness's numpy oracle (aligned 8-lane blocks), which its main asserts,
    is off by 0.33: the port follows the kernel."""
    ref = _reference_prims()
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    seen = []
    monkeypatch.setattr(np.testing, "assert_allclose",
                        lambda r, want, **kw: seen.append((np.asarray(r),
                                                           want)))
    ref.main()
    (out, aligned_oracle), = seen
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
            for _ in range(2))
    plain = sweep_prims.sweep_prims_plain(a, b).numpy()
    assert np.array_equal(plain.view(np.uint32), out.view(np.uint32))
    assert np.abs(aligned_oracle - out).max() > 0.3


@pytest.mark.parametrize("seed,ties", [(1, False), (2, False), (0, True),
                                       (1, True)])
def test_sweep_prims_plain_matches_reference_kernel_on_more_inputs(seed,
                                                                    ties):
    """The reference's `kern` in interpret mode, called as its main calls
    it, on sweep_prims.inputs (seeded normals, and keys tied across the
    window edges at lanes 0, 8 and 120), equals sweep_prims_plain and the
    port's oracle bit for bit: the inputs the card's kernel is held to."""
    from jax.experimental.pallas import tpu as pltpu

    ref = _reference_prims()
    an, bn = sweep_prims.inputs(seed, ties)
    f = pl.pallas_call(
        ref.kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, 128), jnp.float32),
                        pltpu.SMEM((1, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA],
        interpret=True)
    out = np.asarray(jax.jit(f)(jnp.asarray(an), jnp.asarray(bn)))
    plain = sweep_prims.sweep_prims_plain(torch.from_numpy(an),
                                          torch.from_numpy(bn)).numpy()
    assert np.array_equal(plain.view(np.uint32), out.view(np.uint32))
    assert np.array_equal(sweep_prims.oracle(an, bn).view(np.uint32),
                          out.view(np.uint32))


# ---------------------------------------------------------------------------
# chip_smoke's float64 forensic on two lanes recorded on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bunny_rows(tmp_path_factory):
    """The default bunny's BLAS rows and instance table, as the wide kernel
    reads them."""
    path = str(tmp_path_factory.mktemp("bunny") / "bunny.obj")
    scene = tscenes.bunny_scene(bunny_path=tscenes.bunny_obj(path=path))
    w = scene.pack.inst_wide[0]
    return (w.tris.numpy().astype(np.float64),
            w.inst.numpy().astype(np.float64), scene.meta.n_blas_tris[0],
            float(scene.pack.ray_eps))


_H = float.fromhex
# Two of the default bunny's 2^20 targeted rays (seed 12) where the wide
# kernel and its plain version disagree on an NVIDIA H100: o, d; tmin is
# the scene's ray epsilon (0x1.b3f32cp-11), tmax inf.
CRACK = ((_H("-0x1.a98376p+7"), _H("-0x1.111e3ep+6"), _H("0x1.22014p+7")),
         (_H("0x1.2d6ca2p-1"), _H("0x1.6ceb14p-2"), _H("-0x1.737a68p-1")))
GRAZING = ((_H("0x1.b6b178p+6"), _H("0x1.c1cfb4p+6"), _H("0x1.ba21c4p+7")),
           (_H("-0x1.e7ba7p-2"), _H("-0x1.f8129ap-3"), _H("-0x1.b03246p-1")))
FORENSIC_CASES = {
    # the ray crosses the edge shared by rows 25008 and 25612 of instance 2
    # (f64 margins -1.3e-4 / +1.3e-4): the kernel hits 25612, the plain
    # version's float32 edge tests leak through to row 13177 behind it
    "edge-crack": (CRACK, [(2, 25612, 191.6278076171875),
                           (2, 13177, 206.29708862304688)], True),
    # |cos| = 6.6e-4 to row 15073: float32 t is good to ~1e-4 relative
    # (f64 392.41875)
    "grazing": (GRAZING, [(0, 15073, 392.3989562988281),
                        (0, 15073, 392.37933349609375)], True),
    # what the forensic must still reject: two robust hits at different t,
    "robust-pair": (CRACK, [(2, 13177, 206.29708862304688),
                            (2, 14473, 218.78491382710098)], False),
    # a robust hit that one side missed,
    "robust-miss": (CRACK, [(2, 13177, 206.29708862304688), None], False),
    # and a t 1% off its triangle even at grazing incidence
    "grazing-1pct": (GRAZING, [(0, 15073, 392.3989562988281),
                             (0, 15073, 392.3989562988281 * 1.01)], False),
}


@pytest.mark.parametrize("case", sorted(FORENSIC_CASES))
def test_forensic_bounds_float32_rounding(bunny_rows, case):
    """explain_lane accepts a disagreement inside the float32 rounding of
    the triangle test (an edge crack, a grazing t) and rejects one
    outside it."""
    rows, inst, n_tris, tmin = bunny_rows
    (o, d), sides, expected = FORENSIC_CASES[case]
    hits = [(False, np.inf, 0) if s is None else (True, s[2],
                                                  s[0] * n_tris + s[1])
            for s in sides]
    assert bool(chip_smoke.explain_lane(np.array(o), np.array(d), tmin,
                                        np.inf, hits, False, rows, inst,
                                        n_tris)) == expected
