"""The port's 8-wide BVH (jet_pbrt_tpu_torch/ops/wide_bvh.py) against the
JAX package: the host collapse must match `collapse_wide` exactly, and the
plain traversal must return the hits of the TPU kernel run in interpret mode
and of the XLA skip-link walks, on the meshes of tests/test_wide_bvh.py.

The plain walk also stands for the CUDA kernel on the CPU: its child-planar
bounds, its root cull (`wide_root_cull_plain`) and the wrapper's limits are
checked here; the kernel itself is held against the plain walk, bit for bit,
in tests/test_torch_cuda.py.

Tolerances: t at rtol 1e-5 / atol 1e-5 (float32 Moller-Trumbore on both
sides; the XLA walk's accept rule u+v<=1 and the port's 1-u-v>=0 round
differently only on edge grazes, which these random meshes do not hit).
Hit indices are compared through the triangle rows they select, since
leaves are padded by duplicating triangles.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import wide_bvh as JW
from jet_pbrt_tpu_torch.ops import bvh as tbvh
from jet_pbrt_tpu_torch.ops import wide_bvh as TW

torch.set_num_threads(2)

LEAF = 4


def _random_mesh(seed, t=800, spread=10.0, size=0.8):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 1, 3)).astype(np.float32)
    return base + rng.uniform(-size, size, (t, 3, 3)).astype(np.float32)


def _rays(seed, n, origin=(0.0, 0.0, 12.0)):
    rng = np.random.default_rng(seed)
    o = np.repeat(np.asarray(origin, np.float32)[None], n, 0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.full((n,), 1e-3, np.float32),
            np.full((n,), np.inf, np.float32))


def _mt_rows(p0, p1, p2):
    return np.concatenate([p0, p1 - p0, p2 - p0], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def single():
    tris = _random_mesh(3)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    bvh, order = jbvh.build_bvh(p0, p1, p2, leaf_size=LEAF)
    mt = _mt_rows(p0[order], p1[order], p2[order])
    return dict(bvh=bvh, order=order, mt=mt,
                nodes=jbvh.pack_node_table(bvh, len(order), LEAF),
                tables=TW.wide_tables(bvh, mt, LEAF),
                jw=JW.wide_tables(bvh, mt, LEAF))


@pytest.fixture(scope="module")
def instanced():
    tris = _random_mesh(4, t=500, spread=1.0, size=0.3)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    blas, order = jbvh.build_bvh(p0, p1, p2, leaf_size=LEAF)
    mt = _mt_rows(p0[order], p1[order], p2[order])
    blas_nodes = jbvh.pack_node_table(blas, len(order), LEAF)
    off = np.array([[0, 0, 0], [3, 0, 0], [0, 4, 0], [-3, -1, 2]], np.float32)
    scale = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    lo = blas_nodes[0, :3][None] * scale[:, None] + off
    hi = blas_nodes[0, 3:6][None] * scale[:, None] + off
    tlas, torder = jbvh.build_box_bvh(lo, hi, leaf_size=1)
    off, scale = off[torder], scale[torder]
    return dict(tlas=tlas, blas=blas, mt=mt, blas_nodes=blas_nodes,
                off=off, scale=scale,
                tables=TW.wide_tables_instanced(tlas, blas, mt, off, scale,
                                                LEAF),
                jw=JW.wide_tables_instanced(tlas, blas, mt, off, scale, LEAF))


def _plain(tables, o, d, tmin, tmax, *, any_hit=False, has_inst=False):
    h = TW.intersect_wide(tables, *(torch.from_numpy(np.ascontiguousarray(x))
                                    for x in (o, d, tmin, tmax)),
                          any_hit=any_hit, has_inst=has_inst, leaf_size=LEAF,
                          n_tris=tables.tris.shape[0])
    return h.t.numpy(), h.index.numpy(), h.valid.numpy()


def _same_hits(mt, n_tris, a, b):
    ta, ia, va = a
    tb, ib, vb = b
    assert np.array_equal(va, vb)
    np.testing.assert_allclose(ta[va], tb[va], rtol=1e-5, atol=1e-5)
    rows_a = mt[ia[va] % n_tris]
    rows_b = mt[ib[va] % n_tris]
    assert np.array_equal(rows_a, rows_b)
    assert np.array_equal(ia[va] // n_tris, ib[va] // n_tris)


def test_plain_counts_its_work(single):
    """with_stats returns the same hits and the walk's node visits and
    triangle tests: every live ray visits the root, leaves test LEAF rows,
    dead rays do no work."""
    tables = single["tables"]
    rays = [torch.from_numpy(x) for x in _rays(8, 256)]
    kw = dict(any_hit=False, has_inst=False, leaf_size=LEAF,
              n_tris=tables.tris.shape[0])
    hit, st = TW.intersect_wide_plain(tables, *rays, with_stats=True, **kw)
    ref = TW.intersect_wide_plain(tables, *rays, **kw)
    assert all(torch.equal(x, y) for x, y in zip(hit, ref))
    assert st["node_visits"] >= 256 and int(hit.valid.sum()) > 0
    assert st["tri_tests"] > 0 and st["tri_tests"] % LEAF == 0
    o, d, tmin, _ = rays
    dead = TW.intersect_wide_plain(tables, o, d, tmin,
                                   torch.full_like(tmin, -1.0),
                                   with_stats=True, **kw)[1]
    assert dead == {"node_visits": 0, "ranked_visits": 0, "tri_tests": 0}


def test_host_build_matches_reference(single):
    """The port's numpy BVH builder and row tables equal the reference's."""
    tris = _random_mesh(3)
    bvh, order = tbvh.build_bvh(tris[:, 0], tris[:, 1], tris[:, 2],
                                leaf_size=LEAF)
    for x, y in zip(bvh, single["bvh"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(order, single["order"])
    nodes = tbvh.pack_node_table(bvh, len(order), LEAF)
    np.testing.assert_array_equal(nodes, single["nodes"])
    for x, y in zip(tbvh.unpack_node_table(nodes, LEAF), bvh):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which", ["single", "tlas", "blas"])
def test_collapse_matches_reference(single, instanced, which):
    if which == "single":
        bvh, leaf, lm_j = single["bvh"], LEAF, None
    elif which == "blas":
        bvh, leaf, lm_j = instanced["blas"], LEAF, None
    else:
        bvh, leaf = instanced["tlas"], 1
        lm_j = (lambda first, count: JW.INST_BASE + first)
    bj, mj = JW.collapse_wide(bvh, leaf, leaf_meta=lm_j)
    bt, mt, depth = TW.collapse_wide(bvh, leaf, leaf_meta=lm_j)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(mt, mj)
    assert depth >= 1


def test_tables_encode_reference_templates(instanced):
    """Child codes carry the reference's push templates: same child node,
    same leaf, same instance override."""
    tb = instanced["tables"]
    tmpl = np.asarray(instanced["jw"][1]).reshape(-1, TW.WIDTH).astype(np.int64)
    child = tb.child.numpy().astype(np.int64)
    assert tb.blas_root == instanced["jw"][5]
    empty = tmpl == -1
    assert np.array_equal(empty, child == -1)
    ov = tmpl >> 26
    code = tmpl & ((1 << 26) - 1)
    inst = (ov > 0) & ~empty
    leaf = (code >= (1 << 25)) & ~empty & ~inst
    node = ~empty & ~inst & ~leaf
    assert np.array_equal(child[inst], TW.INST_FLAG | (ov[inst] - 1))
    assert np.array_equal(child[leaf] & ~TW.LEAF_FLAG,
                          (code[leaf] - (1 << 25)) >> 5)
    assert np.array_equal(child[node], code[node])
    np.testing.assert_array_equal(tb.inst.numpy().reshape(-1),
                                  np.asarray(instanced["jw"][3]))


def test_plain_matches_tpu_kernel_interpret(single):
    """Closest hit against the reference Pallas kernel in interpret mode."""
    o, d, tmin, tmax = _rays(1, JW.TILE + 17)
    wb, wm, wt, wi, _, _ = single["jw"]
    h = JW.intersect_wide(jnp.asarray(wm), jnp.asarray(wb), jnp.asarray(wt),
                          jnp.asarray(wi), single["mt"].shape[0],
                          jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                          jnp.asarray(tmax), leaf_size=LEAF, interpret=True)
    ref = (np.asarray(h.t), np.asarray(h.index), np.asarray(h.valid))
    got = _plain(single["tables"], o, d, tmin, tmax)
    assert ref[2].sum() > 20
    _same_hits(single["mt"], single["mt"].shape[0], got, ref)


def test_plain_instanced_matches_tpu_kernel_interpret(instanced):
    s = instanced
    rng = np.random.default_rng(7)
    n = 300
    targets = rng.uniform(-4, 5, (n, 3)).astype(np.float32)
    o = (np.array([[0.0, 0.0, 10.0]], np.float32)
         + rng.normal(0, 2, (n, 3)).astype(np.float32))
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full((n,), 1e-3, np.float32)
    tmax = np.full((n,), np.inf, np.float32)
    wb, wm, wt, wi, _, root = s["jw"]
    h = JW.intersect_wide(jnp.asarray(wm), jnp.asarray(wb), jnp.asarray(wt),
                          jnp.asarray(wi), s["mt"].shape[0], jnp.asarray(o),
                          jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
                          leaf_size=LEAF, blas_root=root, has_inst=True,
                          interpret=True)
    ref = (np.asarray(h.t), np.asarray(h.index), np.asarray(h.valid))
    got = _plain(s["tables"], o, d, tmin, tmax, has_inst=True)
    assert ref[2].sum() > 50
    _same_hits(s["mt"], s["mt"].shape[0], got, ref)


def _xla_single(single, o, d, tmin, tmax, any_hit=False):
    h = jbvh.intersect_bvh(jnp.asarray(single["nodes"]),
                           jnp.asarray(single["mt"]), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
                           leaf_size=LEAF, any_hit=any_hit)
    return np.asarray(h.t), np.asarray(h.index), np.asarray(h.valid)


@pytest.mark.parametrize("case", ["closest", "any", "dead"])
def test_plain_matches_xla_walk(single, case):
    """Closest hit, any hit and dead lanes against intersect_bvh."""
    o, d, tmin, tmax = _rays({"closest": 11, "any": 2, "dead": 5}[case], 2000)
    if case == "dead":
        dead = np.zeros(len(o), bool)
        dead[::3] = True
        tmin = np.where(dead, np.inf, tmin).astype(np.float32)
        tmax = np.where(dead, -1.0, tmax).astype(np.float32)
    any_hit = case == "any"
    ref = _xla_single(single, o, d, tmin, tmax)
    got = _plain(single["tables"], o, d, tmin, tmax, any_hit=any_hit)
    assert ref[2].sum() > 50
    if any_hit:
        assert np.array_equal(got[2], ref[2])
        assert np.all(got[0][got[2]] == 0.0)
    else:
        _same_hits(single["mt"], single["mt"].shape[0], got, ref)
    if case == "dead":
        assert not got[2][dead].any()


def test_plain_any_hit_respects_finite_tmax(single):
    """Shadow rays are never occluded by geometry beyond tmax."""
    o, d, tmin, tmax = _rays(7, 2000)
    t_ref, _, valid = _xla_single(single, o, d, tmin, tmax)
    short = np.where(valid, t_ref * 0.9, 0.5).astype(np.float32)
    assert not _plain(single["tables"], o, d, tmin, short, any_hit=True)[2].any()
    long = np.where(valid, t_ref * 1.1, -1.0).astype(np.float32)
    assert np.array_equal(
        _plain(single["tables"], o, d, tmin, long, any_hit=True)[2], valid)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_instanced_matches_xla_walk(instanced, any_hit):
    s = instanced
    rng = np.random.default_rng(9)
    n = 1500
    targets = rng.uniform(-4, 5, (n, 3)).astype(np.float32)
    o = (np.array([[0.0, 0.0, 10.0]], np.float32)
         + rng.normal(0, 2, (n, 3)).astype(np.float32))
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full((n,), 1e-3, np.float32)
    tmax = np.full((n,), np.inf, np.float32)
    h = jbvh.intersect_instances(
        jnp.asarray(s["off"]), jnp.asarray(s["scale"]),
        jnp.asarray(s["blas_nodes"]), jnp.asarray(s["mt"]), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax), leaf_size=LEAF)
    ref = (np.asarray(h.t), np.asarray(h.index), np.asarray(h.valid))
    if any_hit:
        # finite tmax short of / beyond the closest hit
        f = np.where(rng.uniform(size=n) < 0.5, 0.9, 1.1)
        tmax = np.where(ref[2], ref[0] * f, 50.0).astype(np.float32)
        got = _plain(s["tables"], o, d, tmin, tmax, any_hit=True,
                     has_inst=True)
        assert np.array_equal(got[2], ref[2] & (f > 1.0))
    else:
        got = _plain(s["tables"], o, d, tmin, tmax, has_inst=True)
        assert ref[2].sum() > 300
        _same_hits(s["mt"], s["mt"].shape[0], got, ref)


def test_wrapper_validates_inputs(single):
    o, d, tmin, tmax = (torch.from_numpy(x) for x in _rays(1, 8))
    kw = dict(any_hit=False, has_inst=False, leaf_size=LEAF,
              n_tris=single["mt"].shape[0])
    tb = single["tables"]
    with pytest.raises(ValueError, match="contiguous"):
        TW.intersect_wide(tb, o, d.t().contiguous().t(), tmin, tmax, **kw)
    with pytest.raises(ValueError, match="expected"):
        TW.intersect_wide(tb, o.double(), d, tmin, tmax, **kw)
    with pytest.raises(ValueError, match="leaves"):
        TW.intersect_wide(tb, o, d, tmin, tmax, **dict(kw, leaf_size=3))
    with pytest.raises(ValueError, match="planar"):
        TW.intersect_wide(tb._replace(planar=tb.planar.transpose(1, 2)
                                      .contiguous()), o, d, tmin, tmax, **kw)
    # what the kernel's stack and its packed entries cannot hold, decided
    # from shapes alone (expanded tables allocate nothing)
    with pytest.raises(ValueError, match="stack"):
        TW.intersect_wide(tb._replace(depth=TW.STACK // (TW.WIDTH - 1) + 1),
                          o, d, tmin, tmax, **kw)
    n_big = TW.INST_FLAG
    big = tb._replace(child=tb.child[:1].expand(n_big, TW.WIDTH),
                      bounds=tb.bounds[:1].expand(n_big, TW.WIDTH, 6),
                      planar=tb.planar[:1].expand(n_big, 6, TW.WIDTH))
    with pytest.raises(ValueError, match="stack entry"):
        TW.intersect_wide(big, o, d, tmin, tmax, **kw)
    many = tb._replace(inst=tb.inst.expand(2 ** 31 // kw["n_tris"] + 2, 4))
    with pytest.raises(ValueError, match="overflow int32"):
        TW.intersect_wide(many, o, d, tmin, tmax, **dict(kw, has_inst=True))
    n_many = 2 ** 31
    with pytest.raises(ValueError, match="lane index"):
        TW.intersect_wide(tb, o[:1].expand(n_many, 3), d[:1].expand(n_many, 3),
                          tmin[:1].expand(n_many), tmax[:1].expand(n_many),
                          **kw)
    # the counters are the kernel's: there are none on the CPU
    with pytest.raises(ValueError, match="with_stats"):
        TW.intersect_wide(tb, o, d, tmin, tmax, with_stats=True, **kw)


@pytest.mark.parametrize("which", ["single", "instanced"])
def test_planar_bounds_hold_the_node_major_values(single, instanced, which):
    """The kernel's child-planar copy holds exactly the values of
    [N8, 8, 6]: planar[n, r, k] == bounds[n, k, r]."""
    tb = (single if which == "single" else instanced)["tables"]
    assert tb.planar.dtype == torch.float32 and tb.planar.is_contiguous()
    assert tb.planar.shape == (tb.bounds.shape[0], 6, TW.WIDTH)
    assert torch.equal(tb.planar, tb.bounds.transpose(1, 2))
    moved = tb.to("cpu")
    assert torch.equal(moved.planar, tb.planar)


def _cull_rays(which, n=600, seed=5):
    """Rays of which many miss every root child and some are dead: origins
    around the mesh, directions random."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    if which == "instanced":
        o = (o * 0.5 + [0.0, 1.0, 6.0]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmin[::17], tmax[5::19] = np.inf, -1.0
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, tmin, tmax)]


def _kw(tables, which, any_hit=False):
    return dict(any_hit=any_hit, has_inst=which == "instanced", leaf_size=LEAF,
                n_tris=tables.tris.shape[0])


@pytest.mark.parametrize("which", ["single", "instanced"])
def test_root_cull_marks_lanes_whose_root_visit_pushes(single, instanced,
                                                        which):
    """wide_root_cull_plain keeps a lane exactly when its root visit in the
    plain walk pushes a child: the lanes it drops do one node visit each
    (dead ones none) and no triangle test, and each lane it keeps does
    more than its root visit."""
    tb = (single if which == "single" else instanced)["tables"]
    o, d, tmin, tmax = _cull_rays(which)
    kw = _kw(tb, which)
    keep = TW.wide_root_cull_plain(tb, o, d, tmin, tmax)
    live = TW.live_lanes(o, d, tmin, tmax)
    assert not keep[~live].any()
    drop = torch.nonzero(live & ~keep).squeeze(1)
    assert 50 < drop.numel() and 50 < int(keep.sum())
    st = TW.intersect_wide_plain(tb, *(x[drop] for x in (o, d, tmin, tmax)),
                                 with_stats=True, **kw)[1]
    assert st == {"node_visits": drop.numel(), "ranked_visits": 0,
                  "tri_tests": 0}
    for j in torch.nonzero(keep).squeeze(1)[:12].tolist():
        st = TW.intersect_wide_plain(
            tb, *(x[j:j + 1] for x in (o, d, tmin, tmax)), with_stats=True,
            **kw)[1]
        assert st["node_visits"] + st["tri_tests"] > 1, j


@pytest.mark.parametrize("which", ["single", "instanced"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cull_keeps_every_hit_and_drops_to_the_miss(single, instanced, which,
                                                     any_hit):
    """Every lane with a plain-walk hit survives the cull, and a lane the
    cull drops gets exactly the plain walk's miss (t = inf, index 0)."""
    tb = (single if which == "single" else instanced)["tables"]
    o, d, tmin, tmax = _cull_rays(which, seed=6)
    kw = _kw(tb, which, any_hit)
    if any_hit:
        ref = TW.intersect_wide_plain(tb, o, d, tmin, tmax, **_kw(tb, which))
        f = torch.where(torch.arange(o.shape[0]) % 2 == 0, 0.9, 1.1)
        tmax = torch.where(ref.valid, ref.t * f, tmax)
    hit = TW.intersect_wide_plain(tb, o, d, tmin, tmax, **kw)
    keep = TW.wide_root_cull_plain(tb, o, d, tmin, tmax)
    assert int(hit.valid.sum()) > 10
    assert bool(keep[hit.valid].all())
    assert torch.equal(hit.t[~keep], torch.full_like(hit.t[~keep], np.inf))
    assert not hit.index[~keep].any() and not hit.valid[~keep].any()


@pytest.mark.parametrize("which", ["single", "instanced"])
def test_plain_counts_the_ranked_visits(single, instanced, which):
    """ranked_visits counts the node visits that hit two or more children:
    a ray's visits one at a time (its stack after each pop) give the same
    count as the batched walk."""
    tb = (single if which == "single" else instanced)["tables"]
    o, d, tmin, tmax = _cull_rays(which, n=200, seed=8)
    kw = _kw(tb, which)
    st = TW.intersect_wide_plain(tb, o, d, tmin, tmax, with_stats=True,
                                 **kw)[1]
    per_ray = [TW.intersect_wide_plain(
        tb, *(x[j:j + 1] for x in (o, d, tmin, tmax)), with_stats=True,
        **kw)[1] for j in range(o.shape[0])]
    for key in st:
        assert st[key] == sum(p[key] for p in per_ray), key
    assert 0 < st["ranked_visits"] < st["node_visits"]
    # a lane the cull retires hits no child; a ray with one visit ranks none
    assert all(p["ranked_visits"] == 0 for p in per_ray
               if p["node_visits"] <= 1)


def test_plain_equal_keys_match_xla_walk(single):
    """Origins inside the mesh enter every box that holds them at tmin, so
    many children of a node share one key and pop by slot: the hits still
    equal the XLA walk's."""
    rng = np.random.default_rng(13)
    n = 1500
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    ref = _xla_single(single, o, d, tmin, tmax)
    got = _plain(single["tables"], o, d, tmin, tmax)
    assert ref[2].sum() > 100
    _same_hits(single["mt"], single["mt"].shape[0], got, ref)
