"""The CUDA traversal kernels against their plain PyTorch versions, on the
card.

Marked `cuda`: it skips without a GPU. It imports no JAX (the tables come
from the port's own host build), so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Every template of the wide-BVH kernel is held against the plain walk, bit
for bit, with its counted node and leaf visits equal to the plain walk's:
the single-level soup tables (has_inst=False) and the two-level instanced
ones, closest hit and any hit with a finite tmax, and the edges of its cull
and persistent walk (one lane, a ragged count, all lanes dead, no survivor,
one survivor in 2^16 lanes, equal entry keys). Likewise the cull-sweep kernel,
soup and 4 instances, both modes, with and without its counters, and on
the cases its per-ray scan relies on: exact-t ties across two groups and
across two coincident instances, packets in which each group is wanted by
exactly one ray, a ragged batch with dead lanes and an all-dead packet,
a mesh of 8,192 groups (the packed key's limit), of one super-sphere and
of a ragged last super, with the two-level cull's counters consistent. The two
harness kernels, the sweep primitives and the wide kernel's eleven
primitive probes, must equal their plain versions bit for bit. So must the
Threefry kernel of the random streams (lane keys and uniforms) on its
edges: one lane, ragged counts around its 256-lane tiles, every width it
instantiates and widths of its generic instantiation, seed 2^31 - 1 and
pixel 2^20 - 1, with exactly one launch per call, and on keys permuted as
the ray sort permutes them.
The sharded renderer (parallel/) on the card: a world of one NCCL rank and
two gloo ranks sharing the card, each on a px-only mesh, give render_fn's
frame bit for bit.
The compiled wave (models/graph.py): render's graphed frame equals the
eager one (graph=False) bit for bit, with equal stats and launch counts, on
the Cornell box (brute force), a small instanced scene on the wide route
and the same forced onto the sweep, each frame capturing two wave shapes;
two scenes of equal shapes and other material colours through one cache
entry each give their own image; a pack that requires grad makes the
compiled wave raise; render_resumable under the graph equals the
uninterrupted render; on render()'s default a shape is captured after
its eager calls, and its graph's kernel nodes, read through the CUDA driver API,
count what an eager wave launches.
The graphed gradients (models/graph.py, diff/params.py, parallel/train.py):
compile_value_and_grad of a 2-spp frame on the Cornell box and on the
sweep-routed scene, its loss bit for bit with eager value_and_grad's and,
under deterministic algorithms, its gradients too (else within float32's
default tolerances: the atomic adds reorder); build_train_step graphed against eager at (1, 1)
over NCCL; a failed capture raises and caches nothing.
The fused path vertex (ops/shade.py, csrc/shade.cu): both kernels
against their plain versions on every vertex of a wave of a scene with
every material, texture, light and shape kind, on the wide and the sweep
route, bit for bit; the kernel route's frame against the plain route's;
the graphed frame replaying the kernels against the eager one; and
render_fn's gradient (eager and graphed) running the plain vertex.
The brute-force casts (ops/brute.py, csrc/brute.cu): the kernel against
its plain version on 65,536 rays for each kind alone and all four, closest
hit and any hit, with dead lanes, NaN directions, finite tmax and tied
duplicate shapes, bit for bit; more shapes of each kind than one
shared-memory tile; the kernel's own edges (lane compaction on 257^2
and 1025^2 lanes, an any-hit's only hit in the last tile, the triangle
division's edges, 256 and 257 shapes of a kind); a captured cast's replay
against the eager cast; a ray or geometry input that requires grad
refused; render_fn's gradient casting its forward, and none of its
backward, through the kernel.
The casts' set-up and hit reconstruction (ops/rays.py, csrc/rays.cu): the
four kernels against their plain versions on every call of a wave of the
every-kind scene on both routes, the scene of 46 lights and the Cornell
box, and on chip_smoke's edge sets, bit for bit; 16 instanced families
(19 kinds a closest cast, 17 flags a shadow cast) on the edge sets, a
frame and a graphed wave; the kernels' frame against the plain versions';
the graphed wave's kernel nodes and frame against the eager ones; an
input that requires grad, or one the kernels cannot take, refused;
render_fn's gradient running its forward, and none of its backward,
through them.
The wave's glue (ops/wave.py, csrc/wave.cu): the camera, the state permute
and the un-sort against their plain versions on every call of a wave of
the every-kind scene on both routes, the scene of 46 lights and the
Cornell box, and on chip_smoke's edge sets (one lane, ragged counts, pixel
ids past 2^24, every sampler's jitter, NaN and inf colours, dead lanes,
the identity, reversed and seeded perms, the keys' and the debug sampler's
streams), bit for bit; the frames through them against their plain
versions'; the graphed wave's kernel nodes and frame
against the eager ones; an input that requires grad refused; render_fn's
gradient running the camera, and nothing else of them, in its forward.
The vertex's backward (ops/shade.py, csrc/shade_grad.cu): each backward
kernel against its plain version; the kernel's tangent table; the
launches narrowed to a request of fields, each set at the smallest width
that carries it, against the full-width ones, bit for bit, on the bunny
garden, the Cornell box and the every-kind scene; a graphed
value_and_grad's widths by request.
chip_smoke.py covers the bunnies at the main path's shapes.
"""
import contextlib

import numpy as np
import pytest
import torch

from jet_pbrt_tpu_torch.ops import bvh as tbvh
from jet_pbrt_tpu_torch.ops import rng as TR
from jet_pbrt_tpu_torch.ops import sweep_bvh as TS
from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from jet_pbrt_tpu_torch.scripts import prim_micro as PM
from jet_pbrt_tpu_torch.scripts import sweep_prims as SP

LEAF = 4


def _mesh(seed, t, spread, size):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (t, 1, 3)).astype(np.float32)
    tris = base + rng.uniform(-size, size, (t, 3, 3)).astype(np.float32)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    bvh, order = tbvh.build_bvh(p0, p1, p2, leaf_size=LEAF)
    mt = np.concatenate([p0[order], p1[order] - p0[order],
                         p2[order] - p0[order]], axis=1).astype(np.float32)
    return bvh, order, mt


def _soup():
    bvh, _, mt = _mesh(3, 800, 10.0, 0.8)
    return TW.wide_tables(bvh, mt, LEAF), mt, (0.0, 0.0, 12.0)


def _instanced():
    blas, order, mt = _mesh(4, 500, 1.0, 0.3)
    nodes = tbvh.pack_node_table(blas, len(order), LEAF)
    off = np.array([[0, 0, 0], [3, 0, 0], [0, 4, 0], [-3, -1, 2]], np.float32)
    scale = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    lo = nodes[0, :3][None] * scale[:, None] + off
    hi = nodes[0, 3:6][None] * scale[:, None] + off
    tlas, torder = tbvh.build_box_bvh(lo, hi, leaf_size=1)
    return (TW.wide_tables_instanced(tlas, blas, mt, off[torder],
                                     scale[torder], LEAF),
            mt, (0.0, 0.0, 10.0))


def _rays(seed, n, origin, dev):
    rng = np.random.default_rng(seed)
    o = np.repeat(np.asarray(origin, np.float32)[None], n, 0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda x: torch.from_numpy(x).to(dev)
    return (f(o), f(d), f(np.full((n,), 1e-3, np.float32)),
            f(np.full((n,), np.inf, np.float32)))


def _host(h):
    return h.t.cpu().numpy(), h.index.cpu().numpy(), h.valid.cpu().numpy()


def _wide_both_modes(tb, kw, o, d, tmin, tmax):
    """The wide kernel against its plain walk in both modes (any hit with
    tmax 10% short of the closest hit): t, index and valid bit for bit, the
    kernel's node and leaf visits equal to the plain walk's, its survivors
    to the plain root cull's. Returns the closest-hit summary and plain hits."""
    out = None
    tm = tmax
    for any_hit in (False, True):
        before = TW.intersect_wide.launches
        hk, st = TW.intersect_wide(tb, o, d, tmin, tm, any_hit=any_hit,
                                   with_stats=True, **kw)
        assert TW.intersect_wide.launches == before + 1
        hp, sp = TW.intersect_wide_plain(tb, o, d, tmin, tm, any_hit=any_hit,
                                         with_stats=True, **kw)
        for x, y in zip(hk, hp):
            assert torch.equal(x, y), any_hit
        summ = TW.stats_summary(st, kw["leaf_size"])
        assert summ["node_visits"] == sp["node_visits"]
        assert summ["tri_tests"] == sp["tri_tests"]
        assert summ["survivors"] == int(
            TW.wide_root_cull_plain(tb, o, d, tmin, tm).sum())
        assert summ["live"] == int(TW.live_lanes(o, d, tmin, tm).sum())
        if not any_hit:
            out = summ, hp
            tm = torch.where(hp.valid, hp.t * 0.9, torch.full_like(hp.t, 30.0))
            tm = torch.where(tmax < 0, tmax, tm).contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["soup", "instanced"])
def test_kernel_matches_plain_on_card(which):
    """Pinned arithmetic and one child order on both sides: the kernel and
    the plain walk agree bit for bit and count the same visits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    tables, _, origin = _soup() if which == "soup" else _instanced()
    tb = tables.to("cuda")
    kw = dict(has_inst=which == "instanced", leaf_size=LEAF,
              n_tris=tb.tris.shape[0])
    o, d, tmin, tmax = _rays(21, 4096, origin, "cuda")
    summ, hp = _wide_both_modes(tb, kw, o, d, tmin, tmax)
    assert int(hp.valid.sum()) > 100 and summ["survivors"] > 100
    assert summ["node_visits"] > summ["live"]
    assert 0 < summ["simd"] <= 1


def _wide_case(case, which, tables):
    """Rays of one edge case of the wide kernel's cull and persistent walk,
    on the card."""
    rng = np.random.default_rng(41)
    origin = np.array([0.0, 0.0, 12.0 if which == "soup" else 10.0])
    n = {"one-lane": 1, "ragged": 1000 + 7, "all-dead": 777,
         "all-miss": 4096, "one-survivor": 1 << 16,
         "equal-keys": 2048}[case]
    o = np.repeat(origin[None], n, 0)
    d = rng.normal(size=(n, 3))
    if case in ("all-miss", "one-survivor"):
        # straight up, away from the mesh below the origin
        d = np.abs(d) * [0.05, 0.05, 1.0]
    if case in ("one-lane", "one-survivor"):
        # lane n // 3 aims at triangle 0's centroid (in the first instance)
        row = tables.tris[0].numpy().astype(np.float64)
        inst = tables.inst[min(1, tables.inst.shape[0] - 1)].numpy()
        off, scl = inst[:3], float(inst[3])
        target = (row[0:3] + (row[3:6] + row[6:9]) / 3) * scl + off
        d[n // 3] = target - origin
    if case == "equal-keys":
        # origins inside the mesh: every box holding the origin is entered
        # at tmin, so many children of a node share one key
        o = rng.uniform(-0.5, 0.5, (n, 3)) * (4.0 if which == "soup" else 0.5)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3)
    tmax = np.full(n, np.inf)
    if case == "all-dead":
        tmin[::2], tmax[1::2] = np.inf, -1.0
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
    return f(o), f(d), f(tmin), f(tmax)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["soup", "instanced"])
@pytest.mark.parametrize("case", ["one-lane", "ragged", "all-dead",
                                  "all-miss", "one-survivor", "equal-keys"])
def test_wide_kernel_edge_cases_on_card(case, which):
    """The cull and the persistent walk at their edges: one lane, a count
    that is not a multiple of 32, every lane dead, no survivor, one
    survivor in 2^16 lanes, and origins inside several child boxes (equal
    entry keys, ordered by slot); bit for bit in both modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    tables, _, _ = _soup() if which == "soup" else _instanced()
    tb = tables.to("cuda")
    kw = dict(has_inst=which == "instanced", leaf_size=LEAF,
              n_tris=tb.tris.shape[0])
    o, d, tmin, tmax = _wide_case(case, which, tables)
    summ, hp = _wide_both_modes(tb, kw, o, d, tmin, tmax)
    if case == "all-dead":
        assert summ["live"] == 0 and summ["node_visits"] == 0
    elif case == "all-miss":
        assert summ["live"] == o.shape[0] and summ["survivors"] == 0
    elif case in ("one-lane", "one-survivor"):
        assert summ["survivors"] == 1 and bool(hp.valid[o.shape[0] // 3])
    elif case == "equal-keys":
        assert int(hp.valid.sum()) > 10
    else:
        assert summ["survivors"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["soup", "instanced"])
def test_sweep_kernel_matches_plain_on_card(which):
    """Same Moller-Trumbore arithmetic, rounded alike, on both sides: valid
    bits, t and indices agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    if which == "soup":
        _, _, mt = _mesh(3, 800, 10.0, 0.8)
        tables, origin = TS.sweep_tables(mt), (0.0, 0.0, 12.0)
    else:
        _, _, mt = _mesh(4, 500, 1.0, 0.3)
        off = np.array([[0, 0, 0], [3, 0, 0], [0, 4, 0], [-3, -1, 2]],
                       np.float32)
        scale = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
        tables, origin = TS.sweep_tables(mt, off, scale), (0.0, 0.0, 10.0)
    tb = tables.to("cuda")
    n_tris = mt.shape[0]
    o, d, tmin, tmax = _rays(22, 4096 + 77, origin, "cuda")
    dead = torch.arange(o.shape[0], device="cuda") % 9 == 0
    tmin = torch.where(dead, torch.full_like(tmin, float("inf")), tmin)
    tmax = torch.where(dead, torch.full_like(tmax, -1.0), tmax)

    before = TS.intersect_sweep.launches
    hk, stats = TS.intersect_sweep(tb, o, d, tmin, tmax, any_hit=False,
                                   n_tris=n_tris, with_stats=True)
    hp = TS.intersect_sweep_plain(tb, o, d, tmin, tmax, any_hit=False,
                                  n_tris=n_tris)
    assert TS.intersect_sweep.launches == before + 1
    tk, ik, vk = _host(hk)
    tp, ip, vp = _host(hp)
    assert vp.sum() > 100 and not vk[dead.cpu().numpy()].any()
    assert np.array_equal(vk, vp)
    assert np.array_equal(tk[vk], tp[vk]) and np.array_equal(ik[vk], ip[vk])
    assert stats.shape == ((o.shape[0] + 127) // 128, TS.STATS_COLS)
    assert stats.dtype == torch.int64
    st = stats.cpu().numpy()
    assert (st[:, 1] > 0).any() and (st[:, 0] <= max(tables.n_inst, 1)).all()
    # rays per culled instance and per tested group: 1 to 128 each
    assert (st[:, 2] >= st[:, 0]).all() and (st[:, 2] <= 128 * st[:, 0]).all()
    assert (st[:, 3] >= st[:, 1]).all() and (st[:, 3] <= 128 * st[:, 1]).all()
    # cycles in the cull and the scan wherever an instance was culled
    assert ((st[:, 4] > 0) == (st[:, 0] > 0)).all()
    assert ((st[:, 5] > 0) == (st[:, 0] > 0)).all()
    _check_cull_counters(st, tables)
    _check_list_counters(st, tables)

    short = torch.where(hp.valid, hp.t * 0.9, torch.full_like(hp.t, 30.0))
    ak = TS.intersect_sweep(tb, o, d, tmin, short, any_hit=True, n_tris=n_tris)
    ap = TS.intersect_sweep_plain(tb, o, d, tmin, short, any_hit=True,
                                  n_tris=n_tris)
    assert torch.equal(ak.valid, ap.valid)
    long = torch.where(hp.valid, hp.t * 1.1, torch.full_like(hp.t, 30.0))
    ak = TS.intersect_sweep(tb, o, d, tmin, long, any_hit=True, n_tris=n_tris)
    ap = TS.intersect_sweep_plain(tb, o, d, tmin, long, any_hit=True,
                                  n_tris=n_tris)
    assert torch.equal(ak.valid, ap.valid) and bool(ak.valid.any())


def _check_cull_counters(st, tables):
    """The two-level cull's counters [packets, 8] against the rest: (ray,
    super) passes at most the rays past the root x supers, the group
    sphere tests at most 32 a pass and at most the flat cull's rays past
    the root x groups, and at least the scan's ray-group tests (each
    tested pair passed its group's test in the cull)."""
    n_sup = -(-tables.n_groups // TS.SUPER)
    assert (st[:, 6] <= st[:, 2] * n_sup).all()
    assert (st[:, 7] <= TS.SUPER * st[:, 6]).all()
    assert (st[:, 7] <= st[:, 2] * tables.n_groups).all()
    assert (st[:, 7] >= st[:, 3]).all()


def _check_list_counters(st, tables):
    """The scan's list counters [packets, 10]: the groups tested at most
    those popped, these at most those listed, these at most the culls x
    groups, and at least one pop wherever a cull ran."""
    assert (st[:, 1] <= st[:, 9]).all() and (st[:, 9] <= st[:, 8]).all()
    assert (st[:, 8] <= st[:, 0] * tables.n_groups).all()
    assert (st[st[:, 0] > 0, 9] >= 1).all()


def _clusters(nx, ny, seed, spacing=4.0):
    """nx * ny clusters of 128 small triangles on the plane z = 0, rows in
    cluster order, so cluster g is sweep group g; -> rows [T, 9], centres."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    centre = np.stack([gx.ravel() * spacing, gy.ravel() * spacing,
                       np.zeros(nx * ny)], 1)
    shape = (nx * ny, TS.GROUP, 3)
    p0 = centre[:, None] + rng.uniform(-0.5, 0.5, shape)
    e1, e2 = rng.uniform(-0.3, 0.3, (2, *shape))
    mt = np.concatenate([p0, e1, e2], -1).reshape(-1, 9).astype(np.float32)
    return mt, centre.astype(np.float32)


def _aimed(o, target):
    d = target - o
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _sweep_case(case):
    """(tables, n_tris, o, d, tmin, tmax) of one edge case, on the host."""
    rng = np.random.default_rng(31)
    off = np.array([[0, 0, 0], [3, 0, 0], [3, 0, 0], [0, 4, 0]], np.float32)
    scale = np.array([1.0, 2.0, 2.0, 0.5], np.float32)
    if case in ("tie-groups", "tie-instances", "ragged-dead"):
        _, _, mt = _mesh(4, 500, 1.0, 0.3)
        n = 300
        o = np.array([0.0, 0.0, 10.0]) + rng.normal(0, 1.0, (n, 3))
        if case == "tie-groups":
            mt[300] = mt[0]  # row 0 (group 0) again in group 2
            tables = TS.sweep_tables(mt)
            row = np.repeat(mt[0:1], n, 0)
            s, t = rng.uniform(0.05, 0.45, (2, n, 1))
            target = row[:, 0:3] + s * row[:, 3:6] + t * row[:, 6:9]
            # from just off the triangle, on either side: nothing between
            nrm = np.cross(mt[0, 3:6], mt[0, 6:9])
            side = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)[:, None]
            o = target + side * 0.02 * nrm / np.linalg.norm(nrm) \
                + rng.normal(0, 0.003, (n, 3))
        else:
            # instances 1 and 2 coincide
            tables = TS.sweep_tables(mt, off, scale)
            k = 1 if case == "tie-instances" else rng.integers(0, 4, n)
            target = mt[rng.integers(0, len(mt), n), 0:3] \
                * np.atleast_1d(scale[k])[:, None] + off[k]
        o, d = _aimed(o, target)
    elif case == "one-ray-per-group":
        # parallel rays, ray j of each packet straight down onto cluster j
        mt, centre = _clusters(16, 8, 32)
        tables = TS.sweep_tables(mt)
        n = 3 * TS.RAYS + 50
        target = centre[np.arange(n) % TS.RAYS] \
            + np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)),
                              np.zeros((n, 1))], 1)
        o = target + np.array([0.0, 0.0, 10.0])
        d = np.repeat(np.array([[0.0, 0.0, -1.0]]), n, 0)
    elif case in ("one-super", "ragged-super"):
        # 16 clusters (one super) or 70 (two and a ragged third of 6),
        # from a row of origins above the plane, aimed at random clusters
        mt, centre = _clusters(*((4, 4) if case == "one-super" else (10, 7)),
                               34)
        tables = TS.sweep_tables(mt)
        n = 2 * TS.RAYS + 31
        o = np.stack([rng.uniform(0, 40, n), rng.uniform(-10, 30, n),
                      np.full(n, 12.0)], 1)
        o, d = _aimed(o, centre[rng.integers(0, len(centre), n)]
                      + rng.uniform(-0.4, 0.4, (n, 3)))
    elif case == "every-group":
        # ray j runs along column j of the 128 x 64 clusters, just above
        # the plane: the one packet's rays pass all 8,192 groups together
        mt, _ = _clusters(128, 64, 35)
        tables = TS.sweep_tables(mt)
        n = TS.RAYS
        o = np.stack([4.0 * np.arange(n), np.full(n, -10.0),
                      np.full(n, 0.05)], 1)
        d = np.repeat(np.array([[0.0, 1.0, 0.0]]), n, 0)
    else:  # "8192-groups"
        mt, centre = _clusters(128, 64, 33)
        tables = TS.sweep_tables(mt)
        n = 4096 + 77
        o = np.stack([rng.uniform(0, 508, n), rng.uniform(0, 252, n),
                      np.full(n, 30.0)], 1)
        o, d = _aimed(o, centre[rng.integers(0, len(centre), n)]
                      + rng.uniform(-0.3, 0.3, (n, 3)))
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    if case == "ragged-dead":
        dead = (np.arange(n) % 3 == 0) | ((np.arange(n) >= 128)
                                          & (np.arange(n) < 256))
        tmin[dead], tmax[dead] = np.inf, -1.0
    return (tables, mt.shape[0], o.astype(np.float32), d.astype(np.float32),
            tmin, tmax)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tie-groups", "tie-instances",
                                  "one-ray-per-group", "ragged-dead",
                                  "8192-groups", "one-super", "ragged-super",
                                  "every-group"])
def test_sweep_kernel_edge_cases_on_card(case):
    """The per-ray scan against the plain version, bit for bit, closest hit
    and any hit, on the cases it relies on, with the two-level cull's
    counters and the scan's list counters consistent: one super, a ragged
    last super, the 256 supers of 8,192 groups, and a packet that lists
    all 8,192 groups (the list sorted at its largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    tables, n_tris, *rays = _sweep_case(case)
    tb = tables.to("cuda")
    o, d, tmin, tmax = (torch.from_numpy(x).cuda() for x in rays)
    hk, stats = TS.intersect_sweep(tb, o, d, tmin, tmax, any_hit=False,
                                   n_tris=n_tris, with_stats=True)
    hp = TS.intersect_sweep_plain(tb, o, d, tmin, tmax, any_hit=False,
                                  n_tris=n_tris)
    tk, ik, vk = _host(hk)
    tp, ip, vp = _host(hp)
    assert np.array_equal(vk, vp) and vp.sum() > 20
    assert np.array_equal(tk[vk], tp[vk]) and np.array_equal(ik[vk], ip[vk])
    st = stats.cpu().numpy()
    if case == "tie-groups":
        # the duplicate (row 300) never wins over row 0 at the same t
        assert (ip[vp] == 0).sum() > 20 and not (ip[vp] == 300).any()
    elif case == "tie-instances":
        assert (ip[vp] // n_tris == 1).sum() > 20
        assert not (ip[vp] // n_tris == 2).any()
    elif case == "one-ray-per-group":
        # every ray passes the root test, and each tested group has exactly
        # one testing ray
        assert (st[:, 2] == [128, 128, 128, 50]).all()
        assert (st[:, 1] > 0).all() and (st[:, 3] == st[:, 1]).all()
    elif case == "ragged-dead":
        assert not vk[np.isinf(rays[2])].any()
        assert (st[1] == 0).all()  # the all-dead packet exits at once
    elif case == "8192-groups":
        assert tables.n_groups == TS.max_groups()
        assert tables.sup.shape == (8, TS.max_groups() // TS.SUPER)
    elif case == "every-group":
        assert tables.n_groups == TS.max_groups()
        assert st[0, 0] == 1 and st[0, 8] == TS.max_groups()
    else:
        assert tables.n_groups == {"one-super": 16, "ragged-super": 70}[case]
        assert (st[:, 7] > 0).any()
    _check_cull_counters(st, tables)
    _check_list_counters(st, tables)
    for f in (0.9, 1.1):
        tm = torch.where(hp.valid, hp.t * f, torch.full_like(hp.t, 30.0))
        tm = torch.where(tmax < 0, tmax, tm)
        ak = TS.intersect_sweep(tb, o, d, tmin, tm, any_hit=True,
                                n_tris=n_tris)
        ap = TS.intersect_sweep_plain(tb, o, d, tmin, tm, any_hit=True,
                                      n_tris=n_tris)
        assert torch.equal(ak.valid, ap.valid) and torch.equal(ak.t, ap.t)


@pytest.mark.cuda
def test_harness_kernels_match_plain_on_card():
    """K3 against its plain version and the harness's oracle on the
    harness's inputs, seeds 1-3 and keys tied across the window edges at
    lanes 0, 8 and 120, and every K4 probe at a small REPS (the plain
    versions are Python loops): equal bit for bit, mt inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    for seed, ties in ((0, False), (1, False), (2, False), (3, False),
                       (0, True), (1, True), (2, True)):
        an, bn = SP.inputs(seed, ties)
        a, b = torch.from_numpy(an).cuda(), torch.from_numpy(bn).cuda()
        k = SP.sweep_prims(a, b)
        assert torch.equal(k, SP.sweep_prims_plain(a, b)), (seed, ties)
        np.testing.assert_array_equal(k.cpu().numpy(), SP.oracle(an, bn))
    tables = PM.tables("cuda")
    for probe in PM.PROBES:
        table = tables[PM.TABLE_OF[probe]]
        before = PM.prim_micro.launches
        k = PM.prim_micro(probe, table, 48)
        assert PM.prim_micro.launches == before + 1
        p = PM.prim_micro_plain(probe, table, 48)
        assert torch.equal(k, p), probe
        assert bool(torch.isinf(k).all()) if probe == "mt" \
            else bool(torch.isfinite(k).all()), probe


# the kernel's block of 256 lanes: 257 and 3 * 256 + 1 end one lane past a
# tile, 255 one short, so the flat (lane, slot) walk ends ragged
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 4099, 3 * 256 + 1])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 6, 8, 10, 13])
def test_threefry_kernel_matches_plain_on_card(n, s):
    """Lane keys and one purpose's [n, S] uniforms, kernel against plain,
    bit for bit, at every width the kernel instantiates (2, 6, 8, 10) and
    at widths of its generic instantiation (1, 3, 4, 13); pixel ids run to
    2^20 - 1 and the samples vary per lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    rng = np.random.default_rng(n + s)
    pix = rng.integers(0, 1 << 20, n)
    pix[-1] = (1 << 20) - 1
    sample = rng.integers(0, 64, n)
    for seed in (0, 2 ** 31 - 1):
        pc, sc = (torch.from_numpy(x).cuda() for x in (pix, sample))
        before = (TR.lane_keys.launches, TR.uniforms.launches)
        kk = TR.lane_keys(seed, sc, pc)
        kp = TR.lane_keys_plain(seed, sc, pc)
        assert torch.equal(kk.k0, kp.k0) and torch.equal(kk.k1, kp.k1)
        for purpose in (0, 16 + 5):
            uk = TR.uniforms(kk, purpose, s)
            assert torch.equal(uk, TR.uniforms_plain(kp, purpose, s))
            assert uk.shape == (n, s) and float(uk.max()) < 1.0
        assert (TR.lane_keys.launches, TR.uniforms.launches) == (
            before[0] + 1, before[1] + 2)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 8, 13])
def test_threefry_draw_of_permuted_keys_on_card(s):
    """Keys permuted as the ray sort permutes lanes: the kernel's draw of
    the permuted keys is the permuted draw, and equals the plain version's,
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    n = 4099
    rng = np.random.default_rng(s)
    pix, sample = (torch.from_numpy(x).cuda() for x in (
        rng.permutation(1 << 20)[:n], rng.integers(0, 64, n)))
    keys = TR.lane_keys(7, sample, pix)
    perm = torch.from_numpy(rng.permutation(n)).cuda()
    moved = TR.LaneKeys(keys.k0[perm], keys.k1[perm], keys.sample[perm])
    for purpose in (0, 16 + 3):
        u = TR.uniforms(moved, purpose, s)
        assert torch.equal(u, TR.uniforms(keys, purpose, s)[perm])
        assert torch.equal(u, TR.uniforms_plain(moved, purpose, s))


@pytest.mark.cuda
@pytest.mark.parametrize("arg", ["o", "d", "tmin", "tmax"])
@pytest.mark.parametrize("which", ["wide", "sweep"])
def test_kernels_refuse_inputs_that_require_grad(which, arg):
    """A launch reads raw pointers and has no backward: the CUDA route of
    each traversal kernel raises, launching nothing, when a ray or interval
    input requires grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    bvh, _, mt = _mesh(3, 800, 10.0, 0.8)
    rays = dict(zip(("o", "d", "tmin", "tmax"),
                    _rays(5, 300, (0.0, 0.0, 12.0), "cuda")))
    rays[arg] = rays[arg].clone().requires_grad_(True)
    if which == "wide":
        tb, fn = TW.wide_tables(bvh, mt, LEAF).to("cuda"), TW.intersect_wide
        kw = dict(has_inst=False, leaf_size=LEAF, n_tris=mt.shape[0])
    else:
        tb, fn = TS.sweep_tables(mt).to("cuda"), TS.intersect_sweep
        kw = dict(n_tris=mt.shape[0])
    before = fn.launches
    with pytest.raises(ValueError, match="require grad"):
        fn(tb, *rays.values(), any_hit=False, **kw)
    assert fn.launches == before
    rays[arg] = rays[arg].detach()
    fn(tb, *rays.values(), any_hit=False, **kw)
    assert fn.launches == before + 1


def _grad_scene():
    """A textured matte floor, a rough metal and a plastic instanced mesh
    (the wide kernel's route) under an area light, no environment."""
    from jet_pbrt_tpu_torch.scene.builder import SceneBuilder
    rng = np.random.default_rng(9)
    b = SceneBuilder("grad-card")
    b.set_camera(lookfrom=(0, 1.5, 9), lookat=(0, 0, 0), vfov=55)
    tex = b.add_image_texture(rng.uniform(0.2, 0.9, (4, 4, 3)),
                              bilinear=True)
    b.add_rect_xz(-6, 6, -6, 6, -2, b.add_matte((1, 1, 1), tex=tex))
    metal = b.add_metal((0.2, 0.9, 1.1), (3.9, 2.4, 2.1), 0.25, 0.25)
    plastic = b.add_plastic((0.5, 0.3, 0.2), (0.4, 0.4, 0.4), 0.3)
    b.add_sphere((2.5, -0.8, 0.5), 1.2, metal)
    base = rng.uniform(-1, 1, (300, 1, 3))
    b.add_instanced_mesh(base + rng.uniform(-0.3, 0.3, (300, 3, 3)),
                         [((0, 0, 0), 1.2, plastic), ((-2.5, 0, 0), 0.8,
                                                      plastic)])
    b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, 4, b.add_matte(
        (0.6, 0.6, 0.6)), flip_normal=True), (8.0, 8.0, 8.0))
    return b.build()


@pytest.mark.cuda
def test_render_fn_gradients_on_card_match_cpu():
    """render_fn at depth 2 on the card (wide kernel with its ray sort,
    Threefry kernel) against the port on the CPU. The card's libm rounds
    some rays' directions an ulp apart, which moves a lane that grazes an
    edge onto another path: at most 8 of the 256 pixels may differ beyond
    rtol 1e-4 / atol 1e-5. The gradients of the mean over the pixels that
    agree, in albedo, roughness, emission and texels, agree within rtol
    1e-4 where |g| > 1e-6 (atomic adds sum in another order). The
    backward launches no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models.render import render_fn
    scene = _grad_scene()
    assert scene.meta.wide_blas == (True,) and scene.meta.n_tex == 1
    fields = ("mat_c0", "mat_s0", "light_c", "tex_image")
    fns = {dev: render_fn(scene, 16, 16, 2, seed=4, max_depth=2, device=dev)
           for dev in ("cpu", "cuda")}
    with torch.no_grad():
        ic, ig = (fn(pk).cpu().numpy() for fn, pk in fns.values())
    same = np.all(np.isclose(ig, ic, rtol=1e-4, atol=1e-5), axis=-1)
    assert (~same).sum() <= 8, int((~same).sum())
    grads = {}
    for dev, (fn, pk) in fns.items():
        mask = torch.from_numpy(same).to(dev)[..., None]
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in P.get_params(pk, fields).items()}
        val = torch.sum(fn(P.with_params(pk, leaves)) * mask) / mask.sum()
        launches = (TW.intersect_wide.launches, TR.uniforms.launches)
        g = torch.autograd.grad(val, list(leaves.values()))
        assert (TW.intersect_wide.launches, TR.uniforms.launches) == launches
        grads[dev] = {k: x.cpu().numpy() for k, x in zip(fields, g)}
    gc, gg = grads["cpu"], grads["cuda"]
    for k in fields:
        assert np.isfinite(gg[k]).all(), k
        big = np.abs(gc[k]) > 1e-6
        assert big.any(), k
        np.testing.assert_allclose(gg[k][big], gc[k][big], rtol=1e-4,
                                   err_msg=k)


def _rank_sharded(rank, scene, world):
    from jet_pbrt_tpu_torch.parallel.mesh import make_mesh
    from jet_pbrt_tpu_torch.parallel.render import render_sharded
    img = render_sharded(scene, 64, 64, 2, make_mesh(px=world), seed=3,
                         max_depth=3, clamp=False)
    assert img.device.type == "cuda"
    return img.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_sharded_render_on_card_equals_render_fn(backend, world):
    """render_sharded at 64^2, 2 spp, depth 3 on a (world, 1) mesh of ranks
    on the card (NCCL at one rank; gloo for two ranks sharing the card)
    equals render_fn's frame on the card bit for bit, on every rank. The
    parent builds the kernels first; the ranks load them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models.render import render_fn
    from test_torch_multihost import run_world
    scene = _grad_scene()
    fn, pk = render_fn(scene, 64, 64, 2, seed=3, max_depth=3, device="cuda")
    with torch.no_grad():
        ref = fn(pk).cpu()
    for img in run_world(_rank_sharded, world, scene, world,
                         backend=backend):
        assert torch.equal(img, ref)


def _graph_scene(which, monkeypatch):
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    if which == "cornell":
        return cornell_box()
    if which == "sweep":
        monkeypatch.setattr(TW, "_VMEM_BUDGET", 1024)
    scene = _grad_scene()
    assert scene.meta.pallas_blas == ((which == "sweep"),)
    return scene


def _launches():
    return (TW.intersect_wide.launches, TS.intersect_sweep.launches,
            TR.lane_keys.launches + TR.uniforms.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cornell", "wide", "sweep"])
def test_graphed_frame_equals_eager_on_card(which, monkeypatch):
    """48^2, 3 spp in waves of two samples: the frame captures two shapes
    (two samples, then the short last one). After the capturing frame, a
    replayed frame's image, stats and launches equal the eager frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render
    scene = _graph_scene(which, monkeypatch)
    kw = dict(spp=3, seed=5, max_depth=4, clamp=False, device="cuda",
              with_stats=True, chunk=5000)
    G.clear()
    render(scene, 48, 48, graph=True, **kw)
    assert len(G.CACHE.entries) == 2
    runs = {}
    for graph in (True, False):
        before = _launches()
        img, st = render(scene, 48, 48, graph=graph, **kw)
        torch.cuda.synchronize()
        runs[graph] = (img, st, tuple(a - b for a, b in
                                      zip(_launches(), before)))
    (gi, gs, gl), (ei, es, el) = runs[True], runs[False]
    assert torch.equal(gi, ei) and gs == es and gl == el, (gs, es, gl, el)
    route = {"cornell": None, "wide": 0, "sweep": 1}[which]
    assert all((k > 0) == (i == route) for i, k in enumerate(gl[:2])), gl
    assert gl[2] > 0 and gs["rays"] > 0
    G.clear()


@pytest.mark.cuda
def test_one_cache_entry_renders_each_pack_on_card():
    """Two scenes of equal shapes and other material colours, back to
    back through one captured wave: each image equals its eager render."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import dataclasses
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    a = cornell_box()
    b = dataclasses.replace(a, pack=a.pack._replace(
        mat_c0=a.pack.mat_c0.flip(0).contiguous()))
    G.clear()
    imgs = [render(s, 32, 32, 2, seed=1, device="cuda", graph=True).clone()
            for s in (a, b, a)]
    assert len(G.CACHE.entries) == 1
    for s, img in zip((a, b, a), imgs):
        assert torch.equal(img, render(s, 32, 32, 2, seed=1, device="cuda",
                                       graph=False))
    assert not torch.equal(imgs[0], imgs[1])
    G.clear()


@pytest.mark.cuda
def test_compiled_wave_refuses_a_pack_that_requires_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import compiled_wave_fn, render, \
        setup
    import dataclasses
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    scene = cornell_box()
    _, pack, cam = setup(scene, 16, 16, "cuda")
    pack = pack._replace(mat_c0=pack.mat_c0.clone().requires_grad_(True))
    pixel = torch.arange(256, device="cuda")
    wave = compiled_wave_fn(scene.meta, 16, 3)
    with pytest.raises(ValueError, match="requires grad"):
        wave(pack, cam, torch.zeros_like(pixel), pixel)
    with torch.enable_grad(), pytest.raises(ValueError, match="requires grad"):
        render(dataclasses.replace(scene, pack=pack), 16, 16, 1,
               device="cuda")
    G.clear()


@pytest.mark.cuda
def test_render_resumable_graphed_on_card(tmp_path):
    """Stopped after 2 of 4 samples and resumed, through the compiled
    wave: equal to the uninterrupted run and to render(graph=False)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    from jet_pbrt_tpu_torch.utils import checkpoint as ck
    scene = cornell_box()
    G.clear()
    whole = ck.render_resumable(scene, 40, 40, 4, str(tmp_path / "a.npz"),
                                seed=7, device="cuda", graph=True)
    assert len(G.CACHE.entries) == 1
    path = str(tmp_path / "b.npz")
    ck.render_resumable(scene, 40, 40, 2, path, seed=7, device="cuda",
                        graph=True)
    resumed = ck.render_resumable(scene, 40, 40, 4, path, seed=7,
                                  device="cuda", graph=True)
    assert torch.equal(resumed, whole)
    assert torch.equal(whole, render(scene, 40, 40, 4, seed=7, device="cuda",
                                     graph=False))
    G.clear()


@pytest.mark.cuda
def test_default_captures_after_eager_calls_on_card(monkeypatch):
    """On render()'s default a wave shape runs op by op for its first
    CAPTURE_AFTER calls and is captured at the next; the captured graph's
    kernel nodes, read through the CUDA driver API, are the launches an eager wave
    counts, and a replay adds them; every image equals the eager one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render
    scene = _graph_scene("wide", monkeypatch)
    kw = dict(spp=1, seed=3, max_depth=4, device="cuda")
    G.clear()
    before = _launches()
    want = render(scene, 32, 32, graph=False, **kw)
    eager = tuple(a - b for a, b in zip(_launches(), before))
    for call in range(G.CAPTURE_AFTER + 2):
        before = _launches()
        img = render(scene, 32, 32, **kw)
        torch.cuda.synchronize()
        assert len(G.CACHE.entries) == (call >= G.CAPTURE_AFTER)
        assert torch.equal(img, want) and eager[0] > 0
        assert tuple(a - b for a, b in zip(_launches(), before)) == eager
    entry = next(iter(G.CACHE.entries.values()))
    assert (entry.launches["wide_walk_kernel"], entry.launches[
        "sweep_bvh_kernel"], entry.launches["lane_keys_kernel"]
        + entry.launches["uniforms_kernel"]) == eager
    from jet_pbrt_tpu_torch.ops.kernels import is_function
    names = G.kernel_names(entry.graph)
    assert sum(is_function(n, "wide_cull_kernel") for n in names) \
        == eager[0], sorted(set(names))
    G.clear()


@contextlib.contextmanager
def _deterministic(on: bool):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _held_to_eager(got, eager, deterministic: bool):
    """A graphed (loss, grads) against eager ones of the same params: the
    loss bit for bit; the gradients bit for bit under deterministic
    algorithms, else within torch.testing's float32 tolerances: the
    backward's atomic adds sum in another order on every run, and a
    replayed graph's order need not be an eager run's (at 16^2 six eager
    gradients lay within 2^-36 of each other and the graphed one 2^-35
    from them; chip_smoke.py holds the graphed gradient to the eager runs'
    spread at the main path's size)."""
    (val, g), (val0, g0) = got, eager
    assert torch.equal(val, val0), (float(val), float(val0))
    for k in g0:
        if deterministic:
            assert torch.equal(g[k], g0[k]), k
        else:
            torch.testing.assert_close(g[k], g0[k])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "deterministic"])
@pytest.mark.parametrize("which", ["cornell", "sweep"])
def test_graphed_value_and_grad_on_card(which, mode, monkeypatch):
    """compile_value_and_grad of a 16^2, 2-spp, depth-3 render_fn loss in
    albedo, roughness and emission (the Cornell box by brute force; the
    textured instanced scene forced onto the sweep kernel): the capturing
    call, two replays and a replay of other params, each held to eager
    value_and_grad's (_held_to_eager); the graph's kernel nodes are the
    eager forward's launches, which each replay counts (the capturing call
    counts its GRAD_WARMUPS eager warm-ups); one cache entry, released by
    vg.release()."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render_fn
    fn, pack = render_fn(_graph_scene(which, monkeypatch), 16, 16, 2, seed=1,
                         max_depth=3, device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    f = P.loss_fn(fn, pack, target)
    params = P.get_params(pack, ("mat_c0", "mat_s0", "light_c"))
    G.clear()
    with _deterministic(mode == "deterministic"):
        vg = P.compile_value_and_grad(f)
        for call, scale in enumerate((1.0, 1.0, 1.0, 0.8)):
            p = {k: v * scale for k, v in params.items()}
            before = _launches()
            eager = P.value_and_grad(f, p)
            launched = tuple(a - b for a, b in zip(_launches(), before))
            before = _launches()
            val, g = vg(p)
            torch.cuda.synchronize()
            # the capturing call's warm-ups launch, its capture does not
            runs = G.GRAD_WARMUPS if call == 0 else 1
            assert tuple(a - b for a, b in zip(_launches(), before)) \
                == tuple(runs * n for n in launched)
            _held_to_eager((val.clone(), {k: x.clone() for k, x in g.items()}),
                           eager, mode == "deterministic")
        entry = next(iter(G.GRAD_CACHE.entries.values()))
        assert len(G.GRAD_CACHE.entries) == 1 and entry.pool_bytes > 0
        assert (entry.launches["wide_walk_kernel"],
                entry.launches["sweep_bvh_kernel"],
                entry.launches["lane_keys_kernel"]
                + entry.launches["uniforms_kernel"]) == launched
        assert launched[0] == 0 and launched[2] > 0
        assert (launched[1] > 0) == (which == "sweep")
        vg.release()
        assert not G.GRAD_CACHE.entries
    G.clear()


def _rank_train_graphed(rank, scene, mode):
    """Three steps at (1, 1) graphed (graph=True) and eager (graph=False)
    from one wrong albedo: (losses and params of each, the graphed entry's
    launches per replay and pool bytes)."""
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.parallel.mesh import make_mesh
    from jet_pbrt_tpu_torch.parallel.train import build_train_step
    mesh = make_mesh(1, 1)
    out = {}
    with _deterministic(mode == "deterministic"):
        for graph in (True, False):
            step, init, render, cam = build_train_step(
                scene, mesh, 16, 16, 2, fields=("mat_c0", "light_c"),
                lr=0.5, max_depth=3, graph=graph)
            target = render.frame(scene.pack.to("cuda"), cam)
            params = init()
            params["mat_c0"] = params["mat_c0"] * 0.5 + 0.1
            losses = []
            for _ in range(3):
                params, loss = step(params, target)
                losses.append(loss.cpu())
            out[graph] = (losses, {k: v.cpu() for k, v in params.items()})
        entry = next(iter(G.GRAD_CACHE.entries.values()))
        out["entry"] = (entry.graphs.launches, entry.graphs.pool_bytes)
    G.clear()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "deterministic"])
def test_graphed_train_step_on_card(mode):
    """build_train_step at (1, 1) over NCCL on the textured instanced scene
    (wide route), 16^2, 2 spp, depth 3: three graphed steps against three
    eager ones. The first loss is bit for bit in both modes (the forward
    is); under deterministic algorithms every loss and the fitted params
    too. The forward graph holds the wave's kernels, the backward graph
    the backward kernels (per sample one vertex_backward a tangent set,
    matte and metal with plastic, at each vertex below max_depth and one
    on the last, one grad_reduce a vertex, one permute_state_backward a
    sort, one unsort_guard_backward) and no forward kernel; the pool holds
    the tape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from test_torch_multihost import run_world
    (got,) = run_world(_rank_train_graphed, 1, _grad_scene(), mode,
                       backend="nccl")
    (gl, gp), (el, ep) = got[True], got[False]
    assert torch.equal(gl[0], el[0]) and gl[0] > 0
    if mode == "deterministic":
        assert all(torch.equal(a, b) for a, b in zip(gl, el))
        assert all(torch.equal(gp[k], ep[k]) for k in ep)
    else:
        np.testing.assert_allclose(torch.stack(gl).numpy(),
                                   torch.stack(el).numpy(), rtol=1e-5)
    launches, pool = got["entry"]
    assert launches["forward"]["wide_walk_kernel"] > 0
    assert launches["forward"]["lane_keys_kernel"] == 2
    back = {"vertex_backward_kernel": 14, "grad_reduce_kernel": 8,
            "permute_state_backward_kernel": 6,
            "unsort_guard_backward_kernel": 2}
    assert {k: v for k, v in launches["backward"].items() if v} == back
    assert pool > 0


@pytest.mark.cuda
def test_failed_gradient_capture_raises_and_caches_nothing():
    """A loss that copies host data to the card inside its forward cannot
    be captured: the compiled value_and_grad raises at its capture, and
    again at the next call (nothing falls back to the eager path); no cache
    entry is left and the launch counters are as before."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models import graph as G

    def f(params):
        shift = torch.tensor([0.25], device="cuda")  # a host copy
        return ((params["a"] + shift) ** 2).sum()

    G.clear()
    vg = P.compile_value_and_grad(f)
    params = {"a": torch.linspace(0, 1, 8, device="cuda")}
    before = _launches()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture"):
            vg(params)
        assert not G.GRAD_CACHE.entries
    assert _launches() == before
    val, g = P.value_and_grad(f, params)
    assert torch.allclose(g["a"], 2 * (params["a"] + 0.25))
    G.clear()


# the fused path vertex (ops/shade.py, csrc/shade.cu)

def _shade_counts():
    from jet_pbrt_tpu_torch.ops import shade as SH
    return SH.shade_vertex.launches, SH.nee_accumulate.launches


def _shade_scene(which: str):
    import chip_smoke
    if which == "many-lights":
        return chip_smoke.many_lights_scene().to("cuda")
    return chip_smoke.every_kind_scene(which == "sweep").to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "sweep", "many-lights"])
def test_fused_vertex_matches_plain_on_card(which):
    """Every vertex of a 64^2, 1-spp, depth-5 wave of chip_smoke's
    every-kind scene (every material, texture, light and shape kind; the
    instanced mesh on the wide kernel or forced onto the sweep) or its
    scene of 46 lights: the kernels against their plain versions on the
    recorded inputs, every output bit for bit (NaN equal to NaN), six
    shade_vertex and five nee_accumulate calls; then the kernel route's
    frame and stats against the plain route's, bit for bit
    (chip_smoke.vertex_phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    scene = _shade_scene(which)
    out = chip_smoke.vertex_phase(((which, scene, 64),), torch.device("cuda"),
                                  "card")
    assert out[which]["vertices"] == 6 and out[which]["accumulates"] == 5
    assert out[which]["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_fused_route_frame_equals_plain_route_on_card():
    """The Cornell box at 32^2, 3 spp, eager: the frame through the
    kernels equals the frame with the plain versions set in the wrappers'
    places, image and stats bit for bit; the kernels launched once per
    vertex."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.models.render import render
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    kw = dict(spp=3, seed=2, max_depth=5, clamp=False, device="cuda",
              with_stats=True, graph=False)
    scene = cornell_box()
    before = _shade_counts()
    img, st = render(scene, 32, 32, **kw)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(_shade_counts(), before))
    with chip_smoke.plain_vertex():
        pimg, pst = render(scene, 32, 32, **kw)
    assert torch.equal(img, pimg) and st == pst
    assert launched == (6, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "many-lights"])
def test_graphed_frame_replays_the_fused_vertex_on_card(which):
    """The every-kind scene or the scene of 46 lights at 32^2, 2 spp: the
    captured wave's graph holds depth + 1 shade_vertex and depth
    nee_accumulate kernel nodes, a replayed frame counts them, and its
    image and stats equal the eager frame's bit for bit. The light
    table's static part is made anew here, by the capture's warm-up
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render
    from jet_pbrt_tpu_torch.ops import shade as SH
    scene = _shade_scene(which)
    kw = dict(spp=2, seed=4, max_depth=5, clamp=False, device="cuda",
              with_stats=True)
    G.clear()
    SH._STATICS.clear()
    render(scene, 32, 32, graph=True, **kw)
    (entry,) = G.CACHE.entries.values()
    assert (entry.launches["shade_vertex_kernel"],
            entry.launches["nee_accumulate_kernel"]) == (6, 5)
    runs = {}
    for graph in (True, False):
        before = _shade_counts()
        img, st = render(scene, 32, 32, graph=graph, **kw)
        torch.cuda.synchronize()
        runs[graph] = (img, st, tuple(a - b for a, b in
                                      zip(_shade_counts(), before)))
    (gi, gs, gl), (ei, es, el) = runs[True], runs[False]
    assert torch.equal(gi, ei) and gs == es and gl == el == (6, 5)
    G.clear()


@pytest.mark.cuda
def test_render_fn_gradient_takes_the_plain_vertex_on_card():
    """render_fn's gradient in the appearance fields runs the fused
    vertex forward and its backward kernels: the eager value_and_grad
    launches one shade_vertex a vertex and one nee_accumulate a vertex
    below max_depth, and its backward one vertex_backward a tangent set
    (matte, metal) a vertex below max_depth and one on the last, and one
    grad_reduce a vertex; the graphed one's graph holds both as kernel
    nodes; with a field outside them on the tape (the lights' positions)
    it runs the plain vertex and no backward kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render_fn
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    fn, pack = render_fn(cornell_box(), 16, 16, 1, seed=1, max_depth=3,
                         device="cuda")
    with torch.no_grad():
        before = _shade_counts()
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_shade_counts(), before)) == (4, 3)
    f = P.loss_fn(fn, pack, target)
    params = P.get_params(pack, ("mat_c0", "light_c"))
    from jet_pbrt_tpu_torch.ops import shade as SH
    grads = lambda: (SH.vertex_backward.launches, SH.grad_reduce.launches)
    before, gbefore = _shade_counts(), grads()
    P.value_and_grad(f, params)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_shade_counts(), before)) == (4, 3)
    assert tuple(a - b for a, b in zip(grads(), gbefore)) == (7, 4)
    before, gbefore = _shade_counts(), grads()
    fn(pack._replace(light_pos=pack.light_pos.clone().requires_grad_()))
    torch.cuda.synchronize()
    assert _shade_counts() == before and grads() == gbefore
    G.clear()
    vg = P.compile_value_and_grad(f)
    for _ in range(2):
        vg(params)
    torch.cuda.synchronize()
    entry = next(iter(G.GRAD_CACHE.entries.values()))
    assert entry.launches["shade_vertex_kernel"] == 4
    assert entry.launches["nee_accumulate_kernel"] == 3
    assert entry.launches["vertex_backward_kernel"] == 7
    assert entry.launches["grad_reduce_kernel"] == 4
    assert entry.launches["uniforms_kernel"] > 0
    # the capture's warm-ups ran eagerly, the second call replayed
    assert tuple(a - b for a, b in zip(_shade_counts(), before)) == (
        (G.GRAD_WARMUPS + 1) * 4, (G.GRAD_WARMUPS + 1) * 3)
    vg.release()
    G.clear()


def _brute_inputs(kinds, n, seed, counts=None):
    """Seeded rays (three in four aimed into the shapes' box; a tenth of
    the lanes dead, some with NaN directions; a fifth with finite tmax)
    and brute-force shapes of `kinds` on the card, `counts` shapes per
    kind (default 24), each kind's first 4 shapes present twice."""
    from jet_pbrt_tpu_torch.ops.intersect import BruteShapes
    rs = np.random.default_rng(seed)
    counts = counts or {}
    f = lambda x: torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.float32)).to("cuda")
    shapes = {}
    for k in kinds:
        m = counts.get(k, 24)
        if k == "tri":
            p0 = rs.uniform(-2, 2, (m, 3))
            x = (p0, p0 + rs.uniform(-1, 1, (m, 3)),
                 p0 + rs.uniform(-1, 1, (m, 3)))
        elif k == "sph":
            x = (rs.uniform(-2, 2, (m, 3)), rs.uniform(0.05, 0.6, m))
        elif k == "rect":
            c = rs.uniform(-2, 2, (m, 1, 3))
            sq = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
            x = (c + sq[None] * rs.uniform(0.2, 1.0, (m, 1, 1)),
                 np.tile([[0.0, 0.0, 1.0]], (m, 1)))
        else:
            nrm = rs.normal(size=(m, 3))
            x = (rs.uniform(-2, 2, (m, 3)),
                 nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
                 rs.uniform(0.2, 1.0, m))
        shapes[k] = tuple(f(np.concatenate([a[:4], a])) for a in x)
    o = rs.uniform(-3, 3, (n, 3))
    d = np.where((np.arange(n) % 4 != 0)[:, None],
                 rs.uniform(-1.5, 1.5, (n, 3)) - o, rs.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3)
    tmax = np.where(rs.uniform(size=n) < 0.8, np.inf, rs.uniform(0.5, 5, n))
    dead = np.arange(n) % 10 == 3
    d[dead & (np.arange(n) % 20 == 3)] = np.nan
    tmin[dead], tmax[dead] = np.inf, -1.0
    return ((f(o), f(d), f(tmin), f(tmax)),
            BruteShapes(**{k: shapes.get(k) for k in BruteShapes._fields}))


def _brute_equal(got, want, any_hit):
    if any_hit:
        assert got.dtype == torch.bool and torch.equal(got, want)
        return int(got.sum())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.t.view(torch.int32), w.t.view(torch.int32))
        assert torch.equal(g.index, w.index) and torch.equal(g.valid, w.valid)
    return sum(int(g.valid.sum()) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kinds", ["tri", "sph", "rect", "disk", "all"])
def test_brute_kernel_matches_plain_on_card(kinds, any_hit):
    """The brute-force kernel against its plain version on 65,536 rays,
    each kind alone and all four, closest hit (every kind's t bits, index
    and valid) and any hit, bit for bit, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.ops import brute as TBR
    from jet_pbrt_tpu_torch.ops.intersect import brute_hits_plain
    ks = ("tri", "sph", "rect", "disk") if kinds == "all" else (kinds,)
    rays, shapes = _brute_inputs(ks, 1 << 16, 31)
    before = TBR.brute_hits.launches
    got = TBR.brute_hits(*rays, shapes, any_hit)
    assert TBR.brute_hits.launches == before + 1
    hits = _brute_equal(got, brute_hits_plain(*rays, shapes, any_hit),
                        any_hit)
    assert hits > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_brute_kernel_beyond_one_tile_on_card(any_hit):
    """More shapes of each kind than one shared-memory tile (3,000
    spheres, 2,000 triangles, 600 rects, 300 disks): bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.ops import brute as TBR
    from jet_pbrt_tpu_torch.ops.intersect import brute_hits_plain
    rays, shapes = _brute_inputs(
        ("tri", "sph", "rect", "disk"), 8192, 32,
        {"tri": 2000, "sph": 3000, "rect": 600, "disk": 300})
    got = TBR.brute_hits(*rays, shapes, any_hit)
    hits = _brute_equal(got, brute_hits_plain(*rays, shapes, any_hit),
                        any_hit)
    assert hits > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["compaction", "compaction 1025^2",
                                  "last tile", "division", "256 shapes",
                                  "257 shapes"])
def test_brute_kernel_edge_cases_on_card(case):
    """The kernel's own edge cases, closest hit and any hit, bit for bit
    with the plain version: 257^2 lanes, and 1025^2 lanes (the kernel's
    large span) against 129 shapes of each kind (two tiles), in
    chip_smoke.compaction_lanes' quarters (all-dead blocks, one live lane
    in 2,048, live lanes only at the last slots of every 256, NaN and inf
    directions on live lanes; no block span divides either count); an
    any-hit whose only hit is the last of
    300 spheres (last_tile_set); the triangle division's edges
    (division_set: subnormal and infinite 1 / det, det at the 1e-12
    threshold, a NaN vertex); exactly 256 and 257 shapes of each kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.ops import brute as TBR
    from jet_pbrt_tpu_torch.ops.intersect import brute_hits_plain
    dev = torch.device("cuda")
    ks = ("tri", "sph", "rect", "disk")
    any_tmax = None
    if case.startswith("compaction"):
        rays, shapes = (
            _brute_inputs(ks, 257 * 257, 36) if case == "compaction"
            else _brute_inputs(ks, 1025 * 1025, 38, dict.fromkeys(ks, 129)))
        rays = chip_smoke.compaction_lanes(*rays)
    elif case == "last tile":
        *rays, shapes = chip_smoke.last_tile_set(1 << 14, dev)
        any_tmax = rays[3]
    elif case == "division":
        *rays, shapes = chip_smoke.division_set(1 << 14, dev)
    else:
        m = int(case.split()[0])
        rays, shapes = _brute_inputs(ks, 8192, 37, dict.fromkeys(ks, m))
    if any_tmax is None:
        any_tmax = chip_smoke.short_of_closest(*rays, shapes)
    hits = 0
    for any_hit, tmax in ((False, rays[3]), (True, any_tmax)):
        args = (*rays[:3], tmax, shapes, any_hit)
        before = TBR.brute_hits.launches
        got = TBR.brute_hits(*args)
        assert TBR.brute_hits.launches == before + 1
        hits += _brute_equal(got, brute_hits_plain(*args), any_hit)
    assert hits > 100


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_brute_cast_replays_from_a_graph_on_card(any_hit):
    """A captured brute-force cast (the graph holds one brute_hits_kernel
    node), replayed on new rays copied into its inputs, equals the eager
    cast on those rays bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.ops import brute as TBR
    ks = ("tri", "sph", "rect", "disk")
    rays, shapes = _brute_inputs(ks, 4096, 33)
    new, _ = _brute_inputs(ks, 4096, 34)
    static = [x.clone() for x in rays]
    cast = lambda: TBR.brute_hits(*static, shapes, any_hit)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cast()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = cast()
    from jet_pbrt_tpu_torch.ops.kernels import is_function
    assert sum(is_function(name, "brute_hits_kernel")
               for name in G.kernel_names(g)) == 1
    for x, y in zip(static, new):
        x.copy_(y)
    g.replay()
    torch.cuda.synchronize()
    _brute_equal(out, TBR.brute_hits(*new, shapes, any_hit), any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("arg", ["o", "tmin", "tri_p0", "sph_r"])
def test_brute_kernel_refuses_inputs_that_require_grad(arg):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.ops import brute as TBR
    rays, shapes = _brute_inputs(("tri", "sph"), 300, 35)
    t = dict(zip(("o", "d", "tmin", "tmax"), rays))
    t["tri_p0"], t["sph_r"] = shapes.tri[0], shapes.sph[1]
    t[arg] = t[arg].clone().requires_grad_(True)
    shapes = shapes._replace(tri=(t["tri_p0"], *shapes.tri[1:]),
                             sph=(shapes.sph[0], t["sph_r"]))
    before = TBR.brute_hits.launches
    with pytest.raises(ValueError, match="require grad"):
        TBR.brute_hits(t["o"], t["d"], t["tmin"], t["tmax"], shapes, False)
    assert TBR.brute_hits.launches == before


@pytest.mark.cuda
def test_gradient_forward_casts_through_the_brute_kernel_on_card():
    """render_fn's gradient on the Cornell box (depth 3, its two light
    triangles): the eager value_and_grad launches one brute_hits per cast
    of its forward, (3 + 1) + 3 x 2, and none in its backward; the
    graphed one's graph holds the same number of brute_hits_kernel
    nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render_fn
    from jet_pbrt_tpu_torch.ops import brute as TBR
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    fn, pack = render_fn(cornell_box(), 16, 16, 1, seed=1, max_depth=3,
                         device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    f = P.loss_fn(fn, pack, target)
    params = P.get_params(pack, ("mat_c0", "light_c"))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    before = TBR.brute_hits.launches
    loss = f(leaves)
    torch.cuda.synchronize()
    assert TBR.brute_hits.launches - before == 4 + 3 * 2
    before = TBR.brute_hits.launches
    torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    assert TBR.brute_hits.launches == before
    G.clear()
    vg = P.compile_value_and_grad(f)
    for _ in range(2):
        vg(params)
    torch.cuda.synchronize()
    entry = next(iter(G.GRAD_CACHE.entries.values()))
    assert entry.launches["brute_hits_kernel"] == 4 + 3 * 2
    vg.release()
    G.clear()


# the casts' set-up and hit reconstruction (ops/rays.py, csrc/rays.cu)

def _rays_counts() -> dict:
    from jet_pbrt_tpu_torch.ops import rays as TRY
    return {k: getattr(TRY, k).launches for k in (
        "shadow_key", "shadow_segments", "occlusion_merge",
        "hit_reconstruct")}


def _rays_scene(which: str):
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    if which == "cornell":
        return cornell_box().to("cuda")
    if which == "many-families":
        import chip_smoke
        return chip_smoke.many_families_scene().to("cuda")
    return _shade_scene(which)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "sweep", "many-lights", "cornell"])
def test_rays_kernels_match_plain_on_card(which):
    """Every shadow_key, shadow_segments, occlusion_merge and
    hit_reconstruct call of a 64^2, 1-spp, depth-5 wave against its plain
    version on the recorded inputs, every output bit for bit, as many
    calls of each as chip_smoke.rays_launches counts
    (chip_smoke.rays_phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    scene = _rays_scene(which)
    out = chip_smoke.rays_phase(((which, scene, 64),), torch.device("cuda"),
                                "card")
    want = chip_smoke.rays_launches(scene.meta, 1, 5)
    assert out[which]["calls"] == {k: v for k, v in want.items() if v}
    assert out[which]["differing"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "cornell", "many-families"])
def test_rays_kernels_edge_sets_on_card(which):
    """chip_smoke.rays_edges at 4,097 lanes: masked lanes, zero-length
    segments, NaN and inf endpoints, inactive lanes, one, three and 17
    flags sorted and not, and seeded hits with misses, NaN t, ties across
    kinds (19 of them with 16 families) and indices past their tables,
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    out = chip_smoke.rays_edges(((which, _rays_scene(which)),),
                                torch.device("cuda"), sizes=(4097,))
    assert out[f"{which} 4097"]["differing"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cornell", "wide", "many-families"])
def test_rays_route_frame_equals_plain_route_on_card(which):
    """A 32^2, 3-spp frame through the kernels equals the frame with the
    plain versions in the wrappers' places, image and stats bit for bit;
    the kernels launched as rays_launches counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves, \
        render
    scene = _rays_scene(which)
    kw = dict(spp=3, seed=2, max_depth=5, clamp=False, device="cuda",
              with_stats=True, graph=False)
    before = _rays_counts()
    img, st = render(scene, 32, 32, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _rays_counts().items()}
    with chip_smoke.plain_rays():
        pimg, pst = render(scene, 32, 32, **kw)
    assert torch.equal(img, pimg) and st == pst
    assert launched == chip_smoke.rays_launches(
        scene.meta, n_waves(32, 32, 3, DEFAULT_CHUNK), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "many-families"])
def test_graphed_wave_replays_the_rays_kernels_on_card(which):
    """The every-kind scene and the 16 families at 32^2, 2 spp: the
    captured wave's graph holds the kernel nodes rays_launches counts for
    one wave, a replayed frame counts them, and its image and stats equal
    the eager frame's bit for bit. The kinds' table is made anew here, by
    the capture's warm-up call; the root table is captured with the
    wave."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves, \
        render
    from jet_pbrt_tpu_torch.ops import rays as TRY
    scene = _rays_scene(which)
    kw = dict(spp=2, seed=4, max_depth=5, clamp=False, device="cuda",
              with_stats=True)
    G.clear()
    TRY._HIT_TABLE_CACHE.clear()
    render(scene, 32, 32, graph=True, **kw)
    (entry,) = G.CACHE.entries.values()
    one = chip_smoke.rays_launches(scene.meta, 1, 5)
    assert {k: entry.launches[f"{k}_kernel"] for k in one} == one
    runs = {}
    for graph in (True, False):
        before = _rays_counts()
        img, st = render(scene, 32, 32, graph=graph, **kw)
        torch.cuda.synchronize()
        runs[graph] = (img, st, {k: v - before[k]
                                 for k, v in _rays_counts().items()})
    (gi, gs, gl), (ei, es, el) = runs[True], runs[False]
    assert torch.equal(gi, ei) and gs == es
    assert gl == el == chip_smoke.rays_launches(
        scene.meta, n_waves(32, 32, 2, DEFAULT_CHUNK), 5)
    G.clear()


@pytest.mark.cuda
def test_rays_kernels_route_and_refuse_on_card():
    """A CUDA float input that requires grad is refused (the kernels have
    no backward; the merge takes bool flags, which cannot), as is one the
    kernel cannot take; neither launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.ops import rays as TRY
    from jet_pbrt_tpu_torch.scene import pack as TPK
    scene = _rays_scene("wide")
    meta, pack = scene.meta, scene.pack
    g = torch.Generator(device="cuda").manual_seed(3)
    p_from = torch.randn(1000, 3, device="cuda", generator=g)
    p_to = torch.randn(1000, 3, device="cuda", generator=g)
    hits, kinds = TPK._kind_hits(meta, pack, p_from, p_to,
                                 torch.full((1000,), 1e-3, device="cuda"),
                                 torch.full((1000,), float("inf"),
                                            device="cuda"))
    before = _rays_counts()
    o = p_from.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="require grad"):
        TPK.hit_reconstruct(meta, pack, o, p_to, hits, kinds)
    with pytest.raises(ValueError, match="require grad"):
        TRY.shadow_key(meta, pack, o, p_to)
    with pytest.raises(ValueError, match="require grad"):
        TRY.shadow_segments(pack, p_from, o)
    assert _rays_counts() == before
    with pytest.raises(ValueError, match="not contiguous"):
        TRY.shadow_segments(pack, p_from, p_to.t().contiguous().t())
    with pytest.raises(ValueError, match="torch.int64"):
        TRY.occlusion_merge([hits[0].valid], hits[0].index)
    with pytest.raises(ValueError, match="torch.float32"):
        TPK.hit_reconstruct(meta, pack, p_from.double(), p_to, hits, kinds)
    assert _rays_counts() == before


@pytest.mark.cuda
def test_gradient_forward_runs_the_rays_kernels_on_card():
    """render_fn's gradient on the Cornell box (depth 3, two lights): its
    forward reconstructs each closest hit and sets up and merges each
    shadow cast through the kernels ((3 + 1) hit_reconstruct, 3 x 2 of the
    others; no key: the box sorts nothing), its backward launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models.render import render_fn
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    fn, pack = render_fn(cornell_box(), 16, 16, 1, seed=1, max_depth=3,
                         device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    f = P.loss_fn(fn, pack, target)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in P.get_params(pack, ("mat_c0", "light_c")).items()}
    before = _rays_counts()
    loss = f(leaves)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _rays_counts().items()} == {
        "shadow_key": 0, "shadow_segments": 6, "occlusion_merge": 6,
        "hit_reconstruct": 4}
    before = _rays_counts()
    torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    assert _rays_counts() == before


# the wave's glue (ops/wave.py, csrc/wave.cu)

def _wave_counts() -> dict:
    from jet_pbrt_tpu_torch.ops import wave as TWV
    return {k: getattr(TWV, k).launches for k in (
        "camera_rays", "permute_state", "unsort_guard")}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "sweep", "many-lights", "cornell"])
def test_wave_kernels_match_plain_on_card(which):
    """Every camera_rays, permute_state and unsort_guard call of a 64^2,
    1-spp, depth-5 wave against its plain version on the recorded inputs,
    every row bit for bit, as many calls of each as chip_smoke
    .wave_launches counts (chip_smoke.wave_phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    scene = _rays_scene(which)
    out = chip_smoke.wave_phase(((which, scene, 64),), torch.device("cuda"),
                                "card")
    want = chip_smoke.wave_launches(scene.meta, 1, 5)
    assert out[which]["calls"] == {k: v for k, v in want.items() if v}
    assert out[which]["differing"] == 0


@pytest.mark.cuda
def test_wave_kernels_edge_sets_on_card():
    """chip_smoke.wave_edges at 1, 300 and 4,097 lanes, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    out = chip_smoke.wave_edges(_rays_scene("cornell"), torch.device("cuda"),
                                sizes=(1, 300, 4097))
    assert all(v["differing"] == 0 for v in out.values()) and len(out) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cornell", "wide", "sweep"])
def test_wave_route_frame_equals_plain_on_card(which):
    """A 32^2, 3-spp frame through the glue kernels equals the frame with
    their plain versions, image and stats bit for bit, and the debug and
    stratified samplers' frames likewise; the
    kernels launched as wave_launches counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves, \
        render
    scene = _rays_scene(which)
    before = _wave_counts()
    render(scene, 32, 32, spp=3, seed=2, max_depth=5, device="cuda",
           graph=False)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _wave_counts().items()} == \
        chip_smoke.wave_launches(scene.meta, n_waves(32, 32, 3,
                                                     DEFAULT_CHUNK), 5)
    chip_smoke.wave_frames(((which, scene, 32, 3, {}),
                            (which, scene, 16, 2, {"sampler": "debug"}),
                            (which, scene, 16, 4,
                             {"sampler": "stratified"})),
                           torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "cornell"])
def test_graphed_wave_replays_the_wave_kernels_on_card(which):
    """The captured wave's graph holds the kernel nodes wave_launches
    counts for one wave, a replayed frame counts them, and its image and
    stats (the counters the vertices add to) equal the eager frame's bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves, \
        render
    scene = _rays_scene(which)
    kw = dict(spp=2, seed=4, max_depth=5, clamp=False, device="cuda",
              with_stats=True)
    G.clear()
    render(scene, 32, 32, graph=True, **kw)
    (entry,) = G.CACHE.entries.values()
    one = chip_smoke.wave_launches(scene.meta, 1, 5)
    assert {k: entry.launches[f"{k}_kernel"] for k in one} == one
    runs = {}
    for graph in (True, False):
        before = _wave_counts()
        img, st = render(scene, 32, 32, graph=graph, **kw)
        torch.cuda.synchronize()
        runs[graph] = (img, st, {k: v - before[k]
                                 for k, v in _wave_counts().items()})
    (gi, gs, gl), (ei, es, el) = runs[True], runs[False]
    assert torch.equal(gi, ei) and gs == es and gs["rays"] > 0
    assert gl == el == chip_smoke.wave_launches(
        scene.meta, n_waves(32, 32, 2, DEFAULT_CHUNK), 5)
    G.clear()


@pytest.mark.cuda
def test_wave_kernels_refuse_on_card():
    """A CUDA float input that requires grad, or one the kernels cannot
    take, is refused and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.models import camera as TC
    from jet_pbrt_tpu_torch.ops import wave as TWV
    dev = torch.device("cuda")
    state, u = chip_smoke.wave_edge_state(100, 1, dev, True)
    perm = torch.randperm(100, device=dev)
    scene = _rays_scene("cornell")
    cam = TC.make_camera(scene.camera.lookfrom, scene.camera.front,
                         scene.camera.vup, scene.camera.vfov, (10, 10),
                         device=dev)
    before = _wave_counts()
    with pytest.raises(ValueError, match="require grad"):
        TWV.permute_state(state._replace(L=state.L.requires_grad_()), u,
                          perm)
    with pytest.raises(ValueError, match="require grad"):
        TWV.unsort_guard(state.L.detach().requires_grad_(), perm)
    with pytest.raises(ValueError, match="require grad"):
        TWV.camera_rays(cam, perm, 10,
                        torch.full((100, 2), 0.5, device=dev,
                                   requires_grad=True), scene.pack.ray_eps)
    with pytest.raises(ValueError, match="torch.int64"):
        TWV.permute_state(state._replace(L=state.L.detach()), u, perm.int())
    with pytest.raises(ValueError, match="not contiguous"):
        TWV.unsort_guard(state.L.detach().t().contiguous().t(), perm)
    assert _wave_counts() == before


@pytest.mark.cuda
def test_gradient_forward_runs_the_camera_kernel_on_card():
    """render_fn's gradient on the Cornell box: its forward makes the
    camera rays through the kernel (one launch a sample) and guards each
    sample's colours through the un-sort kernel (the box sorts nothing:
    no permute); its backward launches none of them, and one
    unsort_guard_backward a sample."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models.render import render_fn
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    fn, pack = render_fn(cornell_box(), 16, 16, 2, seed=1, max_depth=3,
                         device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    f = P.loss_fn(fn, pack, target)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in P.get_params(pack, ("mat_c0", "light_c")).items()}
    before = _wave_counts()
    loss = f(leaves)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _wave_counts().items()} == {
        "camera_rays": 2, "permute_state": 0, "unsort_guard": 2}
    from jet_pbrt_tpu_torch.ops import wave as TWV
    before, back = _wave_counts(), TWV.unsort_guard_backward.launches
    torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    assert _wave_counts() == before
    assert TWV.unsort_guard_backward.launches == back + 2


# the gradient's kernels (ops/shade.py, csrc/shade_grad.cu; ops/wave.py's
# backward kernels)

@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wide", "sweep", "many-lights", "cornell",
                                   "textured", "many-slots"])
def test_gradient_kernels_match_plain_on_card(which):
    """The forward of one differentiated 1-spp wave at 32^2, depth 5 (the
    every-kind scene on the wide kernel and on the sweep, the 46 lights,
    the Cornell box, the bilinear-textured floor, the many-slots scene
    whose accumulators live in device memory), its vertex, permute and
    un-sort calls recorded; each call's backward kernels against their
    plain versions for seeded upstream gradients
    (chip_smoke.check_grad_calls): d loss / d beta per lane within rtol
    1e-5 or explained by float64, each field within 1e-4 of its largest
    |gradient| (NaN fields of the plain backward against the lanes' own
    lobes), the permute's and un-sort's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    scene = (chip_smoke.cornell_box() if which == "cornell"
             else chip_smoke.grad_scene("image") if which == "textured"
             else chip_smoke.many_slots_scene() if which == "many-slots"
             else _shade_scene(which).to("cpu"))
    out = chip_smoke.grad_phase(((which, scene.to("cuda"), 32),),
                                torch.device("cuda"), "card")
    assert out[which]["calls"]["vertex"] == 6


@pytest.mark.cuda
def test_render_fn_gradient_kernel_route_matches_plain_route_on_card():
    """value_and_grad of a 32^2, 1-spp, depth-5 render_fn loss over
    albedo, roughness, emission and texels on the textured instanced scene:
    the kernel route's loss equal to the plain route's
    (chip_smoke.plain_grad) bit for bit, each field within 1e-4 of its
    largest |gradient|; the kernel route's gradient the same bit for bit
    in a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models.render import render_fn
    fn, pack = render_fn(_grad_scene(), 32, 32, 1, seed=2, max_depth=5,
                         device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    f = P.loss_fn(fn, pack, target)
    params = P.get_params(pack, ("mat_c0", "mat_s0", "light_c",
                                 "tex_image"))
    val, g = P.value_and_grad(f, params)
    val2, g2 = P.value_and_grad(f, params)
    with chip_smoke.plain_grad():
        pval, pg = P.value_and_grad(f, params)
    assert torch.equal(val, pval) and torch.equal(val, val2)
    for k in ("mat_c0", "mat_s0", "light_c"):
        assert torch.equal(g[k], g2[k]), k
    for k in params:
        scale = float(pg[k].abs().max())
        assert scale > 0 and float((g[k] - pg[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.cuda
def test_gradient_tangent_table_on_card():
    """The backward kernel's own tangent sets and material kinds' sets
    (shade.kernel_tangents) equal ops/shade.py's TANGENT_SETS and
    tangent_set."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.ops import shade as SH
    sets, of = SH.kernel_tangents()
    assert sets == SH.TANGENT_SETS
    assert of == {k: SH.tangent_set(k) for k in SH.TANGENTS}


# requests of fields the narrow launches are held on (the fit's, single
# material parameters, a texture colour, two parameters of set 2 alone,
# and every field): each set's width, the smallest instantiated (3, or
# the set's own) whose tangents carry the set's requested parameters
GRAD_REQUESTS = {("mat_c0",): (3, 3, 3), ("mat_c0", "light_c"): (3, 3, 3),
                 ("light_c",): (3, 3, 3), ("mat_s0",): (3, 4, 8),
                 ("tex_c0",): (3, 3, 3), ("mat_c1", "mat_s1"): (3, 3, 8),
                 ("mat_c0", "mat_c1", "mat_s0", "mat_s1", "light_c",
                  "tex_image", "tex_c0", "tex_c1"): (3, 4, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["bunny", "cornell", "every-kind"])
def test_narrow_tangents_equal_the_full_width_on_card(which):
    """Each vertex of a differentiated 32^2, 1-spp, depth-5 wave (the
    bunny garden, the Cornell box, the every-kind scene with its textured
    lanes) through vertex_backward for each request of GRAD_REQUESTS
    against the launches of every parameter (each set at its own width),
    seeded upstream gradients: each set launched at the request's width
    (vertex_backward.widths); d loss / d beta, each requested field's
    gradient, the environment's and an image texture's taps and their rows
    equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.ops import shade as SH
    from jet_pbrt_tpu_torch.scene.scenes import bunny_scene
    dev = torch.device("cuda")
    scene = (bunny_scene() if which == "bunny" else chip_smoke.cornell_box()
             if which == "cornell" else _shade_scene("wide"))
    calls = chip_smoke.grad_wave_calls(which, scene.to(dev), 32, dev)
    for i, rec in enumerate(a for n, a in calls if n == "vertex"):
        meta, pack, hit, state, u, bounce, depth, lights, occ = rec
        last = bounce >= depth
        gL, gbeta = chip_smoke.seeded_grads(state.L.shape[0], 50 + i, dev,
                                            last)
        slim = chip_smoke.kernel_state(state)
        sets = SH.backward_sets(meta)[:1 if last else None]

        def run(taps, fields):
            before = SH.vertex_backward.widths.copy()
            out = SH.vertex_backward(
                meta, pack, hit, slim, u, bounce, depth, lights, occ, gL,
                gbeta, taps, SH.requested_params(fields))
            widths = GRAD_REQUESTS[fields]
            assert SH.vertex_backward.widths - before \
                == {(s, widths[s]): 1 for s in sets}, (which, bounce, fields)
            return out

        taps = pack.tex_image.shape[0] > 0 and not last
        gb, partials, tap_g, tap_rows = run(taps, SH.GRAD_FIELDS)
        full = SH.split_grads(SH.grad_reduce(partials), pack)
        for fields in GRAD_REQUESTS:
            with_taps = taps and "tex_image" in fields
            ngb, npartials, ntap_g, ntap_rows = run(with_taps, fields)
            got = SH.split_grads(SH.grad_reduce(npartials), pack)
            assert torch.equal(ngb, gb), (which, bounce, fields)
            for f in [f for f in fields if f in got] + ["le_env"]:
                assert torch.equal(got[f], full[f]), (which, bounce, fields,
                                                      f)
            if with_taps:
                assert torch.equal(ntap_g, tap_g) \
                    and torch.equal(ntap_rows, tap_rows), (which, bounce)


@pytest.mark.cuda
@pytest.mark.parametrize("fields,width", [
    (("mat_c0", "light_c"), 3),
    (("mat_c0", "mat_c1", "mat_s0", "mat_s1", "light_c"), 8)])
def test_graphed_value_and_grad_counts_the_tangent_widths_on_card(fields,
                                                                   width):
    """compile_value_and_grad of the bunny garden's 32^2, 1-spp, depth-5
    render_fn loss over `fields` (the fit's, every material field): its
    warm-ups and capture launch the full tangent set (2) at `width` alone
    and the matte set (0) at 3 (shade.vertex_backward.widths); a replay
    counts its 11 launches on vertex_backward.launches alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    from jet_pbrt_tpu_torch.models import graph as G
    from jet_pbrt_tpu_torch.models.render import render_fn
    from jet_pbrt_tpu_torch.ops import shade as SH
    from jet_pbrt_tpu_torch.scene.scenes import bunny_scene
    fn, pack = render_fn(bunny_scene(), 32, 32, 1, seed=3, max_depth=5,
                         device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    f = P.loss_fn(fn, pack, target)
    params = P.get_params(pack, fields)
    G.clear()
    before = SH.vertex_backward.widths.copy()
    vg = P.compile_value_and_grad(f)
    vg(params)
    counted = SH.vertex_backward.widths - before
    launches = SH.vertex_backward.launches
    vg(params)
    torch.cuda.synchronize()
    assert SH.vertex_backward.widths - before == counted
    assert SH.vertex_backward.launches == launches + 11
    # each of the warm-ups and the capture: 6 vertices, 5 below max_depth
    calls = G.GRAD_WARMUPS + 1
    assert counted == {(0, 3): 6 * calls, (2, width): 5 * calls}, counted
    vg.release()
    G.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 5), (63, 57), (64, 57),
                                       (1024, 57), (1000, 16025)])
def test_grad_reduce_matches_its_plain_order_on_card(rows, cols):
    """grad_reduce_kernel against grad_reduce_plain bit for bit (its chains
    and tree), for row counts below, at and above the chain count and not
    dividing it, and many slots; two launches equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.ops import shade as SH
    g = torch.Generator(device="cuda").manual_seed(rows + cols)
    partials = torch.randn((rows, cols), generator=g, device="cuda") * 1e3
    before = SH.grad_reduce.launches
    got = SH.grad_reduce(partials)
    again = SH.grad_reduce(partials)
    torch.cuda.synchronize()
    assert SH.grad_reduce.launches == before + 2
    assert torch.equal(got, SH.grad_reduce_plain(partials))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_many_slots_gradient_on_card():
    """The many-slots scene (more parameter slots than a block's shared
    memory holds) differentiated at 32^2, depth 3, through the kernels
    (the exact backward launches) against the plain route
    (chip_smoke.many_slots_grads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    out = chip_smoke.many_slots_grads(torch.device("cuda"), "card", res=32)
    assert out["slots"] > 14528 and out["rows"] >= 16


@pytest.mark.cuda
def test_gradient_kernels_edge_sets_on_card():
    """The backward kernels on the edge sets of chip_smoke.grad_edges at 1
    and 1,000 lanes: a recorded Cornell and every-kind wave's bounce-1 and
    last vertices cut or repeated to the size, the permute's backward by
    the identity, a reversal and a seeded perm, the un-sort's with NaN and
    inf colours, by those perms and without a sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    dev = torch.device("cuda")
    cases = [(label, chip_smoke.grad_wave_calls(label, scene.to(dev), 16,
                                                dev))
             for label, scene in (("cornell", chip_smoke.cornell_box()),
                                  ("every-kind", _shade_scene("wide")))]
    out = chip_smoke.grad_edges(cases, dev, sizes=(1, 1000))
    assert out["edges 1000"]["calls"] == {"vertex": 4, "permute": 3,
                                          "unsort": 4}



@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 95, 97, 1000])
def test_permute_backward_kernel_matches_plain_on_card(n):
    """permute_state_backward_kernel against permute_state_backward_plain,
    every word equal, at lane counts below, at and past a warp tile of 32
    rows (a partial tail tile), for the identity, the reversal and a seeded
    perm, on gradients with NaNs of two payloads, infinities and negative
    zeros (chip_smoke.special_grads), with both given, gL alone and gbeta
    alone (a None gradient's output all zeros); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.ops import wave as TWV
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    perms = (torch.arange(n, device=dev),
             torch.arange(n - 1, -1, -1, device=dev),
             torch.randperm(n, generator=g, device=dev))
    for i, perm in enumerate(perms):
        before = TWV.permute_state_backward.launches
        assert chip_smoke.check_permute_grad(f"{n} lanes", perm,
                                             10 * n + i) == n
        assert TWV.permute_state_backward.launches == before + 3


@pytest.mark.cuda
def test_permute_function_takes_an_expanded_gradient_on_card():
    """ops/wave.py's _Permute on the card, its backward handed an expanded
    (stride-0) gradient for L and a contiguous one for beta: one
    permute_state_backward launch, its gradients equal to the plain
    backward of the contiguous copies bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import chip_smoke
    from jet_pbrt_tpu_torch.ops import wave as TWV
    dev = torch.device("cuda")
    n = 1000
    g = torch.Generator(device=dev).manual_seed(4)
    perm = torch.randperm(n, generator=g, device=dev)
    state, u = chip_smoke.wave_edge_state(n, 5, dev, True)
    L = state.L.clone().requires_grad_()
    beta = state.beta.clone().requires_grad_()
    moved, _ = TWV.permute(state._replace(L=L, beta=beta), u, perm)
    gL = torch.randn(3, generator=g, device=dev).expand(n, 3)
    gb = torch.randn((n, 3), generator=g, device=dev)
    before = TWV.permute_state_backward.launches
    got = torch.autograd.grad((moved.L, moved.beta), (L, beta), (gL, gb))
    torch.cuda.synchronize()
    assert TWV.permute_state_backward.launches == before + 1
    want = TWV.permute_state_backward_plain(perm, gL.contiguous(), gb)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
