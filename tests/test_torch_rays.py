"""The casts' set-up and hit reconstruction (ops/rays.py) without a card.

Against the reference package on the same seeded numpy inputs: the plain
sort keys (`shadow_key_plain`: occluded's segment and
ops/sort.py::shadow_sort_key; with bounce, ray_sort_key with bvh_needed)
equal jet_pbrt_tpu/ops/sort.py's exactly, on masked and dead lanes,
zero-length segments and instances with scale; `scene/pack.py::occluded`
with its sort on and off equal to the reference's flags exactly, on the
Cornell box, chip_smoke.every_kind_scene and a four-instance bunny of a
2,000-triangle OBJ; `intersect` on the every-kind scene (textures on every
kind) against the reference's: t, normal and uv within rtol 1e-5 / atol
1e-6 (tests/test_torch_brute.py's: both sides op by op in float32 on the
CPU), position within t's tolerance carried through p = o + t d (rtol
1e-5 of t, atol 1e-6), the merged kind, mat_id, light_id and valid
exactly; the same for occluded and intersect on a scene of 16 instanced
families (19 kinds a closest cast, 17 flags a shadow cast). Without the
reference: each wrapper on CPU tensors is its plain version (no launch);
each input check refuses what its kernel cannot take; an input that
requires grad is refused on the card and keeps its tape on the CPU; the
root table holds bvh_needed's spheres; the kinds' int64 table has the
kernel's layout; a merge's slab is a view where its rows already lie in
one tensor. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2e).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jet_pbrt_tpu.ops import bvh as jbvh
from jet_pbrt_tpu.ops import intersect as jis
from jet_pbrt_tpu.ops import sort as jsort
from jet_pbrt_tpu.scene import pack as jpack
from jet_pbrt_tpu.scene import scenes as jscenes
from jet_pbrt_tpu.scene.assets import generate_bunny_obj
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.ops import intersect as tis
from jet_pbrt_tpu_torch.ops import kernels as L
from jet_pbrt_tpu_torch.ops import rays as TR
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene import scenes as tscenes

torch.set_num_threads(2)

N = 2048
RTOL, ATOL = 1e-5, 1e-6
SCENES = ("cornell", "every-kind", "bunny", "many-families")
FAMILIES = 16


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bunny") / "bunny.obj")
    generate_bunny_obj(path, 2000)
    return {"cornell": (jscenes.cornell_box(), tscenes.cornell_box()),
            "every-kind": (chip_smoke.every_kind_scene(builder=JBuilder),
                           chip_smoke.every_kind_scene()),
            "bunny": (jscenes.bunny_scene(bunny_path=path),
                      tscenes.bunny_scene(bunny_path=path)),
            "many-families": (
                chip_smoke.many_families_scene(FAMILIES, builder=JBuilder),
                chip_smoke.many_families_scene(FAMILIES))}


@pytest.fixture
def jax_walks(monkeypatch):
    """The reference's XLA BVH walks jitted (op by op they take minutes)."""
    for name in ("intersect_bvh", "intersect_instances"):
        monkeypatch.setattr(jbvh, name, jax.jit(
            getattr(jbvh, name), static_argnames=("leaf_size", "any_hit")))


def _segments(ts, seed: int):
    """N seeded segments inside the scene's world sphere: a fifth of the
    lanes masked off, every 17th of zero length (p_to = p_from)."""
    rs = np.random.default_rng(seed)
    c = ts.pack.world_center.numpy()
    r = float(ts.pack.world_radius)
    p_from = (c + rs.uniform(-0.7, 0.7, (N, 3)) * r).astype(np.float32)
    p_to = (c + rs.uniform(-0.7, 0.7, (N, 3)) * r).astype(np.float32)
    p_to[::17] = p_from[::17]
    mask = rs.uniform(size=N) > 0.2
    return p_from, p_to, mask


def _rays(ts, seed: int):
    """N rays from seeded points in the world sphere in seeded unit
    directions, a third of them inactive."""
    rs = np.random.default_rng(seed)
    c = ts.pack.world_center.numpy()
    r = float(ts.pack.world_radius)
    o = (c + rs.uniform(-0.8, 0.8, (N, 3)) * r).astype(np.float32)
    d = rs.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rs.uniform(size=N) > 0.33


def _aimed_rays(ts, seed: int):
    """N rays from seeded points in the world sphere, three lanes in four
    aimed at seeded points near its centre, the rest in seeded
    directions."""
    rs = np.random.default_rng(seed)
    c = ts.pack.world_center.numpy()
    r = float(ts.pack.world_radius)
    o = c + rs.uniform(-0.6, 0.6, (N, 3)) * r
    d = np.where((np.arange(N) % 4 != 0)[:, None],
                 c + rs.uniform(-0.25, 0.25, (N, 3)) * r - o,
                 rs.normal(size=(N, 3)))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jax_segment(js, p_from, p_to, mask):
    """The reference occluded's segment (jet_pbrt_tpu/scene/pack.py)."""
    p_from, p_to, mask = (jnp.asarray(x) for x in (p_from, p_to, mask))
    delta = p_to - p_from
    dist = jnp.sqrt(jnp.maximum(jis.dot(delta, delta), 1e-20))
    d = delta / dist[:, None]
    tmin = jnp.where(mask, jnp.full_like(dist, js.pack.ray_eps), jnp.inf)
    tmax = jnp.where(mask, dist - js.pack.ray_eps, -1.0)
    return p_from, d, tmin, tmax


@pytest.mark.parametrize("which", SCENES)
def test_keys_match_reference(scenes, which):
    """Both layouts' keys exactly, and the stable argsorts equal."""
    js, ts = scenes[which]
    p_from, p_to, mask = _segments(ts, 1)
    o, d, tmin, tmax = _jax_segment(js, p_from, p_to, mask)
    want = np.asarray(jsort.shadow_sort_key(js.meta, js.pack, tmax > 0.0, o,
                                            d, tmin, tmax))
    got = TR.shadow_key_plain(ts.meta, ts.pack, *(torch.from_numpy(x) for x
                                                  in (p_from, p_to, mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 1 << 30).sum() >= (~mask).sum()
    np.testing.assert_array_equal(torch.argsort(got, stable=True).numpy(),
                                  np.asarray(jnp.argsort(want)))

    o, d, active = _rays(ts, 2)
    J = jnp.asarray
    eps = js.pack.ray_eps
    needs = jsort.bvh_needed(js.meta, js.pack, J(o), J(d),
                             jnp.where(J(active), eps, jnp.inf),
                             jnp.where(J(active), jnp.inf, -1.0))
    lo = js.pack.world_center - js.pack.world_radius
    inv = jnp.broadcast_to(1.0 / jnp.maximum(2.0 * js.pack.world_radius,
                                             1e-12), (3,))
    want = np.asarray(jsort.ray_sort_key(J(active), J(o), J(d), lo, inv,
                                         needs_bvh=needs))
    got = TR.shadow_key_plain(ts.meta, ts.pack, torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(active),
                              bounce=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~active] == 1 << 26).all()
    if ts.meta.n_inst:
        # some live lanes need the instances' BVH, some do not
        need = (want[active] & (1 << 25)) == 0
        assert 0 < need.sum() < active.sum()


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("which", SCENES)
def test_occluded_matches_reference(scenes, which, sort, jax_walks):
    js, ts = scenes[which]
    p_from, p_to, mask = _segments(ts, 3)
    want = np.asarray(jpack.occluded(js.meta, js.pack, jnp.asarray(p_from),
                                     jnp.asarray(p_to),
                                     mask=jnp.asarray(mask), sort=sort))
    got = tpack.occluded(ts.meta, ts.pack, torch.from_numpy(p_from),
                         torch.from_numpy(p_to),
                         mask=torch.from_numpy(mask), sort=sort)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all() and not want[~mask].any()


def test_intersect_matches_reference(scenes, jax_walks):
    """The every-kind scene's closest hits: every kind wins some lanes."""
    js, ts = scenes["every-kind"]
    assert ts.meta.n_tex > 0
    o, d = _aimed_rays(ts, 4)
    tmin = np.full(N, 1e-3, np.float32)
    tmax = np.where(np.arange(N) % 4 == 0, np.float32(5.0),
                    np.inf).astype(np.float32)
    args = (o, d, tmin, tmax)
    ha = jpack.intersect(js.meta, js.pack, *(jnp.asarray(x) for x in args))
    hb = tpack.intersect(ts.meta, ts.pack, *(torch.from_numpy(x)
                                             for x in args))
    va = np.asarray(ha.valid)
    np.testing.assert_array_equal(hb.valid.numpy(), va)
    assert 0.2 < va.mean() < 1.0
    for f in ("mat_id", "light_id"):
        np.testing.assert_array_equal(getattr(hb, f).numpy(),
                                      np.asarray(getattr(ha, f)))
    np.testing.assert_allclose(hb.t.numpy()[va], np.asarray(ha.t)[va],
                               rtol=RTOL, atol=ATOL)
    for f in ("normal", "uv", "wo"):
        np.testing.assert_allclose(getattr(hb, f).numpy()[va],
                                   np.asarray(getattr(ha, f))[va],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    # p = o + t d with unit d: t's tolerance carried through the product
    # (the reference's jitted walks contract FMAs, so an instance's t may
    # differ in its last bits, and a component of p near 0 by as much)
    dp = np.abs(hb.position.numpy() - np.asarray(ha.position))[va]
    assert (dp <= RTOL * np.abs(np.asarray(ha.t))[va, None] + ATOL).all()
    ja, ka = jpack._kind_hits(js.meta, js.pack,
                              *(jnp.asarray(x) for x in args))
    tb, kb = tpack._kind_hits(ts.meta, ts.pack,
                              *(torch.from_numpy(x) for x in args))
    kind_a = np.asarray(jis.merge_hits(ja, ka)[1])
    kind_b = tis.merge_hits(tb, kb)[1].numpy()
    np.testing.assert_array_equal(kind_b, kind_a)
    assert set(kind_a[va]) == set(ka)


def test_many_families_intersect_matches_reference(scenes, jax_walks):
    """16 instanced families, 19 kinds a closest cast, every kind winning
    some lanes: valid, the merged kind, mat_id and light_id exactly and t
    within rtol 1e-5 / atol 1e-6 of the reference's; and the plain
    reconstruction from the reference's own kinds' hits (the same t bits:
    the reference's jitted walks contract FMAs, so a t of its own may
    differ in the last bits, and a small triangle's uv by more than the
    tolerance) equal to the reference's Hit within the same tolerance."""
    js, ts = scenes["many-families"]
    o, d = _aimed_rays(ts, 4)
    tmin = np.full(N, 1e-3, np.float32)
    tmax = np.full(N, np.inf, np.float32)
    args = (o, d, tmin, tmax)
    ha = jpack.intersect(js.meta, js.pack, *(jnp.asarray(x) for x in args))
    hb = tpack.intersect(ts.meta, ts.pack, *(torch.from_numpy(x)
                                             for x in args))
    va = np.asarray(ha.valid)
    np.testing.assert_array_equal(hb.valid.numpy(), va)
    for f in ("mat_id", "light_id"):
        np.testing.assert_array_equal(getattr(hb, f).numpy(),
                                      np.asarray(getattr(ha, f)))
    np.testing.assert_allclose(hb.t.numpy()[va], np.asarray(ha.t)[va],
                               rtol=RTOL, atol=ATOL)
    ja, ka = jpack._kind_hits(js.meta, js.pack,
                              *(jnp.asarray(x) for x in args))
    tb, kb = tpack._kind_hits(ts.meta, ts.pack,
                              *(torch.from_numpy(x) for x in args))
    assert list(kb) == list(ka) and len(ka) == FAMILIES + 3
    kind_a = np.asarray(jis.merge_hits(ja, ka)[1])
    np.testing.assert_array_equal(tis.merge_hits(tb, kb)[1].numpy(), kind_a)
    assert set(kind_a[va]) == set(ka)
    same = [tis.KindHit(*(torch.from_numpy(np.array(x)) for x in h))
            for h in ja]
    hc = tpack.hit_reconstruct_plain(ts.meta, ts.pack, torch.from_numpy(o),
                                     torch.from_numpy(d), same, kb)
    for f in ("t", "position", "normal", "uv", "wo"):
        np.testing.assert_allclose(getattr(hc, f).numpy()[va],
                                   np.asarray(getattr(ha, f))[va],
                                   rtol=RTOL, atol=ATOL, err_msg=f)


# --------------------------------------------------------------------------
# the wrappers on the CPU
# --------------------------------------------------------------------------

def _calls(ts):
    """One call of each wrapper on the scene's seeded CPU inputs, each with
    its plain version's: [(name, wrapper's output, plain output)]."""
    p_from, p_to, mask = (torch.from_numpy(x) for x in _segments(ts, 5))
    o, d, active = (torch.from_numpy(x) for x in _rays(ts, 6))
    meta, pack = ts.meta, ts.pack
    perm = torch.argsort(TR.shadow_key(meta, pack, p_from, p_to, mask),
                         stable=True)
    seg = TR.shadow_segments(pack, p_from, p_to, mask, perm)
    flags, _ = tpack._kind_hits(meta, pack, *seg, any_hit=True)
    tmin = torch.full((N,), 1e-3)
    tmax = torch.full((N,), float("inf"))
    hits, kinds = tpack._kind_hits(meta, pack, o, d, tmin, tmax)
    return [
        ("shadow_key", TR.shadow_key(meta, pack, p_from, p_to, mask),
         TR.shadow_key_plain(meta, pack, p_from, p_to, mask)),
        ("shadow_key bounce",
         TR.shadow_key(meta, pack, o, d, active, bounce=True),
         TR.shadow_key_plain(meta, pack, o, d, active, bounce=True)),
        ("shadow_segments", seg,
         TR.shadow_segments_plain(pack, p_from, p_to, mask, perm)),
        ("shadow_segments unsorted",
         TR.shadow_segments(pack, p_from, p_to, None, None),
         TR.shadow_segments_plain(pack, p_from, p_to, None, None)),
        ("occlusion_merge", TR.occlusion_merge(flags, perm),
         TR.occlusion_merge_plain(flags, perm)),
        ("hit_reconstruct", tpack.hit_reconstruct(meta, pack, o, d, hits,
                                                  kinds),
         tpack.hit_reconstruct_plain(meta, pack, o, d, hits, kinds))]


@pytest.mark.parametrize("which", SCENES)
def test_cpu_route_is_the_plain_version(scenes, which):
    """Every output equal to the plain version's, and no launch counted."""
    before = L.counts()
    for name, got, want in _calls(scenes[which][1]):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), name
    assert L.counts() == before


def test_merge_scatters_back_to_the_lanes():
    """out[perm[j]] = OR of the flags at row j: argsort-then-gather."""
    g = torch.Generator().manual_seed(7)
    flags = [torch.rand(N, generator=g) < 0.3 for _ in range(3)]
    perm = torch.randperm(N, generator=g)
    occ = flags[0] | flags[1] | flags[2]
    want = torch.empty_like(occ)
    want[perm] = occ
    assert torch.equal(TR.occlusion_merge_plain(flags, perm), want)
    assert torch.equal(TR.occlusion_merge_plain(flags, None), occ)


def test_root_table_holds_bvh_needed_spheres(scenes):
    """One row per instance, root[0:3] * scale + off and root[5] * scale,
    made anew from the pack at each call; none for a scene without a BVH
    mesh."""
    _, ts = scenes["every-kind"]
    meta, pack = ts.meta, ts.pack

    def spheres(pack):
        rows = []
        root = pack.inst_s_root[0]
        for i in range(meta.n_inst[0]):
            scale = pack.inst_scale[0][i]
            rows.append(torch.cat([root[0:3] * scale + pack.inst_off[0][i],
                                   (root[5] * scale)[None]]))
        return torch.stack(rows)

    assert torch.equal(TR.root_table(meta, pack), spheres(pack))
    assert sorted(set(pack.inst_scale[0].tolist())) == [
        pytest.approx(0.3), pytest.approx(0.8), 1.0]
    moved = pack._replace(inst_off=[x + 1.0 for x in pack.inst_off])
    assert torch.equal(TR.root_table(meta, moved), spheres(moved))
    assert not torch.equal(spheres(moved), spheres(pack))
    _, cornell = scenes["cornell"]
    assert TR.root_table(cornell.meta, cornell.pack).shape == (0, 4)


def test_requires_grad_refused_on_card_kept_on_cpu(scenes):
    """On the card an input that requires grad is refused (the kernels
    have no backward); a CPU input takes the plain version, whose output
    stays on the tape; any other device raises."""
    x = torch.zeros(3)
    cuda = torch.device("cuda")
    assert L.route("k", cuda, x=x, y=None)
    with pytest.raises(ValueError, match="k: y require grad"):
        L.route("k", cuda, x=x, y=x.clone().requires_grad_(True))
    assert not L.route("k", torch.device("cpu"),
                       x=x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="no k route for device meta"):
        L.route("k", torch.device("meta"), x=x)
    _, ts = scenes["every-kind"]
    o, d, _ = (torch.from_numpy(v) for v in _rays(ts, 8))
    o = o.requires_grad_(True)
    hits, kinds = tpack._kind_hits(ts.meta, ts.pack, o.detach(), d,
                                   torch.full((N,), 1e-3),
                                   torch.full((N,), float("inf")))
    before = L.counts()
    hit = tpack.hit_reconstruct(ts.meta, ts.pack, o, d, hits, kinds)
    assert hit.position.requires_grad
    hit.position.sum().backward()
    assert torch.equal(o.grad, torch.ones_like(o))
    assert L.counts() == before


def test_kind_ids_and_tables_are_the_packs():
    """ops/rays.py's kind ids are scene/pack.py's, and each table it names
    is a field of the pack."""
    assert (TR.KIND_TRI, TR.KIND_SPHERE, TR.KIND_RECT, TR.KIND_DISK,
            TR.KIND_INST) == (tpack.KIND_TRI, tpack.KIND_SPHERE,
                              tpack.KIND_RECT, tpack.KIND_DISK,
                              tpack.KIND_INST)
    fields = set(tpack.ScenePack._fields)
    assert {name for name, *_ in TR.HIT_TABLES + TR.FAMILY_TABLES} <= fields


@pytest.mark.parametrize("which", ["every-kind", "many-families"])
def test_hit_table_layout(scenes, which):
    """The kinds' int64 table in csrc/rays.cu's layout: 19 shape tables'
    (address, rows), 0 for those no kind present reads; the kinds' ids;
    per family its triangles per instance and 7 (address, rows). Made
    once for the same tables."""
    _, ts = scenes[which]
    meta, pack = ts.meta, ts.pack
    o = torch.zeros((4, 3))
    hits, kinds = tpack._kind_hits(meta, pack, o, o + 1.0,
                                   torch.zeros(4), torch.ones(4))
    tables, families = tpack.hit_tables(meta, pack)
    dev = torch.device("cpu")
    _, used = TR.check_hit_inputs(o, o, hits, kinds, tables, families, True,
                                  dev)
    table = TR.hit_table(kinds, families, used, dev)
    assert TR.hit_table(kinds, families, used, dev) is table
    vals = table.tolist()
    n_shape = len(TR.HIT_TABLES)
    for s_, (name, _, _, kind, _) in enumerate(TR.HIT_TABLES):
        x = getattr(pack, name)
        want = [x.data_ptr(), x.shape[0]] if kind in kinds else [0, 0]
        assert vals[2 * s_:2 * s_ + 2] == want, name
    assert vals[2 * n_shape:2 * n_shape + len(kinds)] == list(kinds)
    width = 1 + 2 * len(TR.FAMILY_TABLES)
    base = 2 * n_shape + len(kinds)
    assert len(vals) == base + width * len(meta.n_inst)
    for mi, (n_tris, tabs) in enumerate(families):
        row = vals[base + width * mi:base + width * (mi + 1)]
        assert row[0] == meta.n_blas_tris[mi] == n_tris
        assert row[1:] == [v for name, *_ in TR.FAMILY_TABLES for v in (
            tabs[name].data_ptr(), tabs[name].shape[0])]


def test_slab_is_a_view_of_one_tensors_rows():
    """Consecutive rows of one tensor (brute_hits' kinds) give a view of
    it; any other list a stack."""
    base = torch.arange(12.0).reshape(3, 4)
    rows = [base[0], base[1], base[2]]
    slab = TR._slab(rows)
    assert slab.data_ptr() == base.data_ptr() and torch.equal(slab, base)
    assert TR._slab(rows[1:]).data_ptr() == base[1].data_ptr()
    for other in ([base[0], base[2]], [base[1], base[0]],
                  [base[0], base[1].clone()]):
        got = TR._slab(other)
        assert got.data_ptr() not in (x.data_ptr() for x in other)
        assert torch.equal(got, torch.stack(other))


def _good(ts):
    """Valid inputs of each check, as (function, keyword inputs)."""
    meta, pack = ts.meta, ts.pack
    p_from, p_to, mask = (torch.from_numpy(x) for x in _segments(ts, 9))
    perm = torch.arange(N)
    flags = [mask, ~mask]
    hits, kinds = tpack._kind_hits(meta, pack, p_from, p_to,
                                   torch.full((N,), 1e-3),
                                   torch.full((N,), float("inf")))
    tables, families = tpack.hit_tables(meta, pack)
    return {"key": (TR.check_key_inputs, dict(
                pack=pack, a=p_from, b=p_to, live=mask, bounce=True)),
            "segments": (TR.check_segment_inputs, dict(
                pack=pack, p_from=p_from, p_to=p_to, mask=mask, perm=perm)),
            "merge": (TR.check_merge_inputs, dict(flags=flags, perm=perm)),
            "hit": (TR.check_hit_inputs, dict(
                o=p_from, d=p_to, hits=hits, kinds=kinds, tables=tables,
                families=families, want_uv=True))}


# (check, input, how it is spoiled, the message)
BAD = [("key", "a", "dtype", "expected a contiguous torch.float32"),
       ("key", "b", "shape", r"expected a contiguous torch.float32 \[2048, 3\]"),
       ("key", "live", "dtype", "torch.bool"),
       ("key", "live", "none", "takes the active lanes"),
       ("segments", "p_to", "contiguity", "not contiguous"),
       ("segments", "mask", "shape", r"\[2048\]"),
       ("segments", "perm", "dtype", "torch.int64"),
       ("merge", "flags", "none", "nothing to merge"),
       ("merge", "flags", "shape", r"flags\[1\]"),
       ("merge", "perm", "contiguity", "not contiguous"),
       ("hit", "o", "dtype", "torch.float32"),
       ("hit", "hits", "dtype", r"hits\[0\].index"),
       ("hit", "kinds", "shape", "one id each"),
       ("hit", "tables", "shape", "tri_n: expected rows of 3"),
       ("hit", "tables", "none", "no table tri_n"),
       ("hit", "families", "none", "names family 0 of 0"),
       ("hit", "families", "dtype", r"inst_mat\[0\]")]


@pytest.mark.parametrize("check,name,how,msg", BAD)
def test_input_checks_refuse(scenes, check, name, how, msg):
    """Each check refuses a wrong dtype, shape or contiguity, and accepts
    the valid inputs it is given."""
    _, ts = scenes["every-kind"]
    fn, kw = _good(ts)[check]
    dev = torch.device("cpu")
    fn(**kw, dev=dev)
    x = kw[name]
    if name == "tables":
        x = {k: v for k, v in x.items() if k != "tri_n"}
        if how == "shape":
            x["tri_n"] = kw[name]["tri_n"][:, :2].contiguous()
    elif name == "families" and how == "dtype":
        x = [(x[0][0], x[0][1] | {"inst_mat": x[0][1]["inst_mat"].long()}),
             *x[1:]]
    elif how == "none":
        x = [] if isinstance(x, list) else None
    elif name == "flags":
        x = [x[0], x[1][:-1]]
    elif name == "hits":
        x = [x[0]._replace(index=x[0].index.long()), *x[1:]]
    elif name == "kinds":
        x = x[:-1]
    elif how == "dtype":
        x = x.double() if x.is_floating_point() else x.float()
    elif how == "shape":
        x = x[:-1]
    else:
        x = torch.stack([x, x], -1)[..., 0]
    with pytest.raises(ValueError, match=msg):
        fn(**(kw | {name: x}), dev=dev)
    # a tensor on another device than the one checked for
    with pytest.raises(ValueError, match="meta"):
        fn(**kw, dev=torch.device("meta"))


def test_kernels_are_registered():
    for kernel, wrapper in (("shadow_key_kernel", "shadow_key"),
                            ("shadow_segments_kernel", "shadow_segments"),
                            ("occlusion_merge_kernel", "occlusion_merge"),
                            ("hit_reconstruct_kernel", "hit_reconstruct")):
        assert L.REGISTRY[kernel] == (TR.__name__, wrapper)
        assert isinstance(getattr(TR, wrapper).launches, int)
