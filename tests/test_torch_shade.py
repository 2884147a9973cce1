"""The fused path vertex's parts that run without a card (ops/shade.py).

`shade_vertex_plain` against a composition of the reference package's own
functions in li_path's order (jet_pbrt_tpu/models/integrators.py:108-237,
called op by op as the other parity tests do), every output, on hits of a
scene with every material, texture, light and shape kind
(chip_smoke.every_kind_scene, built by each package's builder), at bounce
0, 1, a roulette bounce (3) and the last, and on a scene of 46 lights
(chip_smoke.many_lights_scene) at bounces 1 and 3; `nee_accumulate_plain`
against the reference's adds; `kernel_route` and the route li_path takes
from each entry point; the wrappers' argument checks; the kernel's light table
against meta.lights and the pack. The kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 2c).

Tolerance: rtol 1e-4 / atol 1e-5 per lane on every float output, the slice
tests' (op-by-op float32 on both sides, torch's CPU libm against XLA's);
the boolean outputs exactly, but for `useful` on a lane whose f is
subnormal: XLA's CPU code flushes subnormal results to zero and torch's
does not, so there the reference finds f black and the port does not (1
lane of 512 here, its contribution below float32's normal range; at most
2 are allowed, each checked to be of that class).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jet_pbrt_tpu.ops import bsdf as jbsdf
from jet_pbrt_tpu.ops import lights as jlights
from jet_pbrt_tpu.ops import rng as jrng
from jet_pbrt_tpu.ops.linalg import absdot as jabsdot
from jet_pbrt_tpu.ops.linalg import frame_from_z as jframe
from jet_pbrt_tpu.ops.linalg import is_black as jis_black
from jet_pbrt_tpu.ops.linalg import max_component as jmax_component
from jet_pbrt_tpu.ops.linalg import to_local as jto_local
from jet_pbrt_tpu.ops.linalg import to_world as jto_world
from jet_pbrt_tpu.scene import pack as jpack
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.diff import params as dparams
from jet_pbrt_tpu_torch.models import render as R
from jet_pbrt_tpu_torch.ops import lights as light_ops
from jet_pbrt_tpu_torch.ops import shade as S
from jet_pbrt_tpu_torch.ops.launches import REGISTRY
from jet_pbrt_tpu_torch.scene import pack as tpack
from jet_pbrt_tpu_torch.scene import scenes as tscenes

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
TINY = np.finfo(np.float32).tiny
DEPTH = 5
_sg = jax.lax.stop_gradient


@pytest.fixture(scope="module")
def scenes():
    return (chip_smoke.every_kind_scene(builder=JBuilder),
            chip_smoke.every_kind_scene())


def _vertex_inputs(ts, n_side=16, seed=0):
    """Hits of the port's scene (its plain intersect) for camera rays and
    rays from random points in random directions, and a seeded state and
    vertex uniforms: (hit, state, u_vertex) as torch tensors."""
    rs = np.random.default_rng(seed)
    cam = R.setup(ts, n_side, n_side, "cpu")[2]
    ids = torch.arange(n_side * n_side)
    xy = torch.stack([ids % n_side, ids // n_side], -1).float() \
        + torch.from_numpy(rs.uniform(size=(ids.shape[0], 2))).float()
    from jet_pbrt_tpu_torch.models.camera import generate_rays
    o1, d1 = generate_rays(cam, xy)
    m = o1.shape[0]
    o2 = torch.from_numpy(rs.uniform(-4, 4, (m, 3))).float()
    d2 = torch.from_numpy(rs.normal(size=(m, 3))).float()
    d2 = d2 / d2.norm(dim=-1, keepdim=True)
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    n = o.shape[0]
    tmin = ts.pack.ray_eps.expand(n)
    hit = tpack.intersect(ts.meta, ts.pack, o, d, tmin,
                          torch.full((n,), float("inf")))
    f = lambda *s: torch.from_numpy(rs.uniform(size=s).astype(np.float32))
    state = S.VertexState(
        L=f(n, 3), beta=0.1 + f(n, 3), active=f(n) < 0.85,
        prev_specular=f(n) < 0.3, prev_pdf=f(n), ray_o=o, ray_d=d)
    u = f(n, 4 + 2 * ts.meta.n_lights)
    return hit, state, u


def _ref_vertex(meta, pack, hit, state, u_vertex, bounce, max_depth):
    """The vertex as the reference's li_path computes it (nee=True,
    mis=False), from its own functions: (state after it, usefuls,
    contributions, shadow endpoints)."""
    L, beta, active, prev_specular, prev_pdf, ray_o, ray_d = state
    n, nl = L.shape[0], meta.n_lights
    gate = active if bounce == 0 else (active & prev_specular)
    le = jnp.where(hit.valid[:, None], jpack.emitted(pack, hit),
                   jlights.env_radiance(meta, pack, n))
    L = L + jnp.where(gate[:, None], beta * le, 0.0)
    if bounce >= max_depth:
        return (L, beta, active, prev_specular, prev_pdf, ray_o, ray_d), \
            [], [], []
    cont = active & hit.valid
    mat_kind, c0, c1, s0, s1, remap, tex_id, mf_kind = \
        jpack.gather_material(pack, hit.mat_id)
    c0 = jpack.effective_kd(meta, pack, hit, c0, tex_id)
    lobe = jbsdf.make_lobe(mat_kind, c0, c1, s0, s1, remap,
                           jrng.stream_lobe(u_vertex), mf_kind=mf_kind)
    delta = jbsdf.is_delta(lobe)
    frame = jframe(hit.normal)
    wo_local = jto_local(frame, hit.wo)
    usefuls, contribs, targets = [], [], []
    for li in range(nl):
        if meta.lights[li].static_black:
            continue
        ls = jlights.sample_li(meta, pack, li, hit.position,
                               jrng.stream_nee(u_vertex, li))
        f = jbsdf.eval_f(lobe, wo_local, jto_local(frame, _sg(ls.wi)),
                         lobes=meta.present_lobes,
                         mf_kinds=meta.present_mf_kinds)
        usefuls.append(cont & ~delta & (_sg(ls.pdf) > 0.0)
                       & ~jis_black(ls.li) & ~jis_black(f))
        contribs.append(beta * f * ls.li * (
            jabsdot(_sg(ls.wi), hit.normal)
            / jnp.maximum(_sg(ls.pdf), 1e-20))[:, None])
        targets.append(_sg(ls.pos))
    bs = jbsdf.sample(lobe, wo_local, jrng.stream_bsdf(u_vertex, nl),
                      lobes=meta.present_lobes,
                      mf_kinds=meta.present_mf_kinds)
    wi_world = _sg(jto_world(frame, bs.wi))
    pdf_b = _sg(bs.pdf)
    sample_ok = (pdf_b > 0.0) & ~jis_black(bs.f)
    if bounce >= 3:
        q = jnp.maximum(0.05, 1.0 - jmax_component(_sg(bs.f)))
        rr_die = jrng.stream_rr(u_vertex, nl) < q
        rr_scale = 1.0 / jnp.maximum(1.0 - q, 1e-6)
    else:
        rr_die = jnp.zeros((n,), bool)
        rr_scale = jnp.ones((n,), jnp.float32)
    active = cont & sample_ok & ~rr_die
    weight = (bs.f * (jabsdot(wi_world, hit.normal)
                      / jnp.maximum(pdf_b, 1e-20))[:, None]
              * rr_scale[:, None])
    beta = jnp.where(active[:, None], beta * weight, beta)
    ray_o = jnp.where(active[:, None], hit.position, ray_o)
    ray_d = jnp.where(active[:, None], wi_world, ray_d)
    return (L, beta, active, bs.is_specular, pdf_b, ray_o, ray_d), \
        usefuls, contribs, targets


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def many_lights():
    return (chip_smoke.many_lights_scene(builder=JBuilder),
            chip_smoke.many_lights_scene())


@pytest.mark.parametrize("bounce", [0, 1, 3, DEPTH])
def test_plain_vertex_matches_reference(scenes, bounce):
    """Every output of shade_vertex_plain on every lane against the
    reference's vertex, same hits, state and uniforms."""
    js, ts = scenes
    hit, state, u = _vertex_inputs(ts)
    live = int((state.active & hit.valid).sum())
    assert live > 100 and len(set(hit.mat_id[hit.valid].tolist())) >= 12
    _check_vertex(js, ts, hit, state, u, bounce, 8)


@pytest.mark.parametrize("bounce", [1, 3])
def test_plain_vertex_matches_reference_many_lights(many_lights, bounce):
    """The same on the scene of 46 lights (45 NEE lights, one black), whose
    lights' uniform slots run past the 32nd light."""
    js, ts = many_lights
    hit, state, u = _vertex_inputs(ts, n_side=8, seed=1)
    assert int((state.active & hit.valid).sum()) > 50
    _check_vertex(js, ts, hit, state, u, bounce, 45)


def _check_vertex(js, ts, hit, state, u, bounce, n_lit):
    """shade_vertex_plain against _ref_vertex on these inputs, every
    output at the module's tolerance (n_lit: the scene's non-black
    lights)."""
    got = S.shade_vertex_plain(ts.meta, ts.pack, hit, state, u, bounce,
                               DEPTH)
    jhit = jpack.Hit(*(_j(x) for x in hit))
    want, usefuls, contribs, targets = _ref_vertex(
        js.meta, js.pack, jhit, tuple(_j(x) for x in state), _j(u), bounce,
        DEPTH)
    for name, a, b in zip(S.VertexState._fields, want, got.state):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert got.useful.shape[0] == len(usefuls)
    if bounce < DEPTH:
        assert got.useful.shape[0] == sum(
            not lt.static_black for lt in ts.meta.lights) == n_lit
        assert int(got.useful.sum()) > 0
    for j in range(len(usefuls)):
        # a lane whose f is subnormal: XLA's CPU code flushes it to 0 (so
        # the reference finds f black), torch keeps it; its contribution
        # lies below float32's normal range on the port's side and is 0 on
        # the reference's
        off = got.useful[j].numpy() != np.asarray(usefuls[j])
        flushed = (np.all(np.abs(got.contrib[j].numpy()) < TINY, axis=-1)
                   & np.all(np.asarray(contribs[j]) == 0.0, axis=-1))
        assert not (off & ~flushed).any(), np.nonzero(off & ~flushed)
        assert off.sum() <= 2
        np.testing.assert_allclose(got.contrib[j].numpy(),
                                   np.asarray(contribs[j]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.shadow_to[j].numpy(),
                                   np.asarray(targets[j]), rtol=RTOL,
                                   atol=ATOL)


def test_nee_accumulate_matches_reference_adds():
    """L plus each light's contribution where useful and unoccluded, light
    after light: bit for bit with the reference's adds."""
    rs = np.random.default_rng(3)
    n, j = 500, 4
    L = rs.uniform(size=(n, 3)).astype(np.float32)
    useful = rs.uniform(size=(j, n)) < 0.6
    occ = rs.uniform(size=(j, n)) < 0.4
    contrib = rs.uniform(size=(j, n, 3)).astype(np.float32)
    want = jnp.asarray(L)
    for k in range(j):
        want = want + jnp.where((useful[k] & ~occ[k])[:, None], contrib[k],
                                0.0)
    got = S.nee_accumulate_plain(*(torch.from_numpy(x)
                                   for x in (L, useful, occ, contrib)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same = S.nee_accumulate(*(torch.from_numpy(x)
                              for x in (L, useful, occ, contrib)))
    assert torch.equal(same, got)


@pytest.mark.parametrize("nee,mis,grad,lights,fused", [
    (True, False, False, 2, True), (True, True, False, 2, False),
    (False, False, False, 2, False), (False, True, False, 2, False),
    (True, False, True, 2, False), (True, False, False, 33, True),
    (True, False, False, 200, True)])
def test_kernel_route(nee, mis, grad, lights, fused):
    """The wrappers with NEE, without MIS, with no gradient outside the
    appearance fields (grad: the lights' positions require it), whatever
    the number of lights; the plain version otherwise
    (tests/test_torch_vertex_grad.py holds each appearance field that
    keeps the wrappers)."""
    scene = tscenes.cornell_box()
    meta = dataclasses.replace(scene.meta,
                               lights=(scene.meta.lights[0],) * lights)
    pack = scene.pack
    if grad:
        pack = pack._replace(light_pos=pack.light_pos.clone().requires_grad_())
    o = torch.zeros((4, 3))
    assert S.kernel_route(meta, pack, o, o, nee=nee, mis=mis) is fused


@pytest.fixture
def calls(monkeypatch):
    """Records which of the wrappers and plain versions li_path calls."""
    seen = []
    for name in ("shade_vertex", "shade_vertex_plain", "nee_accumulate",
                 "nee_accumulate_plain"):
        inner = getattr(S, name)

        def call(*a, _inner=inner, _name=name, **kw):
            seen.append(_name)
            return _inner(*a, **kw)

        monkeypatch.setattr(S, name, call)
    return seen


# the wrappers on CPU tensors call their plain versions
FUSED = (["shade_vertex", "shade_vertex_plain"],
         ["nee_accumulate", "nee_accumulate_plain"])
PLAIN = (["shade_vertex_plain"], ["nee_accumulate_plain"])
ROUTES = {"render": (dict(), FUSED), "mis": (dict(mis=True), PLAIN),
          "no-nee": (dict(nee=False), PLAIN),
          "whitted": (dict(integrator="whitted"), None),
          "debug": (dict(integrator="debug"), None)}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_entry_points_take_their_route(case, calls):
    """render()'s path integrator takes the wrappers, once per vertex
    (depth + 1 shade_vertex, depth nee_accumulate); MIS and no-NEE the
    plain versions; Whitted and debug normals neither."""
    kw, route = ROUTES[case]
    R.render(tscenes.cornell_box(), 4, 4, 1, max_depth=3, device="cpu", **kw)
    if route is None:
        assert calls == []
    else:
        vertex, accumulate = route
        assert calls == (vertex + accumulate) * 3 + vertex


def test_gradient_path_takes_the_plain_vertex(calls):
    """render_fn differentiated in an appearance field takes the wrappers
    (shade.vertex's Function; on the CPU each wrapper runs its plain
    version, and the plain backward the plain vertex again); with a field
    outside the appearance fields on the tape (the lights' positions) it
    runs the plain vertex alone; off the tape it takes the wrappers."""
    fn, pack = R.render_fn(tscenes.cornell_box(), 4, 4, 1, max_depth=2,
                           device="cpu")
    loss, grads = dparams.value_and_grad(
        lambda p: fn(dparams.with_params(pack, p)).mean(),
        dparams.get_params(pack, ("mat_c0",)))
    assert set(calls) == {*FUSED[0], *FUSED[1]}
    assert float(grads["mat_c0"].abs().sum()) > 0
    del calls[:]
    fn(pack._replace(light_pos=pack.light_pos.clone().requires_grad_()))
    assert set(calls) == {"shade_vertex_plain", "nee_accumulate_plain"}
    del calls[:]
    fn(pack)
    assert set(calls) == {*FUSED[0], *FUSED[1]}


def test_vertex_checks_pass_and_raise(scenes):
    """The wrapper's checks (run on CUDA tensors before the launch) on CPU
    tensors: the vertex's own inputs pass; a wrong dtype, shape or
    contiguity, another device, or an input that requires grad raise."""
    ts = scenes[1]
    hit, state, u = _vertex_inputs(ts, n_side=4)
    cpu = torch.device("cpu")
    check = lambda **kw: S.check_vertex_inputs(
        ts.meta, kw.get("pack", ts.pack), kw.get("hit", hit),
        kw.get("state", state), kw.get("u", u), kw.get("bounce", 1), DEPTH,
        kw.get("dev", cpu))
    check()
    check(u=None, bounce=DEPTH)    # the last vertex reads no uniforms
    bad = {
        "dtype": dict(hit=hit._replace(mat_id=hit.mat_id.long())),
        "shape": dict(u=u[:, :-1].contiguous()),
        "contiguity": dict(state=state._replace(
            ray_d=state.ray_d.t().contiguous().t())),
        "device": dict(dev=torch.device("meta")),
        "grad": dict(state=state._replace(
            beta=state.beta.clone().requires_grad_())),
        "table": dict(pack=ts.pack._replace(
            mat_c0=ts.pack.mat_c0.double()))}
    for name, kw in bad.items():
        with pytest.raises(ValueError):
            check(**kw)


def test_accumulate_checks_pass_and_raise():
    n, j = 8, 2
    args = dict(L=torch.zeros((n, 3)), useful=torch.ones((j, n), dtype=bool),
                occ=torch.zeros((j, n), dtype=bool),
                contrib=torch.ones((j, n, 3)))
    cpu = torch.device("cpu")
    assert S.check_accumulate_inputs(**args, dev=cpu) == j
    for key, bad in (("useful", args["useful"].float()),
                     ("occ", args["occ"][:1]),
                     ("contrib", args["contrib"].transpose(0, 1)),
                     ("L", args["L"].requires_grad_())):
        with pytest.raises(ValueError):
            S.check_accumulate_inputs(**(args | {key: bad}), dev=cpu)


def test_wrappers_refuse_a_device_without_a_route(scenes):
    ts = scenes[1]
    hit, state, u = _vertex_inputs(ts, n_side=4)
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="no shade_vertex route"):
        S.shade_vertex(ts.meta, ts.pack, hit,
                       S.VertexState(*(meta(x) for x in state)), u, 0, DEPTH)
    with pytest.raises(ValueError, match="no nee_accumulate route"):
        S.nee_accumulate(*(torch.zeros(s, device="meta")
                           for s in ((4, 3), (1, 4), (1, 4), (1, 4, 3))))


@pytest.mark.parametrize("which", ["every-kind", "many-lights"])
def test_light_table_holds_each_lights_rows(scenes, many_lights, which):
    """One row per non-black light, in light order: radiance, then by
    kind the position or direction, the shape's rows and constants, and
    twice the world radius; its static row (kind, shape kind, uniform
    slot, t_count, first row in the emissive buffer), and there the
    instance family's raw mesh rows and normals, each family once; the
    environment's radiance summed as env_radiance sums it."""
    ts = (scenes if which == "every-kind" else many_lights)[1]
    meta, pack = ts.meta, ts.pack
    table = S.light_table(meta, pack)
    lit = [i for i, lt in enumerate(meta.lights) if not lt.static_black]
    assert table.rows.shape == (len(lit), S.TABLE_W)
    assert table.statics.shape == (len(lit), S.STATIC_W)
    assert table.statics.dtype == torch.int32
    assert torch.equal(table.le_env,
                       light_ops.env_radiance(meta, pack, 1)[0])
    kinds = {(lt.kind, lt.shape_kind) for lt in meta.lights}
    assert kinds >= {
        (0, -1), (1, -1), (3, -1), (2, tpack.KIND_TRI), (2, tpack.KIND_RECT),
        (2, tpack.KIND_DISK), (2, tpack.KIND_SPHERE), (2, tpack.KIND_INST)}
    families = {}
    for li, row, (kind, shape, slot, t_count, first) in zip(
            lit, table.rows, table.statics.tolist()):
        lm = meta.lights[li]
        assert (kind, shape, slot) == (lm.kind, lm.shape_kind, 1 + 2 * li)
        assert torch.equal(row[0:3], pack.light_c[li])
        assert row[-1] == 2.0 * pack.world_radius
        si = lm.shape_idx
        if kind == tpack.LIGHT_POINT:
            assert torch.equal(row[3:6], pack.light_pos[li])
        elif kind == tpack.LIGHT_DIRECTIONAL:
            assert torch.equal(row[3:6], pack.light_dir[li])
        elif shape == tpack.KIND_TRI:
            assert torch.equal(row[3:15], torch.cat([
                pack.tri_p0[si], pack.tri_p1[si], pack.tri_p2[si],
                pack.tri_n[si]]))
        elif shape == tpack.KIND_RECT:
            q = pack.rect_q[si]
            assert torch.equal(row[3:15], torch.cat([
                q[1], q[0] - q[1], q[2] - q[1], pack.rect_n[si]]))
        elif shape == tpack.KIND_DISK:
            assert torch.equal(row[3:6], pack.disk_c[si])
            assert torch.equal(row[12:15], pack.disk_n[si])
            assert row[16] == pack.disk_r[si]
            assert torch.allclose(row[15] * np.pi * pack.disk_r[si] ** 2,
                                  torch.tensor(1.0))
        elif shape == tpack.KIND_SPHERE:
            assert torch.equal(row[3:6], pack.sph_c[si])
            assert row[16] == pack.sph_r[si]
        if shape >= tpack.KIND_INST:
            mi = shape - tpack.KIND_INST
            assert families.setdefault(mi, first) == first
            assert t_count == pack.inst_em_tris[mi].shape[0] > 0
            assert torch.equal(table.em[first:first + t_count], torch.cat(
                [pack.inst_em_tris[mi], pack.inst_em_n[mi]], dim=1))
            assert torch.equal(row[3:6], pack.inst_off[mi][si])
            assert row[16] == pack.inst_scale[mi][si]
        else:
            assert t_count == first == 0
    assert table.em.shape == (sum(pack.inst_em_tris[mi].shape[0]
                                  for mi in families), S.EM_W)
    if which == "many-lights":
        assert len(meta.lights) == 46 and len(lit) == 45
        assert sorted(families.values())[1] > 0
    # the static part is made once per light layout and device, then kept
    assert S.light_table(meta, pack).statics is table.statics


def test_kernels_are_registered():
    assert REGISTRY["shade_vertex_kernel"] == (S.__name__, "shade_vertex")
    assert REGISTRY["nee_accumulate_kernel"] == (S.__name__,
                                                 "nee_accumulate")


def test_li_path_runs_each_vertex_through_the_module(scenes):
    """li_path's frame on the CPU through the wrappers equals the frame
    with the plain versions set in their places, bit for bit (the CPU
    wrappers are the plain versions)."""
    ts = scenes[1]
    img = R.render(ts, 8, 8, 1, max_depth=DEPTH, device="cpu")
    with chip_smoke.plain_vertex():
        plain = R.render(ts, 8, 8, 1, max_depth=DEPTH, device="cpu")
    assert torch.equal(img, plain) and float(img.mean()) > 0
