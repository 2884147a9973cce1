"""The gradient path's autograd Functions on the CPU: ops/shade.py::vertex
(shade_vertex, the shadow casts and nee_accumulate, whose backward is
csrc/shade_grad.cu's kernels on the card and autograd through the plain
vertex here) and ops/wave.py's permute and unsort.

- Per call, per bounce and per field: the Function's CPU route (plain
  forward, plain backward) equals autograd straight through
  shade_vertex_plain and nee_accumulate_plain on the same inputs, bit for
  bit (NaN equal to NaN: the every-lobe scene's plain backward is NaN in
  the glass's eta and the metals' roughness, from lobes a lane does not
  take); the same for the whole path, render_fn's gradient against
  li_path's kernel route with each Function replaced by the plain code
  it wraps, but light_c's (its rows' uses summed in another order) within
  1e-6 of its largest |gradient|.
- Against the plain route (models/integrators.py::_li_path_plain): the
  same loss bit for bit, every field's gradient bit for bit but light_c's,
  which sums the environment's radiance per vertex there and once a wave
  here (within 1e-6 of its largest |gradient|).
- render_fn's gradient on the new route against jax.grad of the
  reference's render_fn run op by op, params perturbed from a numpy seed,
  at tests/test_torch_diff.py's tolerance.
- shade.kernel_route's decisions; the permute's and un-sort's plain
  backward against autograd of x[perm] and L[argsort(lane)] with the
  guard.
- The backward kernel's tangent table (shade.TANGENTS): per material
  kind, the plain backward's gradients of the material parameters
  outside the kind's row exactly 0; the tangent sets and the sets each
  scene launches; grad_reduce's fixed order of chains and a tree; a scene
  of more parameter slots than commit feed372's kernel held takes the kernel
  route and matches the reference.

Scenes: tests/test_torch_diff.py's tiny, metal and textured scenes and
chip_smoke's every-kind scene (every lobe), 16^2, depth up to 5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from jet_pbrt_tpu.diff import params as JP
from jet_pbrt_tpu.models import render as jrender
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.diff import params as TP
from jet_pbrt_tpu_torch.models.render import render_fn, setup, wave_fn
from jet_pbrt_tpu_torch.ops import shade as S
from jet_pbrt_tpu_torch.ops import wave as W
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_diff import metal_scene, textured_scene, tiny_scene

torch.set_num_threads(2)

RES = 16
# name: (scene, max_depth, fields)
SCENES = {
    "tiny": (lambda: tiny_scene(TBuilder), 2, ("mat_c0", "light_c")),
    "metal": (lambda: metal_scene(TBuilder), 3,
              ("mat_c0", "mat_c1", "mat_s0", "mat_s1")),
    "textured": (lambda: textured_scene(TBuilder), 2,
                 ("tex_image", "light_c")),
    "every-lobe": (chip_smoke.every_kind_scene, 5, S.GRAD_FIELDS),
}


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _leaves(pack, fields):
    return {f: getattr(pack, f).detach().clone().requires_grad_(True)
            for f in fields}


def _record_calls(make, res, depth, fields):
    """The inputs of each shade.vertex call of one differentiated 1-spp
    wave of make() at res^2, and its shadow flags."""
    inner = S.vertex
    calls = []

    def record(meta, pack, hit, state, u, bounce, max_depth, **kw):
        v, occ = inner(meta, pack, hit, state, u, bounce, max_depth, **kw)
        calls.append((meta, pack._replace(**{
            f: getattr(pack, f).detach() for f in S.GRAD_FIELDS}), hit,
            S.VertexState(*(x.detach() for x in state)), u, bounce,
            max_depth, occ))
        return v, occ

    S.vertex = record
    try:
        fn, pack = render_fn(make(), res, res, 1, seed=2, max_depth=depth,
                             device="cpu")
        fn(TP.with_params(pack, _leaves(pack, fields)))
    finally:
        S.vertex = inner
    assert len(calls) == depth + 1
    return calls


@pytest.fixture(scope="module")
def kind_calls():
    """The every-kind scene's vertex calls at 48^2, depth 2: some lanes of
    every material kind below max_depth (its small phong mesh too)."""
    return _record_calls(chip_smoke.every_kind_scene, 48, 2, S.GRAD_FIELDS)


@pytest.fixture(scope="module")
def vertex_calls():
    """{scene: [the inputs of each shade.vertex call of one
    differentiated 1-spp wave, and its shadow flags]}."""
    return {name: _record_calls(make, RES, depth, fields)
            for name, (make, depth, fields) in SCENES.items()}


def _upstream(n, bounce, depth, seed):
    g = np.random.default_rng(seed)
    gL = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    gb = None if bounce >= depth else torch.from_numpy(
        g.normal(size=(n, 3)).astype(np.float32))
    return gL, gb


def _straight(call, fields, gL, gb):
    """Autograd straight through shade_vertex_plain and
    nee_accumulate_plain: d loss / d (L, beta, *fields)."""
    meta, pack, hit, state, u, bounce, depth, occ = call
    leaves = _leaves(pack, fields)
    L = state.L.clone().requires_grad_(True)
    beta = state.beta.clone().requires_grad_(True)
    v = S.shade_vertex_plain(meta, pack._replace(**leaves), hit,
                             state._replace(L=L, beta=beta), u, bounce, depth)
    outs, gouts = [v.state.L], [gL]
    if bounce < depth:
        outs = [S.nee_accumulate_plain(v.state.L, v.useful, occ, v.contrib),
                v.state.beta]
        gouts.append(gb)
    ins = (L, beta, *leaves.values())
    return torch.autograd.grad(outs, ins, gouts, allow_unused=True)


def _through_function(call, fields, gL, gb):
    """The same through shade.vertex's Function (its CPU route), the
    shadow flags handed back as the casts made them."""
    meta, pack, hit, state, u, bounce, depth, occ = call
    leaves = _leaves(pack, fields)
    L = state.L.clone().requires_grad_(True)
    beta = state.beta.clone().requires_grad_(True)
    v, _ = S.vertex(meta, pack._replace(**leaves), hit,
                    state._replace(L=L, beta=beta), u, bounce, depth,
                    occlude=lambda _v: occ)
    outs, gouts = [v.state.L], [gL]
    if bounce < depth:
        outs.append(v.state.beta)
        gouts.append(gb)
    ins = (L, beta, *leaves.values())
    return torch.autograd.grad(outs, ins, gouts, allow_unused=True)


@pytest.mark.parametrize("name,bounce", [
    (name, b) for name in sorted(SCENES) for b in range(SCENES[name][1] + 1)])
def test_function_backward_equals_autograd_per_call(vertex_calls, name,
                                                    bounce):
    """Each bounce's vertex: d loss / d L, beta and each covered field
    through the Function's CPU route equal autograd straight through the
    plain vertex, bit for bit (NaN equal to NaN)."""
    _, depth, fields = SCENES[name]
    call = vertex_calls[name][bounce]
    gL, gb = _upstream(call[3].L.shape[0], bounce, depth, 10 + bounce)
    want = _straight(call, fields, gL, gb)
    got = _through_function(call, fields, gL, gb)
    ins = (call[3].L, call[3].beta, *(getattr(call[1], f) for f in fields))
    for x, a, b in zip(ins, got, want):
        # a field the vertex does not read: None straight through, zeros
        # from the Function's backward
        _same(torch.zeros_like(x) if a is None else a,
              torch.zeros_like(x) if b is None else b)


def test_function_backward_plain_matches_its_wrapper(vertex_calls):
    """vertex_grads on CPU tensors is vertex_backward_plain: gL passes
    through, and the fields it is asked for come back, others not."""
    call = vertex_calls["metal"][0]
    meta, pack, hit, state, u, bounce, depth, occ = call
    gL, gb = _upstream(state.L.shape[0], bounce, depth, 3)
    gl, gbeta, g, ge = S.vertex_grads(meta, pack, hit, state, u, bounce,
                                      depth, None, occ, gL, gb,
                                      ("mat_s0", "mat_c1"))
    pl, pb, pg, pe = S.vertex_backward_plain(meta, pack, hit, state, u,
                                             bounce, depth, occ, gL, gb)
    _same(gl, gL)
    _same(gbeta, pb)
    assert set(g) == {"mat_s0", "mat_c1"} and ge is None and pe is None
    for k in g:
        _same(g[k], pg[k])
    assert float(g["mat_s0"].abs().sum()) > 0


def _straight_wave(monkeypatch):
    """li_path's kernel route with each Function replaced by the plain
    code it wraps: autograd straight through."""
    def vertex(meta, pack, hit, state, u, bounce, depth, *, lights=None,
               counts=None, occlude=None):
        v = S.shade_vertex_plain(meta, pack, hit, state, u, bounce, depth,
                                 counts=counts)
        if bounce >= depth:
            return v, None
        occ = occlude(v)
        return v._replace(state=v.state._replace(L=S.nee_accumulate_plain(
            v.state.L, v.useful, occ, v.contrib))), occ

    monkeypatch.setattr(S, "vertex", vertex)
    monkeypatch.setattr(W, "permute", W.permute_state_plain)
    monkeypatch.setattr(W, "unsort", W.unsort_guard_plain)


def _value_and_grad(name, seed=2):
    make, depth, fields = SCENES[name]
    fn, pack = render_fn(make(), RES, RES, 1, seed=seed, max_depth=depth,
                         device="cpu")
    return TP.value_and_grad(lambda p: fn(TP.with_params(pack, p)).mean(),
                             TP.get_params(pack, fields))


def _light_c_close(a, b):
    """light_c's gradient sums its rows' uses in another order through the
    Functions (each vertex's own sum, then the vertices') than straight
    through (every use in the engine's order): within 1e-6 of its largest
    |gradient|."""
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("name", sorted(SCENES))
def test_whole_path_equals_autograd_straight_through(name, monkeypatch):
    """render_fn's loss and gradient through the Functions equal autograd
    straight through the same route's plain code: the loss and every
    field but light_c bit for bit (NaN equal to NaN), light_c as
    _light_c_close says."""
    val, g = _value_and_grad(name)
    with monkeypatch.context() as m:
        _straight_wave(m)
        sval, sg = _value_and_grad(name)
    _same(val, sval)
    for k in g:
        if k == "light_c":
            _light_c_close(g[k], sg[k])
        else:
            _same(g[k], sg[k])


@pytest.mark.parametrize("name", ["tiny", "metal", "textured"])
def test_whole_path_against_the_plain_route(name, monkeypatch):
    """The kernel route against li_path's plain route (_li_path_plain, what
    every gradient ran before the backward kernels): the loss bit for bit,
    each field bit for bit but light_c within 1e-6 of its largest
    |gradient| (the plain route sums the environment once a wave, the
    kernel route's plain vertex once a vertex)."""
    val, g = _value_and_grad(name)
    monkeypatch.setattr(S, "kernel_route", lambda *a, **kw: False)
    pval, pg = _value_and_grad(name)
    _same(val, pval)
    for k in g:
        if k == "light_c":
            _light_c_close(g[k], pg[k])
        else:
            _same(g[k], pg[k])


def test_gradient_route_records_the_functions():
    """render_fn differentiated in the appearance fields goes through
    shade.vertex once a vertex, wave.permute once a sort (a kernel-routed
    scene) and wave.unsort once, each recording its backward."""
    scene = tscenes.bunny_scene()
    assert scene.meta.kernel_routed
    fn, pack = render_fn(scene, 8, 8, 1, seed=0, max_depth=4, device="cpu")
    img = fn(TP.with_params(pack, _leaves(pack, ("mat_c0",))))
    names = []
    stack = [img.grad_fn]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        names.append(type(node).__name__)
        stack.extend(f for f, _ in node.next_functions)
    assert names.count("_VertexBackward") >= 5
    assert "_PermuteBackward" in names and "_UnsortBackward" in names


# the reference: jax.grad of its render_fn, run op by op

JAX_CASES = {"albedo": (tiny_scene, 2, ("mat_c0", "light_c"), 1e-3),
             "roughness": (metal_scene, 1, ("mat_s0",), 1e-3),
             "texels": (textured_scene, 1, ("tex_image",), 1e-3)}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_gradients_match_reference(case):
    """render_fn's gradient on the kernel route (every vertex through
    shade.vertex) against jax.grad of the reference's render_fn op by op,
    at 8^2, the params perturbed by the same numpy-seeded noise in both:
    rtol 1e-3 where |g| > 1e-4 (tests/test_torch_diff.py's tolerance)."""
    _match_reference(*JAX_CASES[case])


def _match_reference(scene, depth, fields, rtol):
    """test_gradients_match_reference's comparison for scene(builder)."""
    rng = np.random.default_rng(17)
    jfn, jpk = jrender.render_fn(scene(JBuilder), 8, 8, 1, seed=0,
                                 max_depth=depth)
    fn, pk = render_fn(scene(TBuilder), 8, 8, 1, seed=0, max_depth=depth,
                       device="cpu")
    noise = {f: rng.uniform(0.9, 1.1, getattr(pk, f).shape).astype(
        np.float32) for f in fields}
    jp = {f: jnp.asarray(np.asarray(getattr(jpk, f)) * noise[f])
          for f in fields}
    tp = {f: getattr(pk, f) * torch.from_numpy(noise[f]) for f in fields}
    with jax.disable_jit():
        img, vjp = jax.vjp(lambda p: jfn(JP.with_params(jpk, p)), jp)
        (ga,) = vjp(jnp.full(img.shape, 1.0 / img.size, jnp.float32))
    seen = []
    inner = S.vertex

    def record(*a, **kw):
        seen.append(a[5])
        return inner(*a, **kw)

    S.vertex = record
    try:
        _, gb = TP.value_and_grad(lambda p: fn(TP.with_params(pk, p)).mean(),
                                  tp)
    finally:
        S.vertex = inner
    assert seen == list(range(depth + 1))
    for f in fields:
        a, b = np.asarray(ga[f]), gb[f].numpy()
        big = np.abs(a) > 1e-4
        assert big.any() and np.isfinite(b).all()
        np.testing.assert_allclose(b[big], a[big], rtol=rtol)
        np.testing.assert_allclose(b[~big], a[~big], rtol=0, atol=1e-4 * rtol)


def test_many_slots_scene_takes_the_kernel_route_and_matches_reference():
    """chip_smoke's many-slots scene (2,000 matte materials, the floor a
    4 x 4 grid of them, a metal sphere): more parameter slots than commit
    feed372's kernel held in a block's shared memory (14,528), the kernel
    route all the same, and its gradient in the floor's albedos, the
    metal's roughness and the emission against the reference's as
    test_gradients_match_reference holds it."""
    scene = chip_smoke.many_slots_scene(4)
    assert S.n_grad_slots(scene.pack) > 14528
    pack = scene.pack._replace(mat_c0=scene.pack.mat_c0.clone()
                               .requires_grad_(True))
    o = torch.zeros((4, 3))
    assert S.kernel_route(scene.meta, pack, o, o, nee=True, mis=False)
    _match_reference(lambda b: chip_smoke.many_slots_scene(4, b), 2,
                     ("mat_c0", "mat_s0", "light_c"), 1e-3)


# the route

ROUTE_FIELDS = ("mat_c0", "mat_c1", "mat_s0", "mat_s1", "light_c",
                "tex_image", "tex_c0", "tex_c1")


def test_grad_fields_are_the_differentiable_fields_and_the_colours():
    assert set(S.GRAD_FIELDS) == set(TP.DIFFERENTIABLE_FIELDS) | {
        "tex_c0", "tex_c1"} == set(ROUTE_FIELDS)


@pytest.mark.parametrize("field,nee,mis,rays,fused", [
    *((f, True, False, False, True) for f in ROUTE_FIELDS),
    ("tri_p0", True, False, False, False),
    ("light_pos", True, False, False, False),
    ("mat_c0", True, True, False, False),
    ("mat_c0", False, False, False, False),
    ("mat_c0", True, False, True, False),
    (None, True, False, False, True)])
def test_kernel_route_decisions(field, nee, mis, rays, fused):
    """The kernel route for each covered field on the tape (and for none);
    the plain route for a geometry or light-position field, MIS, no NEE or
    primary rays on the tape."""
    scene = chip_smoke.every_kind_scene()
    pack = scene.pack
    if field is not None:
        pack = pack._replace(**{field: getattr(pack, field).clone()
                                .requires_grad_(True)})
    o = torch.zeros((4, 3), requires_grad=rays)
    assert S.kernel_route(scene.meta, pack, o, o.detach(), nee=nee,
                          mis=mis) is fused


@pytest.mark.parametrize("mis,nee", [(True, True), (False, False)])
def test_mis_and_no_nee_gradients_take_the_plain_route(mis, nee,
                                                       monkeypatch):
    """A differentiated wave with MIS, or without NEE, takes the plain
    route: no shade.vertex call, and its colours on the tape."""
    calls = []
    monkeypatch.setattr(S, "vertex", lambda *a, **kw: calls.append(1))
    scene = tiny_scene(TBuilder)
    _, pack, cam = setup(scene, 4, 4, "cpu")
    wave = wave_fn(scene.meta, 4, 2, mis=mis, nee=nee)
    img = wave(TP.with_params(pack, _leaves(pack, ("mat_c0",))), cam, 0,
               torch.arange(16))
    assert calls == [] and img.requires_grad


# the permute and the un-sort

@pytest.mark.parametrize("n", [1, 7, 300])
def test_permute_backward_plain_equals_autograd(n):
    """permute_state_backward_plain is autograd of x[perm]: for L and beta,
    each alone and both; the Function's CPU route gives the same."""
    g = torch.Generator().manual_seed(n)
    perm = torch.randperm(n, generator=g)
    L, beta, gL, gb = (torch.randn((n, 3), generator=g) for _ in range(4))
    Lr, br = L.clone().requires_grad_(), beta.clone().requires_grad_()
    want = torch.autograd.grad((Lr[perm], br[perm]), (Lr, br), (gL, gb))
    got = W.permute_state_backward_plain(perm, gL, gb)
    for a, b in zip(got, want):
        _same(a, b)
    assert W.permute_state_backward_plain(perm, None, gb)[0] is None
    state, u = chip_smoke.wave_edge_state(n, 5, torch.device("cpu"), True)
    state = state._replace(L=L.clone().requires_grad_(),
                           beta=beta.clone().requires_grad_())
    moved, _ = W.permute(state, u, perm)
    for a, b in zip(torch.autograd.grad((moved.L, moved.beta),
                                        (state.L, state.beta), (gL, gb)),
                    want):
        _same(a, b)


@pytest.mark.parametrize("sorted_", [True, False])
@pytest.mark.parametrize("n", [1, 13, 300])
def test_unsort_backward_plain_equals_autograd(n, sorted_):
    """unsort_guard_backward_plain is autograd of L[argsort(lane)] and the
    guard (NaN and inf colours get 0); the Function's CPU route gives the
    same."""
    g = torch.Generator().manual_seed(n)
    L = torch.randn((n, 3), generator=g)
    L[::3, 0] = float("nan")
    L[1::4, 2] = float("inf")
    lane = torch.randperm(n, generator=g) if sorted_ else None
    gout = torch.randn((n, 3), generator=g)
    Lr = L.clone().requires_grad_()
    x = Lr[torch.argsort(lane)] if sorted_ else Lr
    out = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    (want,) = torch.autograd.grad(out, Lr, gout)
    _same(W.unsort_guard_backward_plain(L, lane, gout), want)
    Lf = L.clone().requires_grad_()
    (got,) = torch.autograd.grad(W.unsort(Lf, lane), Lf, gout)
    _same(got, want)


def _chains_then_tree(p):
    """Column sums of p [G, P] (numpy float32) in grad_reduce's order:
    chain c adds rows c, c + C, ... in order from 0 (a missing row adds
    0), then chain c adds chain c + h for h = C / 2 down to 1."""
    c_ = S.REDUCE_CHAINS
    per = max(1, -(-p.shape[0] // c_))
    zero = np.zeros(p.shape[1], np.float32)
    chains = []
    for c in range(c_):
        acc = p[c] if c < p.shape[0] else zero
        for r in range(1, per):
            b = c + r * c_
            acc = acc + (p[b] if b < p.shape[0] else zero)
        chains.append(acc)
    h = c_ // 2
    while h:
        chains = [chains[c] + chains[c + h] for c in range(h)]
        h //= 2
    return chains[0]


def test_grad_reduce_plain_sums_in_row_order():
    """grad_reduce on CPU tensors sums the partial rows in its fixed order
    (REDUCE_CHAINS chains of rows in order, then a pairwise tree), for
    row counts below, at and above the chain count and not dividing it,
    bit for bit with the order written out in numpy and under repetition;
    the slot layout covers each field's rows once, then the environment's
    three."""
    g = torch.Generator().manual_seed(0)
    for rows, cols in ((9, 17), (S.REDUCE_CHAINS, 5), (130, 3), (1024, 57),
                       (1, 4)):
        partials = torch.randn((rows, cols), generator=g) * 1e3
        got = S.grad_reduce(partials)
        _same(got, torch.from_numpy(_chains_then_tree(partials.numpy())))
        _same(S.grad_reduce(partials.clone()), got)
    pack = tscenes.cornell_box().pack
    slots = S.grad_slots(pack)
    flat = torch.arange(S.n_grad_slots(pack), dtype=torch.float32)
    views = S.split_grads(flat, pack)
    assert torch.cat([v.flatten() for v in views.values()]).tolist() == \
        flat.tolist()
    for f, (at, shape) in slots.items():
        assert views[f].shape == (shape if f != "le_env" else (3,))
        if f != "le_env":
            assert shape == tuple(getattr(pack, f).shape)


def test_backward_checks_pass_and_raise(vertex_calls):
    """The backward wrapper's checks (run on CUDA tensors before the
    launch) on CPU tensors: the vertex's own inputs pass; a wrong dtype,
    shape or device, or an input that requires grad raise."""
    meta, pack, hit, state, u, bounce, depth, occ = vertex_calls["metal"][1]
    gL, gb = _upstream(state.L.shape[0], bounce, depth, 1)
    cpu = torch.device("cpu")
    check = lambda **kw: S.check_backward_inputs(
        meta, pack, kw.get("hit", hit), state, u, bounce, depth,
        kw.get("occ", occ), kw.get("gL", gL), gb, kw.get("dev", cpu))
    check()
    for kw in (dict(hit=hit._replace(mat_id=hit.mat_id.long())),
               dict(occ=occ.float()), dict(gL=gL[:-1]),
               dict(dev=torch.device("meta")),
               dict(gL=gL.clone().requires_grad_())):
        with pytest.raises(ValueError):
            check(**kw)
    with pytest.raises(ValueError, match="no vertex_backward kernel"):
        S.vertex_backward(meta, pack, hit, state, u, bounce, depth, None,
                          occ, gL, gb)


# the backward kernel's tangent sets

def _lobe_kinds(call, idx):
    """The lobe kind of each lane idx of a recorded vertex call."""
    from jet_pbrt_tpu_torch.ops import bsdf, rng as trng
    from jet_pbrt_tpu_torch.scene import pack as tpack
    meta, pack, hit, state, u, bounce, depth, occ = call
    kind, c0, c1, s0, s1, remap, tex, mf = tpack.gather_material(
        pack, hit.mat_id)
    c0 = tpack.effective_kd(meta, pack, hit, c0, tex)
    lobe = bsdf.make_lobe(kind, c0, c1, s0, s1, remap, trng.stream_lobe(u),
                          mf_kind=mf)
    return lobe.kind[idx]


# material kind of the every-kind scene -> its lobes (the builder's)
_KIND_LOBES = {0: (0,), 1: (1,), 2: (2,), 3: (0, 3), 4: (3,), 5: (3, 5),
               6: (4,)}


@pytest.mark.parametrize("kind", sorted(S.TANGENTS))
def test_tangents_hold_every_nonzero_material_gradient(kind_calls, kind):
    """Per material kind, over the every-kind scene's vertices below
    max_depth: the plain backward of the live lanes of that kind (with the
    scene's lobes cut to the kind's own, as the kernel computes only a
    lane's own lobe; lanes whose plain backward is NaN left out, as
    chip_smoke.defined_plain does) gives exactly 0 in every material
    parameter outside the kind's row of shade.TANGENTS, and not 0 in
    every one of them somewhere; rough glass per lobe (c0 on reflection,
    c1 on transmission); a textured kind's c0 rows exactly 0, the texture
    taking their gradient; the kind's tangent set holds its row."""
    import dataclasses
    params = ("mat_c0", "mat_c0", "mat_c0", "mat_c1", "mat_c1", "mat_c1",
              "mat_s0", "mat_s1")
    seen = np.zeros(8, bool)
    for call in kind_calls:
        meta, pack, hit, state, u, bounce, depth, occ = call
        if bounce >= depth:
            continue
        live = state.active & hit.valid
        kinds = pack.mat_kind[hit.mat_id.long()]
        idx = (live & (kinds == kind)).nonzero().flatten()
        if not idx.numel():
            continue
        lobes = _lobe_kinds(call, idx)
        gL, gb = _upstream(state.L.shape[0], bounce, depth, 30 + bounce)
        for lobe in lobes.unique().tolist():
            sub = idx[lobes == lobe]
            allowed = set(S.TANGENTS[kind])
            if kind == 5:
                allowed -= {3, 4, 5} if lobe == 3 else {0, 1, 2}
            m = dataclasses.replace(meta, present_lobes=_KIND_LOBES[kind])
            g, _ = chip_smoke.defined_plain((*call[:7], None, occ), gL, gb,
                                            sub, m)
            rows = hit.mat_id[sub].long().unique()
            textured = pack.mat_tex[rows] >= 0
            for p, field in enumerate(params):
                x = g[field][rows]
                x = x[:, p % 3] if x.dim() == 2 else x
                if p not in allowed:
                    assert not bool((x != 0).any()), (kind, lobe, p, x)
                elif p < 3:
                    # a texture takes a textured material's c0
                    assert not bool((x[textured] != 0).any()), (kind, p)
                    seen[p] |= bool((x[~textured] != 0).any())
                else:
                    seen[p] |= bool((x != 0).any())
            if bool(textured.any()) and not {0, 1, 2} - allowed:
                seen[:3] |= sum(float(g[t].abs().sum()) for t in (
                    "tex_c0", "tex_c1", "tex_image")) > 0
    want = np.zeros(8, bool)
    want[list(S.TANGENTS[kind])] = True
    assert (seen == want).all(), (kind, seen)
    assert set(S.TANGENTS[kind]) <= set(S.TANGENT_SETS[S.tangent_set(kind)])


def test_tangent_sets_and_the_sets_a_scene_launches():
    """The sets are nested, the smallest first; each kind takes the first
    that holds its row; backward_sets launches those of a scene's lobes:
    one for a matte scene, the matte and full sets for the bunny and the
    Cornell box (plastic, metal, glass), all three for the every-kind
    scene and for a meta without lobes."""
    import dataclasses
    sets = S.TANGENT_SETS
    assert [len(x) for x in sets] == [3, 4, 8]
    assert all(set(a) < set(b) for a, b in zip(sets, sets[1:]))
    assert {k: S.tangent_set(k) for k in S.TANGENTS} == {
        0: 0, 1: 0, 2: 2, 3: 2, 4: 2, 5: 2, 6: 1}
    assert S.backward_sets(tiny_scene(TBuilder).meta) == (0,)
    for scene in (tscenes.bunny_scene(), tscenes.cornell_box()):
        assert S.backward_sets(scene.meta) == (0, 2)
    meta = chip_smoke.every_kind_scene().meta
    assert S.backward_sets(meta) == (0, 1, 2)
    assert S.backward_sets(dataclasses.replace(meta, present_lobes=None)) \
        == (0, 1, 2)
