"""Per-lane math of the port (jet_pbrt_tpu_torch/ops, models/camera.py)
against its JAX twin on the same seeded numpy inputs.

Both sides run op by op on the CPU (the JAX calls are not jitted, so XLA
fuses nothing across operations), at rtol 1e-5 / atol 1e-6: what remains
is libm rounding of transcendental functions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax._src import prng as jax_prng

from jet_pbrt_tpu.models import camera as jcam
from jet_pbrt_tpu.ops import bsdf as jbsdf
from jet_pbrt_tpu.ops import fresnel as jfr
from jet_pbrt_tpu.ops import intersect as jis
from jet_pbrt_tpu.ops import lights as jli
from jet_pbrt_tpu.ops import linalg as jla
from jet_pbrt_tpu.ops import microfacet as jmf
from jet_pbrt_tpu.ops import rng as jrng
from jet_pbrt_tpu.ops import sampling as jsa
from jet_pbrt_tpu.scene.builder import SceneBuilder as JBuilder
from jet_pbrt_tpu_torch.models import camera as tcam
from jet_pbrt_tpu_torch.ops import bsdf as tbsdf
from jet_pbrt_tpu_torch.ops import fresnel as tfr
from jet_pbrt_tpu_torch.ops import intersect as tis
from jet_pbrt_tpu_torch.ops import lights as tli
from jet_pbrt_tpu_torch.ops import linalg as tla
from jet_pbrt_tpu_torch.ops import microfacet as tmf
from jet_pbrt_tpu_torch.ops import rng as trng
from jet_pbrt_tpu_torch.ops import sampling as tsa
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder as TBuilder

torch.set_num_threads(2)

N = 512
RTOL, ATOL = 1e-5, 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _unit(rs, n=N):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _u(rs, n=N, k=2):
    return rs.uniform(size=(n, k)).astype(np.float32)


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _t(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def assert_same(a, b, rtol=RTOL, atol=ATOL):
    """a from JAX, b from torch; tuples compared leaf by leaf."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y, rtol, atol)
        return
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, equal_nan=True)


def _pair(jf, tf, *args, **kw):
    return (jf(*(_j(x) for x in args), **kw), tf(*(_t(x) for x in args), **kw))


# ---------------------------------------------------------------------------
# 1. linalg
# ---------------------------------------------------------------------------

LINALG = {
    "dot": lambda rs: ("dot", _unit(rs), _unit(rs)),
    "cross": lambda rs: ("cross", _unit(rs), _unit(rs)),
    "normalize": lambda rs: ("normalize", rs.normal(size=(N, 3)).astype(np.float32)),
    "safe_sqrt": lambda rs: ("safe_sqrt", rs.normal(size=N).astype(np.float32)),
    "face_forward": lambda rs: ("face_forward", _unit(rs), _unit(rs)),
    "refract": lambda rs: ("refract", _unit(rs), _unit(rs),
                           rs.uniform(0.5, 1.6, N).astype(np.float32)),
    "frame_from_z": lambda rs: ("frame_from_z", _unit(rs)),
    "luminance": lambda rs: ("luminance", _u(rs, k=3)),
    "max_component": lambda rs: ("max_component", _u(rs, k=3)),
    "is_black": lambda rs: ("is_black",
                            (_u(rs, k=3) * (rs.uniform(size=(N, 1)) > 0.5))
                            .astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg(name):
    fn, *args = LINALG[name](_rng(1))
    assert_same(*_pair(getattr(jla, fn), getattr(tla, fn), *args))


def test_frames_round_trip():
    rs = _rng(2)
    n, v = _unit(rs), rs.normal(size=(N, 3)).astype(np.float32)
    fj, ft = jla.frame_from_z(jnp.asarray(n)), tla.frame_from_z(_t(n))
    assert_same(jla.to_local(fj, jnp.asarray(v)), tla.to_local(ft, _t(v)))
    assert_same(jla.to_world(fj, jnp.asarray(v)), tla.to_world(ft, _t(v)))


# ---------------------------------------------------------------------------
# 2. rng
# ---------------------------------------------------------------------------

def test_threefry_matches_jax_words():
    """The port's hash is Threefry-2x32-20, word for word jax.random's."""
    rs = _rng(3)
    k = rs.integers(0, 2 ** 32, (2,), dtype=np.uint64)
    c = rs.integers(0, 2 ** 32, (2, 64), dtype=np.uint64)
    ref = np.asarray(jax_prng.threefry_2x32(
        jnp.asarray(k.astype(np.uint32)),
        jnp.asarray(c.astype(np.uint32).reshape(-1)))).reshape(2, 64)
    x0, x1 = trng.threefry2x32(*(torch.tensor(v.astype(np.int64))
                                 for v in (k[0], k[1], c[0], c[1])))
    np.testing.assert_array_equal(x0.numpy(), ref[0].astype(np.int64))
    np.testing.assert_array_equal(x1.numpy(), ref[1].astype(np.int64))


def test_uniforms_pure_function_of_lane():
    """A lane's uniforms depend on (seed, sample, pixel, purpose, slot)
    only, not on which other lanes share its wave, and are jax.random's
    uniform(fold_in(lane key, purpose), (8,)) bit for bit."""
    import jax
    pix = torch.arange(100, dtype=torch.int64)
    a = trng.uniforms(trng.lane_keys(7, 3, pix), 20, 8)
    b = trng.uniforms(trng.lane_keys(7, 3, pix[37:61]), 20, 8)
    assert torch.equal(a[37:61], b)
    assert not torch.equal(a, trng.uniforms(trng.lane_keys(8, 3, pix), 20, 8))
    assert not torch.equal(a, trng.uniforms(trng.lane_keys(7, 4, pix), 20, 8))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.03
    keys = jrng.lane_keys(7, jnp.int32(3), jnp.arange(100, dtype=jnp.int32))
    ref = jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, 20), (8,), jnp.float32))(keys)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))


@pytest.mark.parametrize("fn", ["lobe", "nee", "bsdf", "rr", "vertex"])
def test_stream_layout(fn):
    u = _u(_rng(4), k=3 * 8).reshape(N, 3, 8)   # [N, D+1, S], 2 lights
    uv = u[:, 1]
    if fn == "vertex":
        assert_same(jrng.vertex_uniforms(jnp.asarray(u), 1, 2),
                    trng.vertex_uniforms(_t(u), 1, 2))
        # and from keys: the bounce's purpose, drawn bit for bit
        pix = np.arange(N, dtype=np.int32)
        jk = jrng.lane_keys(5, jnp.int32(2), jnp.asarray(pix))
        tk = trng.lane_keys(5, 2, torch.from_numpy(pix))
        np.testing.assert_array_equal(
            np.asarray(jrng.vertex_uniforms(jk, 1, 2)),
            trng.vertex_uniforms(tk, 1, 2).numpy())
    elif fn == "lobe":
        assert_same(jrng.stream_lobe(jnp.asarray(uv)), trng.stream_lobe(_t(uv)))
    elif fn == "nee":
        assert_same(jrng.stream_nee(jnp.asarray(uv), 1),
                    trng.stream_nee(_t(uv), 1))
    else:
        f = {"bsdf": "stream_bsdf", "rr": "stream_rr"}[fn]
        assert_same(getattr(jrng, f)(jnp.asarray(uv), 2),
                    getattr(trng, f)(_t(uv), 2))


# ---------------------------------------------------------------------------
# 3. sampling
# ---------------------------------------------------------------------------

SAMPLING = {
    "sample_uniform_disk": lambda rs: (_u(rs),),
    "sample_concentric_disk": lambda rs: (np.concatenate(
        [_u(rs), np.full((4, 2), 0.5, np.float32)]),),
    "sample_cosine_hemisphere": lambda rs: (_u(rs),),
    "pdf_cosine_hemisphere": lambda rs: (rs.uniform(size=N).astype(np.float32),),
    "sample_uniform_hemisphere": lambda rs: (_u(rs),),
    "sample_uniform_sphere": lambda rs: (_u(rs),),
    "pdf_uniform_hemisphere": lambda rs: ((N,),),
    "pdf_uniform_sphere": lambda rs: ((N,),),
    "sample_uniform_cone": lambda rs: (_u(rs),
                                       rs.uniform(size=N).astype(np.float32)),
    "pdf_uniform_cone": lambda rs: (rs.uniform(size=N).astype(np.float32),),
    "sample_uniform_triangle": lambda rs: (_u(rs),),
    "balance_heuristic": lambda rs: (1.0, rs.uniform(size=N).astype(np.float32),
                                     1.0, rs.uniform(size=N).astype(np.float32)),
    "power_heuristic": lambda rs: (1.0, rs.uniform(size=N).astype(np.float32),
                                   1.0, rs.uniform(size=N).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_sampling(name):
    args = SAMPLING[name](_rng(5))
    assert_same(*_pair(getattr(jsa, name), getattr(tsa, name), *args))


# ---------------------------------------------------------------------------
# 4. fresnel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dielectric", "conductor"])
def test_fresnel(name):
    rs = _rng(6)
    cos = rs.uniform(-1, 1, N).astype(np.float32)
    if name == "dielectric":
        args = (cos, np.ones(N, np.float32),
                rs.uniform(1.0, 2.5, N).astype(np.float32))
    else:
        args = (cos, 1.0, rs.uniform(0.1, 3.0, (N, 3)).astype(np.float32),
                rs.uniform(0.0, 4.0, (N, 3)).astype(np.float32))
    fn = f"fresnel_{name}"
    assert_same(*_pair(getattr(jfr, fn), getattr(tfr, fn), *args))


# ---------------------------------------------------------------------------
# 5. microfacet
# ---------------------------------------------------------------------------

MF_KINDS = {"ggx": (jmf.GGX,), "beckmann": (jmf.BECKMANN,), "mixed": None}


def _mf_inputs(rs):
    kind = rs.integers(0, 2, N).astype(np.int32)
    w = _unit(rs)
    wh = _unit(rs)
    wh[:, 2] = np.abs(wh[:, 2])
    ax = rs.uniform(0.05, 0.8, N).astype(np.float32)
    ay = rs.uniform(0.05, 0.8, N).astype(np.float32)
    return kind, w, wh, ax, ay, _u(rs)


@pytest.mark.parametrize("fn", ["d", "lam", "g1", "g", "sample_wh", "pdf_wh"])
@pytest.mark.parametrize("kinds", sorted(MF_KINDS))
def test_microfacet(fn, kinds):
    kind, w, wh, ax, ay, u = _mf_inputs(_rng(7))
    ks = MF_KINDS[kinds]
    if ks is not None:
        kind = np.full(N, ks[0], np.int32)
    args = {"d": (kind, wh, ax, ay), "lam": (kind, w, ax, ay),
            "g1": (kind, w, ax, ay), "g": (kind, w, wh, ax, ay),
            "sample_wh": (kind, w, ax, ay, u),
            "pdf_wh": (kind, w, wh, ax, ay)}[fn]
    a, b = _pair(getattr(jmf, fn), getattr(tmf, fn), *args, kinds=ks)
    # Beckmann sampling runs 10 Newton steps through erfinv; its result is a
    # unit vector, compared at the same tolerance
    assert_same(a, b)


def test_roughness_to_alpha():
    r = _rng(8).uniform(0.0, 1.0, N).astype(np.float32)
    assert_same(*_pair(jmf.roughness_to_alpha, tmf.roughness_to_alpha, r))


# ---------------------------------------------------------------------------
# 6. bsdf
# ---------------------------------------------------------------------------

def _lobe_inputs(rs):
    mat = rs.integers(0, 7, N).astype(np.int32)
    c0 = _u(rs, k=3)
    c1 = _u(rs, k=3)
    s0 = np.where(mat == jbsdf.MAT_GLASS, rs.uniform(1.1, 2.0, N),
                  np.where(mat == jbsdf.MAT_PHONG, rs.uniform(1, 60, N),
                           rs.uniform(0.01, 0.6, N))).astype(np.float32)
    s1 = np.where(mat == jbsdf.MAT_ROUGHGLASS, rs.uniform(1.1, 2.0, N),
                  rs.uniform(0.01, 0.6, N)).astype(np.float32)
    remap = rs.uniform(size=N) < 0.5
    mfk = rs.integers(0, 2, N).astype(np.int32)
    return mat, c0, c1, s0, s1, remap, rs.uniform(size=N).astype(np.float32), mfk


def _lobes(seed):
    mat, c0, c1, s0, s1, remap, u, mfk = _lobe_inputs(_rng(seed))
    lj = jbsdf.make_lobe(*(jnp.asarray(x) for x in (mat, c0, c1, s0, s1, remap,
                                                    u)), mf_kind=jnp.asarray(mfk))
    lt = tbsdf.make_lobe(*(_t(x) for x in (mat, c0, c1, s0, s1, remap, u)),
                         mf_kind=_t(mfk))
    return lj, lt


def test_make_lobe():
    assert_same(*_lobes(9))


PRUNE = {"all": (None, None),
         "bunny": ((jbsdf.LOBE_LAMBERT, jbsdf.LOBE_FRESNEL,
                    jbsdf.LOBE_MICROFACET), (jmf.GGX,))}


@pytest.mark.parametrize("fn", ["eval_f", "pdf", "sample"])
@pytest.mark.parametrize("prune", sorted(PRUNE))
def test_bsdf(fn, prune):
    lj, lt = _lobes(10)
    rs = _rng(11)
    wo, wi, u = _unit(rs), _unit(rs), _u(rs)
    lobes, mfk = PRUNE[prune]
    if fn == "sample":
        a = jbsdf.sample(lj, jnp.asarray(wo), jnp.asarray(u), lobes=lobes,
                         mf_kinds=mfk)
        b = tbsdf.sample(lt, _t(wo), _t(u), lobes=lobes, mf_kinds=mfk)
    else:
        a = getattr(jbsdf, fn)(lj, jnp.asarray(wo), jnp.asarray(wi),
                               lobes=lobes, mf_kinds=mfk)
        b = getattr(tbsdf, fn)(lt, _t(wo), _t(wi), lobes=lobes, mf_kinds=mfk)
    keep = np.ones(N, bool)
    if prune == "bunny":
        keep = np.isin(np.asarray(lj.kind), lobes) & (np.asarray(lj.mf_kind)
                                                      == jmf.GGX)
    if fn != "sample":
        assert_same(np.asarray(a)[keep], b.numpy()[keep])
        return
    a = [np.asarray(x)[keep] for x in a]
    b = [x.numpy()[keep] for x in b]
    assert_same([a[0], a[2], a[3]], [b[0], b[2], b[3]])   # wi, pdf, specular
    # f is a steep function of wi on some lanes (a conductor Fresnel near
    # its critical angle turns a 1-ulp difference of wi into 1e-4 of f), and
    # sin/cos/pow/erfinv are not bit-identical between the two libraries:
    # f is held at the same tolerance wherever the sampled wi agree bit for
    # bit, which must be most lanes
    same_wi = np.all(a[0] == b[0], axis=1)
    assert same_wi.mean() > 0.75, same_wi.mean()
    assert_same(a[1][same_wi], b[1][same_wi])


# ---------------------------------------------------------------------------
# 7. intersect
# ---------------------------------------------------------------------------

def _ray_batch(rs, n=N):
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = _unit(rs, n)
    return o, d, np.full(n, 1e-3, np.float32), np.where(
        rs.uniform(size=n) < 0.8, np.inf, rs.uniform(0.5, 5, n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["triangles", "spheres", "rects", "disks"])
def test_intersect_kind(kind):
    rs = _rng(12)
    ray = _ray_batch(rs)
    m = 24
    if kind == "triangles":
        p0 = rs.uniform(-2, 2, (m, 3)).astype(np.float32)
        shapes = (p0, p0 + rs.uniform(-1, 1, (m, 3)).astype(np.float32),
                  p0 + rs.uniform(-1, 1, (m, 3)).astype(np.float32))
    elif kind == "spheres":
        shapes = (rs.uniform(-2, 2, (m, 3)).astype(np.float32),
                  rs.uniform(0.1, 0.8, m).astype(np.float32))
    elif kind == "rects":
        c = rs.uniform(-2, 2, (m, 1, 3)).astype(np.float32)
        sq = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                      np.float32)
        q = c + sq[None] * rs.uniform(0.2, 1.0, (m, 1, 1)).astype(np.float32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (m, 1))
        shapes = (q[:, 0], q[:, 1], q[:, 2], q[:, 3], n)
    else:
        shapes = (rs.uniform(-2, 2, (m, 3)).astype(np.float32), _unit(rs, m),
                  rs.uniform(0.2, 1.0, m).astype(np.float32))
    fn = f"intersect_{kind}"
    a, b = _pair(getattr(jis, fn), getattr(tis, fn), *ray, *shapes)
    assert np.asarray(a.valid).sum() > 20
    assert_same(a, b)


def test_merge_hits_and_rect_normal():
    rs = _rng(13)
    hits = []
    for _ in range(3):
        t = np.where(rs.uniform(size=N) < 0.6, rs.uniform(1, 5, N),
                     np.inf).astype(np.float32)
        hits.append((t, rs.integers(0, 9, N).astype(np.int32), np.isfinite(t)))
    a = jis.merge_hits([jis.KindHit(*(jnp.asarray(x) for x in h))
                        for h in hits], [0, 4, 2])
    b = tis.merge_hits([tis.KindHit(*(_t(x) for x in h)) for h in hits],
                       [0, 4, 2])
    assert_same(a, b)
    n, d = _unit(rs), _unit(rs)
    assert_same(*_pair(jis.rect_hit_normal, tis.rect_hit_normal, n, d))


# ---------------------------------------------------------------------------
# 8. lights (scenes of tests/test_lights.py, built by both builders)
# ---------------------------------------------------------------------------

def _light_scene(builder, kind):
    b = builder("t")
    b.set_camera(lookfrom=(0, 0, 5), lookat=(0, 0, 0))
    white = b.add_matte((0.8, 0.8, 0.8))
    b.add_rect_xz(-10, 10, -10, 10, -5, white)
    if kind == "area_rect":
        b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, 2, white, flip_normal=True),
                         (5.0, 5.0, 5.0))
    elif kind == "area_sphere":
        b.add_area_light(b.add_sphere((0, 4, 0), 1.0, white), (5.0, 5.0, 5.0))
    elif kind == "area_disk":
        b.add_area_light(b.add_disk((0, 3, 0), (0, -1, 0), 1.5, white),
                         (4.0, 3.0, 2.0))
    elif kind == "area_tri":
        b.add_area_light(b.add_triangle((-1, 2, -1), (1, 2, -1), (0, 2, 1),
                                        white, flip_normal=True), (3.0, 3.0, 3.0))
    elif kind == "point":
        b.add_point_light((0, 2, 0), (5.0, 5.0, 5.0))
    elif kind == "directional":
        b.add_directional_light((0.3, -1, 0.2), (2.0, 2.0, 2.0))
    elif kind == "env":
        b.add_env_light((0.3, 0.4, 0.5))
    return b.build(use_bvh=False)


@pytest.mark.parametrize("kind", ["area_rect", "area_sphere", "area_disk",
                                  "area_tri", "point", "directional", "env"])
def test_sample_li(kind):
    sj, st = _light_scene(JBuilder, kind), _light_scene(TBuilder, kind)
    li = sj.meta.n_lights - 1
    rs = _rng(14)
    # shading points below the light and inside the sphere light's cone
    pos = (rs.uniform(-3, 3, (N, 3)) * [1, 0.5, 1]).astype(np.float32)
    pos[:8] = [0.0, 4.2, 0.2]     # inside the sphere light
    u = _u(rs)
    a = jli.sample_li(sj.meta, sj.pack, li, jnp.asarray(pos), jnp.asarray(u))
    b = tli.sample_li(st.meta, st.pack, li, _t(pos), _t(u))
    assert_same(a, b)
    assert_same(jli.env_radiance(sj.meta, sj.pack, 5),
                tli.env_radiance(st.meta, st.pack, 5))


# ---------------------------------------------------------------------------
# 14. camera
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [(16, 16), (40, 24)])
def test_camera(res):
    args = ((278, 273, 960), (0.1, -0.2, -1.0), (0, 1, 0), 55.0, res)
    cj, ct = jcam.make_camera(*args), tcam.make_camera(*args, device="cpu")
    assert_same(tuple(cj), tuple(ct), rtol=0, atol=0)
    xy = _rng(15).uniform(0, 1, (N, 2)).astype(np.float32) * np.asarray(
        res, np.float32)
    assert_same(jcam.generate_rays(cj, jnp.asarray(xy)),
                 tcam.generate_rays(ct, _t(xy)))
