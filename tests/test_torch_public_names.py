"""The JAX package's smaller public names in the port, each against its
JAX twin on the same seeded numpy inputs, and a guard that every public
name of the JAX package has a counterpart in the port or a stated reason
not to (ROADMAP.md, Queue A).

Both sides run op by op on the CPU at rtol 1e-5 / atol 1e-6, as
tests/test_torch_ops.py: what remains is libm rounding of arccos, atan2,
sin and cos.
"""
import ast
import filecmp
import glob
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import torch

import jet_pbrt_tpu
import jet_pbrt_tpu_torch
from jet_pbrt_tpu.ops import fresnel as jfr
from jet_pbrt_tpu.ops import intersect as jis
from jet_pbrt_tpu.ops import linalg as jla
from jet_pbrt_tpu.scene import assets as jassets
from jet_pbrt_tpu.utils import native as jnative
from jet_pbrt_tpu_torch.ops import fresnel as tfr
from jet_pbrt_tpu_torch.ops import intersect as tis
from jet_pbrt_tpu_torch.ops import linalg as tla
from jet_pbrt_tpu_torch.scene import assets as tassets
from jet_pbrt_tpu_torch.utils import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
N = 512

# public names of the JAX package the port leaves out, by module (the
# reasons stand in ROADMAP.md, Queue A)
LEFT_OUT = {
    # the one-hot matmul gather works around the TPU's slow gathers
    "ops/gather.py": None,
    # the XLA walks: the port sends every BVH mesh to a kernel, whose
    # plain version is its CPU route and oracle
    "ops/bvh.py": {"intersect_bvh", "intersect_instances"},
    # typed jax.random key arrays: the port's keys are LaneKeys
    "ops/rng.py": {"is_key_array"},
    # the TPU kernels' packed-key and VMEM layouts
    "ops/sweep_bvh.py": {"FAR_BITS", "FAR_KEY", "TMASK"},
    "ops/wide_bvh.py": {"DUMP_CAP", "ENTRY_MASK", "FAR_BITS", "FAR_KEY_MIN",
                        "LEAF_BASE", "LEAF_BIT", "LEAF_CAP", "NODE_CAP",
                        "STACK_CAP", "STACK_TOTAL", "TILE"},
}


def _public(path):
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def test_every_public_name_is_ported_or_left_out_with_a_reason():
    missing = {}
    ref = os.path.join(ROOT, "jet_pbrt_tpu")
    for path in sorted(glob.glob(os.path.join(ref, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, ref)
        port = os.path.join(ROOT, "jet_pbrt_tpu_torch", rel)
        if not os.path.exists(port):
            missing[rel] = None
        elif _public(path) - _public(port):
            missing[rel] = _public(path) - _public(port)
    assert missing == LEFT_OUT


def _f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _same(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_constants_and_version():
    for name in ("EPSILON", "INFINITY", "RAY_EPS", "RAY_EPS_REL"):
        assert getattr(tla, name) == float(getattr(jla, name)), name
    assert tis.NO_HIT_T == float(jis.NO_HIT_T)
    assert jet_pbrt_tpu_torch.__version__ == jet_pbrt_tpu.__version__


def test_linalg_helpers_match_reference():
    rng = np.random.default_rng(31)
    a, b, n = _f32(rng, N, 3), _f32(rng, N, 3), _f32(rng, N, 3)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = _f32(rng, N, 1, lo=0.0)
    T = torch.from_numpy
    _same(tla.distance(T(a), T(b)), jla.distance(a, b))
    _same(tla.lerp(T(a), T(b), T(t)), jla.lerp(a, b, t))
    _same(tla.reflect(T(a), T(n)), jla.reflect(a, n))
    v = np.concatenate([a[:, :2], _f32(rng, N, 1, lo=-1.2, hi=1.2)], 1)
    _same(tla.spherical_theta(T(v)), jla.spherical_theta(v))
    _same(tla.spherical_phi(T(v)), jla.spherical_phi(v))
    st, ct = _f32(rng, N, lo=0.0), _f32(rng, N)
    phi = _f32(rng, N, lo=0.0, hi=6.28)
    _same(tla.spherical_direction(T(st), T(ct), T(phi)),
          jla.spherical_direction(st, ct, phi))
    _same(tla.spherical_direction_in_frame(T(st), T(ct), T(phi),
                                           tla.frame_from_z(T(n))),
          jla.spherical_direction_in_frame(st, ct, phi,
                                           jla.frame_from_z(jnp.asarray(n))))


def test_frame_from_z_axes_match_reference():
    """frame_from_z picks its helper axis from torch.eye rows (no host
    copy in a captured wave), on both sides of the |x| > 0.99 switch."""
    rng = np.random.default_rng(32)
    n = _f32(rng, N, 3)
    n[: N // 2, 0] = np.sign(n[: N // 2, 0]) * 5.0
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    assert (np.abs(n[:, 0]) > 0.99).any() and (np.abs(n[:, 0]) < 0.99).any()
    for t, j in zip(tla.frame_from_z(torch.from_numpy(n)),
                    jla.frame_from_z(jnp.asarray(n))):
        _same(t, j)


def test_intersect_helpers_match_reference():
    rng = np.random.default_rng(33)
    p0, p1, p2 = (_f32(rng, 64, 3) for _ in range(3))
    flip = rng.uniform(size=64) < 0.5
    T = torch.from_numpy
    _same(tis.triangle_normal(T(p0), T(p1), T(p2)),
          jis.triangle_normal(p0, p1, p2))
    _same(tis.triangle_normal(T(p0), T(p1), T(p2), T(flip)),
          jis.triangle_normal(p0, p1, p2, jnp.asarray(flip)))
    th, jh = tis.empty_hit(7), jis.empty_hit(7)
    for f in ("t", "index", "valid"):
        x, y = getattr(th, f).numpy(), np.asarray(getattr(jh, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    p = T(p0)
    o, eps = tis.offset_ray_origin(p)
    assert o is p and eps == jis.offset_ray_origin(p0)[1]


def test_schlick_fresnel_matches_reference():
    rng = np.random.default_rng(34)
    cos = _f32(rng, N, lo=-0.2, hi=1.2)
    f0 = _f32(rng, N, 3, lo=0.0)
    _same(tfr.schlick_fresnel(torch.from_numpy(cos), torch.from_numpy(f0)),
          jfr.schlick_fresnel(cos, f0))


def test_native_available_matches_reference():
    assert tnative.native_available() == jnative.native_available()


def test_cornell_objs_match_reference(tmp_path):
    jassets.generate_cornell_objs(str(tmp_path / "j"))
    tassets.generate_cornell_objs(str(tmp_path / "t"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 8
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "j", tmp_path / "t",
                                               names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_assets_main_writes_the_reference_files(tmp_path):
    """`python -m jet_pbrt_tpu_torch.scene.assets DIR` writes bunny.obj
    and cornellbox/*.obj, the files the reference's functions write."""
    out = subprocess.run(
        [sys.executable, "-m", "jet_pbrt_tpu_torch.scene.assets",
         str(tmp_path / "t")], cwd=ROOT, capture_output=True, text=True,
        check=True, timeout=300).stdout
    assert "wrote bunny.obj" in out and "cornellbox" in out
    jassets.generate_bunny_obj(str(tmp_path / "bunny.obj"))
    assert filecmp.cmp(tmp_path / "bunny.obj", tmp_path / "t" / "bunny.obj",
                       shallow=False)
    jassets.generate_cornell_objs(str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert not filecmp.cmpfiles(tmp_path / "j", tmp_path / "t" / "cornellbox",
                                names, shallow=False)[1]
