"""The port's random streams (jet_pbrt_tpu_torch/ops/rng.py) against
jax.random as the JAX package draws them (jet_pbrt_tpu/ops/rng.py): lane
keys, camera jitter of every sampler, per-vertex uniforms and the debug
sampler's constant streams, bit for bit, on seeded pixel ids up to 2^20 - 1.
These tests are the only check of the derivation: the card's machine has
no JAX. On the CPU the port runs its plain version; tests/test_torch_cuda.py
holds the kernel against it on the card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jet_pbrt_tpu.ops import rng as jrng
from jet_pbrt_tpu_torch.models import integrators as tint
from jet_pbrt_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

SEEDS = (0, 1, 42, 2 ** 31 - 1)


def _pixels(seed, n=257):
    """Seeded pixel ids in [0, 2^20), with both ends."""
    p = np.random.default_rng(seed).integers(0, 1 << 20, n)
    p[:2] = (0, (1 << 20) - 1)
    return p.astype(np.int32)


def _keys(seed, sample, pix):
    jk = jrng.lane_keys(seed, jnp.int32(sample), jnp.asarray(pix))
    tk = trng.lane_keys(seed, sample, torch.from_numpy(pix))
    return jk, tk


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_keys_match_jax(seed):
    pix = _pixels(seed)
    for sample in (0, 3, 7):
        jk, tk = _keys(seed, sample, pix)
        words = np.asarray(jax.random.key_data(jk)).astype(np.int64)
        np.testing.assert_array_equal(trng._u32(tk.k0).numpy(), words[:, 0])
        np.testing.assert_array_equal(trng._u32(tk.k1).numpy(), words[:, 1])
        assert tk.k0.dtype == torch.int32 and tk.sample.dtype == torch.int64
        assert (tk.sample == sample).all()


@pytest.mark.parametrize("sampler", ["random", "stratified", "debug"])
@pytest.mark.parametrize("seed", SEEDS)
def test_camera_jitter_matches_jax(sampler, seed):
    pix = _pixels(seed + 1)
    for sample, spp in ((0, 1), (5, 8), (7, 9)):
        jk, tk = _keys(seed, sample, pix)
        a = jrng.camera_jitter(jk, sampler=sampler,
                               sample_index=jnp.int32(sample), spp=spp)
        b = trng.camera_jitter(tk, sampler=sampler, spp=spp)
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


@pytest.mark.parametrize("n_lights", [1, 2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_vertex_uniforms_match_jax(n_lights, seed):
    pix = _pixels(seed + 2)
    jk, tk = _keys(seed, 3, pix)
    for bounce in range(6):
        a = jrng.vertex_uniforms(jk, bounce, n_lights)
        b = trng.vertex_uniforms(tk, bounce, n_lights)
        assert b.shape == (len(pix), 4 + 2 * n_lights)
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


@pytest.mark.parametrize("n_lights", [1, 3])
def test_debug_path_uniforms_match_jax(n_lights):
    a = jrng.debug_path_uniforms(33, 5, n_lights)
    b = trng.debug_path_uniforms(33, 5, n_lights)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for bounce in (0, 5):
        np.testing.assert_array_equal(
            trng.vertex_uniforms(b, bounce, n_lights).numpy(),
            np.asarray(jrng.vertex_uniforms(a, bounce, n_lights)))


def test_permuted_rows_draw_their_own_stream():
    """Rows moved by the integrator's _permute keep their lane's key words
    and sample index: each draws its own lane's stream, bit for bit."""
    pix = _pixels(9)
    sample = np.random.default_rng(9).integers(0, 16, len(pix))
    keys = trng.lane_keys(42, torch.from_numpy(sample), torch.from_numpy(pix))
    perm = torch.from_numpy(np.random.default_rng(10).permutation(len(pix)))
    moved = tint._permute(keys, perm)
    for bounce in (0, 4):
        assert torch.equal(trng.vertex_uniforms(moved, bounce, 2),
                           trng.vertex_uniforms(keys, bounce, 2)[perm])
    assert torch.equal(trng.camera_jitter(moved, "stratified", 16),
                       trng.camera_jitter(keys, "stratified", 16)[perm])


def test_multi_sample_wave_keys_per_lane():
    """A wave holding several samples keys each lane by its own sample, as
    the reference's one-sample waves do."""
    pix = np.arange(64, dtype=np.int32)
    sample = np.repeat(np.arange(4), 16).astype(np.int64)
    tk = trng.lane_keys(1, torch.from_numpy(sample), torch.from_numpy(pix))
    got = trng.camera_jitter(tk, "stratified", 4).numpy()
    for s in range(4):
        rows = sample == s
        jk = jrng.lane_keys(1, jnp.int32(s), jnp.asarray(pix[rows]))
        want = jrng.camera_jitter(jk, "stratified", jnp.int32(s), 4)
        np.testing.assert_array_equal(_bits(got[rows]), _bits(want))


