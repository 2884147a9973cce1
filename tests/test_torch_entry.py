"""The port's entry points (jet_pbrt_tpu_torch/entry.py) against the
repo's `__graft_entry__.py` on the CPU.

entry(device="cpu"): its fn(*example_args) is the port's wave_fn output bit
for bit, and the reference's entry() function run op by op
(`jax.disable_jit()`: jitted XLA contracts a * b + c into FMAs) within
tests/test_torch_render.py's gates: at least 99% of the 4,096 lanes within
rtol 1e-4 / atol 1e-5 (torch's CPU libm rounds a few lanes onto another
path) and the mean within 1e-4 relative.

dryrun_multichip(2, device="cpu"): two spawned gloo ranks on the mesh
(1, 2) take one train step; its loss is finite, above 0, and equals the
single-process diff.params.value_and_grad loss of the same frame within
chip_smoke.TRAIN_RTOL (the spp axis reassociates the film's sum).
"""
import jax
import numpy as np
import torch

import __graft_entry__ as ref_entry
from chip_smoke import TRAIN_RTOL
from jet_pbrt_tpu_torch.diff import params as P
from jet_pbrt_tpu_torch.entry import DRYRUN_DEPTH, DRYRUN_RES, ENTRY_DEPTH, \
    ENTRY_RES, dryrun_multichip, entry
from jet_pbrt_tpu_torch.models.render import render_fn, setup, wave_fn
from jet_pbrt_tpu_torch.scene.scenes import cornell_box

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def test_entry_is_one_cornell_wave():
    fn, (pack, sample) = entry(device="cpu")
    got = fn(pack, sample)
    assert got.shape == (ENTRY_RES * ENTRY_RES, 3) and sample == 0
    assert pack.mat_c0.device.type == "cpu"
    ids = torch.arange(ENTRY_RES * ENTRY_RES)
    scene = cornell_box(lambert_only=False, use_bvh=False)
    wave = wave_fn(scene.meta, ENTRY_RES, ENTRY_DEPTH)
    _, _, cam = setup(scene, ENTRY_RES, ENTRY_RES, "cpu")
    assert torch.equal(got, wave(pack, cam, torch.zeros_like(ids), ids))
    assert torch.isfinite(got).all() and float(got.mean()) > 0.05


def test_entry_matches_reference_entry():
    fn, args = entry(device="cpu")
    got = fn(*args).numpy()
    jfn, jargs = ref_entry.entry()
    with jax.disable_jit():
        want = np.asarray(jfn(*jargs))
    off = ~np.all(np.isclose(got, want, rtol=RTOL, atol=ATOL), axis=-1)
    print(f"entry vs the reference's: {int(off.sum())} of {off.size} lanes "
          "outside")
    assert off.mean() <= 0.01, int(off.sum())
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


def test_dryrun_multichip_two_gloo_ranks(capsys):
    loss = dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss) and loss > 0
    assert "dryrun_multichip ok: mesh={'px': 1, 'spp': 2}" in \
        capsys.readouterr().out
    scene = cornell_box(lambert_only=False, use_bvh=False)
    fn, pack = render_fn(scene, DRYRUN_RES, DRYRUN_RES, 4,
                         max_depth=DRYRUN_DEPTH, device="cpu")
    with torch.no_grad():
        target = fn(pack)
    params = P.get_params(pack, ("mat_c0", "light_c"))
    params["mat_c0"] = params["mat_c0"] * 0.5 + 0.1
    single, _ = P.value_and_grad(P.loss_fn(fn, pack, target), params)
    assert abs(loss - float(single)) <= TRAIN_RTOL * float(single), (
        loss, float(single))
