"""A run driven on the CPU past the look for a card, with the timed path
broken underneath, comes out not correct; the control, the reference in
bfloat16, fails too; and the same runs unbroken come out correct."""
import time

import pytest
import torch

from pbrt_bench import control, core

FRAMES = {"width": 8, "height": 8, "spp": 2, "pixels_per_view": 64,
          "warmup_frames": 1}
FIT = {"width": 8, "height": 8, "target_spp": 1}


def _run(cell, fault=None, sizes=FRAMES, seed=2**31 + 5, seconds=0.2):
    return core.execute(core.load(cell), seed, seconds, False, "cpu",
                        time.perf_counter(), sizes=sizes, fault=fault)


def _half_the_samples(loop):
    render = loop.render

    def half(scene, w, h, spp, **kw):
        return render(scene, w, h, max(1, spp // 2), **kw)
    loop.render = half


def _answer_altered(loop):
    loop.alter = lambda k, img: img * (1.0 + 1e-3)


def _state_unchanged(loop):
    frame = loop.frame
    last = []

    def stale(k):
        img = frame(k)
        if last:
            return last[0]
        last.append(img)
        return img
    loop.frame = stale


def test_an_unbroken_frame_run_is_correct():
    out = _run("cornell_offline")
    assert out["correct"] and out["attempted"] > 1, out


@pytest.mark.parametrize("fault", [_half_the_samples, _answer_altered,
                                   _state_unchanged])
def test_a_broken_frame_run_is_not_correct(fault):
    out = _run("cornell_offline", fault)
    assert not out["correct"], out


def _fit_unchanged(loop):
    loop.alter = lambda i, val, g, new, old: (val, g, old)


def _fit_half_the_batch(loop):
    from jet_pbrt_tpu_torch.diff import params as P

    # the loss over the top half of the image's rows, the mean taken there
    target = loop.target
    h = target.shape[0] // 2
    fn = loop._fn

    def loss(params):
        img = fn(P.with_params(loop._pack, params))
        return torch.mean((img[:h] - target[:h]) ** 2)
    vg = lambda p: P.value_and_grad(loss, p)
    vg.release = loop.vg.release
    loop.vg = vg


def _fit_answer_altered(loop):
    loop.alter = lambda i, val, g, new, old: (
        val, g, {k: v * 1.1 if k == "light_c" else v for k, v in new.items()})


def test_an_unbroken_fit_is_correct():
    out = _run("bunny_fit", sizes=FIT)
    assert out["correct"], out


@pytest.mark.parametrize("fault", [_fit_unchanged, _fit_half_the_batch,
                                   _fit_answer_altered])
def test_a_broken_fit_is_not_correct(fault):
    out = _run("bunny_fit", fault, sizes=FIT)
    assert not out["correct"], out


@pytest.mark.parametrize("cell,sizes", [("cornell_offline", FRAMES),
                                        ("bunny_fit", FIT)])
def test_the_control_is_not_correct(cell, sizes):
    c = core.load(cell)
    ok, checks = control.judge_control(c, 7, "cpu", sizes)
    assert not ok, checks


@pytest.mark.card
@pytest.mark.parametrize("cell", ["bunny_offline", "cornell_offline",
                                  "bunny_preview", "bunny_fit"])
def test_the_control_fails_at_the_cells_own_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size on the card")
    c = core.load(cell)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        ok, checks = control.judge_control(c, seed, torch.device("cuda", 0))
        print(cell, seed, checks)
        assert not ok, checks
