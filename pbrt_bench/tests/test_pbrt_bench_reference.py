"""The plain reference against the program on the CPU, and what each
process may import."""
import json
import os
import subprocess
import sys

import pytest
import torch

from pbrt_bench import core, program_scene
from pbrt_bench.reference import render as ref_render
from pbrt_bench.reference import scene as ref_scene


def _config(name):
    return json.load(open(os.path.join(core.HERE, "configs", name + ".json")))


# a sphere light and a disk light in the Cornell box: the area-light
# shapes that no configuration has, for pdf_li's other branches
SHAPE_LIGHTS = [
    {"op": "sphere", "center": [150, 420, 300], "radius": 40,
     "material": "white", "light": [6.0, 5.0, 4.0]},
    {"op": "disk", "center": [400, 80, 250], "normal": [0, 1, 0],
     "radius": 60, "material": "white", "light": [3.0, 4.0, 5.0]}]


def _variant(name, shapes=(), **render):
    """A configuration in memory with some render keys changed and some
    scene operations appended."""
    cfg = _config(name)
    return dict(cfg, render=dict(cfg["render"], **render),
                scene=cfg["scene"] + list(shapes))


def _cases():
    for name, res, spp in (("cornell_box", 16, 4), ("bunny_garden", 16, 2)):
        yield pytest.param(name, res, spp, {}, (), id=f"{name}-{res}-{spp}")
        for tag, render in (("mis", {"mis": True}),
                            ("no-nee", {"nee": False})):
            yield pytest.param(name, res, spp, render, (),
                               id=f"{name}-{res}-{spp}-{tag}")
    yield pytest.param("cornell_box", 16, 4, {"mis": True}, SHAPE_LIGHTS,
                       id="cornell_box-16-4-mis-shape-lights")


@pytest.mark.parametrize("name,res,spp,render,shapes", list(_cases()))
def test_reference_equals_the_program_on_the_cpu(name, res, spp, render,
                                                 shapes):
    from jet_pbrt_tpu_torch.models.render import render as program_render

    from pbrt_bench import traffic

    cfg = _variant(name, shapes, **render)
    est = traffic.estimator(cfg)
    img = program_render(program_scene.build(cfg), res, res, spp, seed=11,
                         device="cpu", **est)
    lay = ref_scene.Layout(cfg)
    cam = ref_render.make_camera(lay.lookfrom, tuple(
        torch.tensor(lay.lookat, dtype=torch.float64)
        - torch.tensor(lay.lookfrom, dtype=torch.float64)), lay.vup,
        lay.vfov, (res, res), "cpu")
    ref = ref_render.pixels(ref_scene.RefScene(lay, "cpu"), cam, res, 11,
                            torch.arange(res * res), spp, 5, **est)
    # the same samples through the same float32 arithmetic: bit for bit
    assert torch.equal(img.view(-1, 3), ref)
    if render:
        # and the configuration's estimator is not the default's
        plain = ref_render.pixels(ref_scene.RefScene(lay, "cpu"), cam, res,
                                  11, torch.arange(res * res), spp, 5)
        assert not torch.equal(plain, ref)


def test_the_fit_hands_both_sides_the_benchmarks_own_target():
    from pbrt_bench import refcheck, traffic

    cell = core.load("bunny_fit")
    lay = ref_scene.Layout(cell.config)
    tr = dict(cell.traffic, target_spp=1)
    seed = 2**31 + 5
    target = refcheck.fit_target(cell.config, lay, tr, seed, 8, 8, "cpu")
    assert torch.equal(target, refcheck.fit_target(cell.config, lay, tr,
                                                   seed, 8, 8, "cpu"))
    assert not torch.equal(target, refcheck.fit_target(
        cell.config, lay, tr, seed + 1, 8, 8, "cpu"))
    loop = traffic.Fit(program_scene.build(cell.config), cell.config, tr,
                       seed, torch.device("cpu"), 8, 8, target)
    # the program's loss is taken against its own copy of the same target
    assert torch.equal(loop.target, target)
    assert loop.target.data_ptr() != target.data_ptr()


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=core.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_process_loads_neither_jax_nor_the_program():
    code = (
        "import json, sys, torch\n"
        "from pbrt_bench import refcheck, core\n"
        "from pbrt_bench.reference import scene\n"
        "lay = scene.Layout(core.load('cornell_offline').config)\n"
        "v = refcheck.frame_pixels(core.load('cornell_offline').config, lay,"
        " [((278, 273, 960), (0, 0, -960))], [0], torch.arange(8), 1, 3, 8,"
        " 8, 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    names = _modules_after(code)
    assert not names & {"jax", "jaxlib", "flax", "jet_pbrt_tpu",
                        "jet_pbrt_tpu_torch"}


def test_a_rehearsal_run_loads_no_jax():
    code = (
        "import json, sys, time\n"
        "from pbrt_bench import core\n"
        "cell = core.load('cornell_offline')\n"
        "out = core.execute(cell, 3, 0.05, False, 'cpu', time.perf_counter(),"
        " sizes={'width': 8, 'height': 8, 'spp': 1, 'pixels_per_view': 8,"
        " 'warmup_frames': 1})\n"
        "assert out['correct'], out\n"
        "assert core.forbidden_modules() == []\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    names = _modules_after(code)
    assert "jet_pbrt_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "jet_pbrt_tpu"}


def test_the_forbidden_check_compares_whole_names():
    assert "jet_pbrt_tpu" not in core.forbidden_modules(("jet_pbrt_tpu",)) \
        or "jet_pbrt_tpu" in {m.split(".")[0] for m in sys.modules}
    sys.modules["jet_pbrt_tpu_fake_probe"] = object()
    try:
        assert core.forbidden_modules(("jet_pbrt_tpu",)) == []
        assert core.forbidden_modules(("jet_pbrt_tpu_fake_probe",)) == [
            "jet_pbrt_tpu_fake_probe"]
    finally:
        del sys.modules["jet_pbrt_tpu_fake_probe"]
