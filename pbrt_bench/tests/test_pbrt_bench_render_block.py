"""A configuration's render block decides what both sides compute: mis and
nee reach the program's render() and render_fn() and the reference (the
control with it), and a block that the harness cannot honour is refused
when the cell loads."""
import json
import os
import time

import pytest
import torch

from pbrt_bench import control, core, program_scene, refcheck, traffic
from pbrt_bench.reference import render as ref_render

FRAMES = {"width": 8, "height": 8, "spp": 2, "pixels_per_view": 64,
          "warmup_frames": 1}
FIT = {"width": 8, "height": 8, "target_spp": 1}
SEED = 2**31 + 9


def _cell(tmp_path, workload, **render):
    """The cell `workload` with its configuration's render block changed,
    loaded as a cell whose configuration file says so."""
    spec = json.load(open(core.BENCH))
    w = next(x for x in spec["workloads"] if x["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.load(open(os.path.join(core.ROOT, conf["file"])))
    cfg["render"].update(render)
    for key in [k for k, v in render.items() if v is None]:
        del cfg["render"][key]
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    conf["file"] = str(path)
    return core.Cell(spec, workload)


def test_the_configs_state_what_render_defaults_to():
    # so the program's wave key, graph and frames stay as they were
    for name in ("bunny_offline", "cornell_offline", "bunny600k_offline",
                 "bunny_fit"):
        assert traffic.estimator(core.load(name).config) == {
            "mis": False, "nee": True}


@pytest.mark.parametrize("workload,render,key", [
    ("cornell_offline", {"integrator": "whitted"}, "render.integrator"),
    ("cornell_offline", {"sampler": "stratified"}, "render.sampler"),
    ("cornell_offline", {"mis": True, "nee": False}, "render.mis"),
    ("bunny_fit", {"nee": False}, "render.nee"),
    ("cornell_offline", {"mis": "yes"}, "render.mis"),
    ("cornell_offline", {"clamp": False}, "render.clamp"),
    ("cornell_offline", {"nee": None}, "render.nee"),
], ids=["integrator", "sampler", "mis-without-nee", "fit-without-nee",
        "not-a-bool", "unread-key", "unstated-key"])
def test_a_render_block_the_harness_cannot_honour_is_refused(
        tmp_path, workload, render, key):
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        _cell(tmp_path, workload, **render)


@pytest.mark.parametrize("render", [{}, {"mis": True}, {"nee": False}],
                         ids=["default", "mis", "no-nee"])
def test_frames_hand_render_the_configs_estimator(tmp_path, render):
    cell = _cell(tmp_path, "cornell_offline", **render)
    loop = traffic.Frames(program_scene.build(cell.config), cell.config,
                          cell.traffic, SEED, torch.device("cpu"), 8, 8, 16)
    calls = []
    real = loop.render

    def recording(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    loop.render = recording
    loop.frame(0)
    want = {"mis": False, "nee": True, **render}
    assert {k: calls[0][k] for k in ("mis", "nee")} == want


@pytest.mark.parametrize("render", [{}, {"mis": True}],
                         ids=["default", "mis"])
def test_the_fit_hands_render_fn_the_configs_mis(tmp_path, monkeypatch,
                                                 render):
    from jet_pbrt_tpu_torch.models import render as program_render

    cell = _cell(tmp_path, "bunny_fit", **render)
    calls = []
    real = program_render.render_fn

    def recording(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(program_render, "render_fn", recording)
    target = torch.zeros((8, 8, 3))
    traffic.Fit(program_scene.build(cell.config), cell.config, cell.traffic,
                SEED, torch.device("cpu"), 8, 8, target)
    assert calls[0]["mis"] is render.get("mis", False)


def _run(cell):
    return core.execute(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                        sizes=FRAMES)


@pytest.mark.parametrize("render", [{"mis": True}, {"nee": False}],
                         ids=["mis", "no-nee"])
def test_the_estimator_reaches_both_sides(tmp_path, monkeypatch, render):
    cell = _cell(tmp_path, "cornell_offline", **render)
    out = _run(cell)
    assert out["correct"], out
    assert out["checks"]["mismatch_pct"]["value"] == 0.0

    # the same frames checked against the default estimator's reference
    real = refcheck.frame_pixels

    def default_reference(config, *args, **kw):
        config = dict(config, render=dict(config["render"], mis=False,
                                          nee=True))
        return real(config, *args, **kw)
    monkeypatch.setattr(refcheck, "frame_pixels", default_reference)
    out = _run(cell)
    check = out["checks"]["mismatch_pct"]
    assert not out["correct"] and check["value"] > check["limit"], out


@pytest.mark.parametrize("workload,sizes", [("cornell_offline", FRAMES),
                                            ("bunny_fit", FIT)])
def test_the_control_of_a_mis_cell_is_a_mis_control(tmp_path, monkeypatch,
                                                    workload, sizes):
    cell = _cell(tmp_path, workload, mis=True)
    seen = set()
    real = ref_render.li_path

    def recording(scene, *args, **kw):
        seen.add((scene.dtype, kw["mis"], kw["nee"]))
        return real(scene, *args, **kw)
    monkeypatch.setattr(ref_render, "li_path", recording)
    ok, checks = control.judge_control(cell, 7, "cpu", sizes)
    assert not ok, checks
    # the float32 reference and its bfloat16 control both run MIS
    assert seen == {(torch.float32, True, True), (torch.bfloat16, True, True)}
