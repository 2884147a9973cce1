"""The benchmark's sweep-route cell (bunny600k_offline) at a small size on
the CPU: the garden of `pbrt_bench/configs/bunny_garden_600k.json`, with the
frozen bunny generator cut to a few thousand triangles and the film to
16x16, four instances under the TLAS, the mesh sent to the cull-sweep by a
lowered wide-kernel budget (as test_torch_sweep's routed build does). The
run goes through the benchmark's own path (`pbrt_bench.core.execute`): the
program's `render()` over the turntable's views at depth 5 with NEE,
against the plain reference (`pbrt_bench/reference`, its own BVH and
Moller-Trumbore test) on the same seed by `check.mismatch_pct`, under the
cell's own limit. A planted fault (every frame scaled by 1.001) fails it.
"""
import copy
import time

import pytest

from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from pbrt_bench import core

CELL = "bunny600k_offline"
TRIS = 3000
SIZES = {"width": 16, "height": 16, "spp": 2, "pixels_per_view": 256,
         "warmup_frames": 1}


def _cell():
    cell = core.load(CELL)
    cfg = copy.deepcopy(cell.config)
    meshes = [op["mesh"] for op in cfg["scene"]
              if op["op"] == "instanced_mesh"]
    assert [m["target_tris"] for m in meshes] == [600000]
    meshes[0]["target_tris"] = TRIS
    cell.config = cfg
    return cell


def _run(monkeypatch, seed, alter=None):
    monkeypatch.setattr(TW, "_VMEM_BUDGET", 1024)
    seen = {}

    def look(loop):
        seen["scene"] = loop.scenes[0]
        loop.alter = alter

    out = core.execute(_cell(), seed, 0.2, False, "cpu", time.perf_counter(),
                       sizes=SIZES, fault=look)
    meta, pack = seen["scene"].meta, seen["scene"].pack
    # the one mesh family, four instances, takes the sweep, not the wide
    # kernel
    assert meta.pallas_blas == (True,) and meta.wide_blas == (False,)
    assert pack.inst_sweep[0].n_inst == 4
    return out


@pytest.mark.parametrize("seed", [2**31 + 5, 3700000004])
def test_sweep_route_agrees_with_the_reference(monkeypatch, seed):
    out = _run(monkeypatch, seed)
    check = out["checks"]["mismatch_pct"]
    assert check["limit"] == core.load(CELL).limits["mismatch_pct"]
    assert out["correct"] and out["failed"] == 0, out
    assert out["attempted"] >= 1


def test_a_scaled_frame_on_the_sweep_route_is_not_correct(monkeypatch):
    out = _run(monkeypatch, 2**31 + 5, alter=lambda k, img: img * 1.001)
    assert not out["correct"], out
