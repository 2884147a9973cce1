"""The frozen byte counts reproduce the program's own counts."""
import json
import os

from pbrt_bench import core, yardstick
from pbrt_bench.reference import scene as ref_scene

N = 1 << 20


def test_vertex_bytes_of_the_bunny_bounce_one_vertex():
    tables = yardstick.table_bytes(6, 2, 0, 2)
    assert tables == 602
    assert yardstick.vertex_bytes(N, 2, 2, tables, False) == 250_610_270
    # the count before the vertex wrote the next cast's bounds
    assert yardstick.vertex_bytes(N, 2, 2, tables, False,
                                  bounds=False) == 242_221_658


def test_vertex_backward_bytes_of_the_bunny_bounce_one_vertex():
    assert yardstick.partial_rows(N, 57) == 1024
    assert yardstick.vertex_backward_bytes(N, 2, 2, 57, False) \
        == 135_499_776


def test_scene_facts_of_the_bunny_config():
    cfg = json.load(open(os.path.join(core.HERE, "configs",
                                      "bunny_garden.json")))
    f = core.scene_facts(ref_scene.Layout(cfg), 1024, 1024, 5)
    assert (f["n_lights"], f["nee_lights"], f["n_mats"]) == (2, 2, 6)
    assert f["tables"] == 602 and f["slots"] == 57
