"""BENCHMARK.json against the contract's shape, and every cell resolving
to its files."""
import json
import os
import re

import pytest

from pbrt_bench import core

SPEC = json.load(open(core.BENCH))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["pbrt_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in SPEC["configs"])) == len(SPEC["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pbrt_bench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = core.load(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["kind"] in ("frames", "fit")
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.per_layer:
        # the cell reports the end-to-end metric its per-layer metric moves
        assert m["moves"] in {x["name"] for x in c.end_to_end}
        assert callable(core.reader(c.base, m["name"]))
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_every_file_is_named_by_the_spec():
    base = os.path.dirname(core.BENCH)
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(base, c["file"]))
    traffics = {w["traffic"] for w in SPEC["workloads"]}
    assert traffics == {f[:-5] for f in os.listdir(
        os.path.join(core.HERE, "traffic"))}
    readers = {m["name"] for m in SPEC["per_layer"]}
    assert readers == {f[:-3] for f in os.listdir(
        os.path.join(core.HERE, "metrics")) if f.endswith(".py")}
