"""The sweep route's reader (metrics/sweep_ms_per_wave.py) on synthetic
traces, and the sweep cell's entries."""
import pytest

from pbrt_bench import core, trace


def _read(device, waves=2):
    t = trace.Trace(device, [], (0.0, 0.010), {"waves": waves, "frames": 1},
                    {})
    return core.reader(core.HERE, "sweep_ms_per_wave")(t)


def test_sweep_ms_per_wave_sums_the_sweep_kernel_over_the_waves():
    device = [("void sweep_bvh_kernel<true>(SweepArgs)", 0.0, 0.003),
              ("void sweep_bvh_kernel<false>(SweepArgs)", 0.003, 0.004),
              ("shade_vertex_kernel", 0.004, 0.005),
              ("brute_hits_kernel<false,256>", 0.005, 0.006)]
    assert _read(device) == pytest.approx(4.0 / 2)


def test_sweep_ms_per_wave_reads_nothing_on_the_wide_route():
    device = [("wide_walk_kernel<0>", 0.0, 0.002),
              ("wide_cull_kernel", 0.002, 0.0025),
              ("shade_vertex_kernel", 0.003, 0.004)]
    assert _read(device) is None
    assert _read([("sweep_bvh_kernel", 0.0, 0.001)], waves=0) is None


def test_the_sweep_cell_reads_the_sweep_and_not_the_wide_kernel():
    cell = core.load("bunny600k_offline")
    names = {m["name"] for m in cell.per_layer}
    assert {"sweep_ms_per_wave", "wave_device_ms", "device_idle_pct.offline",
            "brute_ms_per_wave", "vertex_roofline_pct",
            "replay_gap_ms.offline"} <= names
    assert "traversal_ms_per_wave" not in names
    assert [m["name"] for m in cell.end_to_end] == ["samples_per_s",
                                                     "setup_s"]
    mesh = [op["mesh"] for op in cell.config["scene"]
            if op["op"] == "instanced_mesh"]
    assert mesh == [{"generator": "bunny", "target_tris": 600000}]
