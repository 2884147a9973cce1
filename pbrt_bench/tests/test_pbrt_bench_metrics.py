"""The metric arithmetic on synthetic numbers and a synthetic trace."""
import numpy as np
import pytest

from pbrt_bench import core, trace, yardstick


def test_union_of_overlapping_intervals():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.busy_intervals([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2),
                                                              (3, 4)]


def test_frame_values_take_every_frame_and_the_whole_window():
    times = [0.010] * 90 + [0.050] * 10
    v = core.frame_values(times, wall_s=2.0, samples_per_frame=1000)
    assert v["frame_ms_p95"] == pytest.approx(np.percentile(
        [t * 1e3 for t in times], 95))
    # a rate over all the frames and all the window, not a median of chunks
    assert v["samples_per_s"] == pytest.approx(100 * 1000 / 2.0)


def _trace():
    device = [("wide_walk_kernel<0>", 0.0, 0.002),
              ("wide_cull_kernel", 0.002, 0.0025),
              ("shade_vertex_kernel", 0.003, 0.004),
              ("brute_hits_kernel<false,256>", 0.0035, 0.0045),
              ("vertex_backward_kernel<2>", 0.006, 0.008),
              ("grad_reduce_kernel", 0.008, 0.009)]
    host = [("bench.render", 0.0, 0.010), ("render.wave", 0.001, 0.003),
            ("render.wave", 0.004, 0.005), ("bench.sync", 0.009, 0.010)]
    facts = {"lanes": 1 << 20, "depth": 5, "n_lights": 2, "nee_lights": 2,
             "n_mats": 6, "tables": 602, "slots": 57}
    return trace.Trace(device, host, (0.0, 0.010),
                       {"waves": 2, "frames": 1, "steps": 1}, facts)


def test_readers_on_a_synthetic_trace():
    t = _trace()
    read = lambda n: core.reader(core.HERE, n)(t)
    # busy: [0, 0.0025] + [0.003, 0.0045] + [0.006, 0.009] = 7 ms of 10
    assert read("device_idle_pct.offline") == pytest.approx(30.0)
    assert read("frame_host_ms") == pytest.approx(7.0)
    assert read("wave_device_ms") == pytest.approx(7.5 / 2)
    assert read("traversal_ms_per_wave") == pytest.approx(2.5 / 2)
    assert read("brute_ms_per_wave") == pytest.approx(0.5)
    n = 1 << 20
    bound = (5 * yardstick.vertex_bytes(n, 2, 2, 602, False)
             + yardstick.vertex_bytes(n, 2, 2, 602, True))
    assert read("vertex_roofline_pct") == pytest.approx(
        100 * yardstick.bytes_ms(bound) / 0.5)
    per = lambda last: (yardstick.vertex_backward_bytes(n, 2, 2, 57, last)
                        + yardstick.grad_reduce_bytes(n, 57))
    assert read("vertex_backward_roofline_pct") == pytest.approx(
        100 * yardstick.bytes_ms(5 * per(False) + per(True)) / 3.0)


def test_a_reader_with_nothing_to_read_returns_none():
    t = trace.Trace([("other_kernel", 0.0, 0.001)], [], (0.0, 0.01),
                    {"waves": 1, "steps": 1}, _trace().facts)
    for name in ("traversal_ms_per_wave", "brute_ms_per_wave",
                 "vertex_roofline_pct", "vertex_backward_roofline_pct",
                 "frame_host_ms"):
        assert core.reader(core.HERE, name)(t) is None


def test_breakdown_names_gaps_by_the_host_range():
    b = _trace().breakdown(core.GAP_LABELS)
    assert b["device_ops"][0][0] == "wide_walk_kernel<0>"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # the longest gap, 0.0045-0.006, lies inside render and outside waves
    assert b["idle_gaps"][0][0] == "render"
    assert b["idle_gaps"][0][1] == pytest.approx(0.0015)
