"""The span readers (pbrt_bench/spans.py and the metrics that use it) on
synthetic traces: each idle gap split among the innermost spans over it,
the 20 us cut, the values per wave, step and frame, self time, no reading
without the program's spans, and the split summing to the window's idle."""
import pytest

from pbrt_bench import core, spans, trace

MS = 1e-3


def _frame_trace(counts=None):
    """One frame of two waves in a 10 ms window. Device busy [0, 1],
    [1.005, 2], [4, 6], [6.1, 9] ms: gaps of 5 us (short), 2 ms, 100 us
    and 1 ms."""
    device = [("k", 0.0, 1 * MS), ("k", 1.005 * MS, 2 * MS),
              ("k", 4 * MS, 6 * MS), ("k", 6.1 * MS, 9 * MS)]
    host = [(n, s * MS, e * MS) for n, s, e in [
        ("bench.window", 0.0, 10.0),
        ("ProfilerStep#1", 0.0, 10.0),
        ("bench.render", 0.0, 9.5),
        ("render.frame", 0.1, 9.4),
        ("render.setup", 1.9, 2.5),
        ("cudaStreamSynchronize", 2.0, 2.1),
        ("render.wave", 2.5, 3.9),
        ("graph.key", 2.6, 3.0),
        ("graph.copy_in", 3.0, 3.5),
        ("aten::copy_", 3.1, 3.2),
        ("graph.launch", 3.5, 3.8),
        ("cudaGraphLaunch", 3.55, 3.75),
        ("graph.count", 3.8, 3.9),
        ("render.finalize", 5.9, 6.2),
        # a capture in busy time: 0.3 of its 0.8 ms under a child span
        ("graph.capture", 6.2, 7.0),
        ("li_path.vertex", 6.3, 6.6),
        ("cudaStreamSynchronize", 9.6, 9.7)]]
    return trace.Trace(device, host, (0.0, 10 * MS),
                       counts or {"waves": 2, "frames": 1}, {})


def _read(name, t):
    return core.reader(core.HERE, name)(t)


def test_each_gap_is_split_among_the_innermost_spans():
    got = spans.idle_split(_frame_trace())
    want = {"render.setup": 0.5, "render.wave": 0.1, "graph.key": 0.4,
            "graph.copy_in": 0.5, "graph.launch": 0.3, "graph.count": 0.1,
            "render.frame": 0.1 + 0.4, "render.finalize": 0.1,
            "bench.render": 0.1, spans.OUTSIDE: 0.5, spans.SHORT: 0.005}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * MS, abs=1e-12), k


def test_the_split_sums_to_the_idle_share_of_the_window():
    t = _frame_trace()
    assert sum(spans.idle_split(t).values()) == pytest.approx(
        t.idle_pct() / 100 * t.window_s, abs=1e-12)


def test_gaps_under_20_us_are_not_put_down_to_a_span():
    """A 19 us gap and a 21 us gap inside one graph.launch: only the
    second counts; the first is a short gap."""
    device = [("k", 0.0, 100e-6), ("k", 119e-6, 200e-6),
              ("k", 221e-6, 300e-6)]
    host = [("graph.launch", 0.0, 300e-6)]
    t = trace.Trace(device, host, (0.0, 300e-6), {"waves": 1}, {})
    got = spans.idle_split(t)
    assert got["graph.launch"] == pytest.approx(21e-6)
    assert got[spans.SHORT] == pytest.approx(19e-6)
    assert _read("replay_gap_ms.offline", t) == pytest.approx(0.021)


def test_readers_give_their_values_per_wave_step_and_frame():
    t = _frame_trace({"waves": 2, "frames": 1, "steps": 4})
    graph_idle = 0.4 + 0.5 + 0.3 + 0.1
    assert _read("replay_gap_ms.offline", t) == pytest.approx(graph_idle / 2)
    assert _read("replay_gap_ms.preview", t) == pytest.approx(graph_idle / 2)
    assert spans.per(t, spans.idle_under(t, "graph."), "steps") == \
        pytest.approx(graph_idle / 4)
    # render.* spans: setup, the wave's own time, the frame's, finalize
    assert _read("frame_gap_ms", t) == pytest.approx(0.5 + 0.1 + 0.5 + 0.1)
    # one wait inside render.frame, one after it
    assert _read("frame_syncs", t) == 1.0


def test_replay_host_ms_counts_self_time():
    """The graph.* spans' lengths, less the li_path span inside the
    capture: (0.4 + 0.5 + 0.3 + 0.1 + 0.8 - 0.3) ms over two waves; the
    runtime and aten events inside them are not spans."""
    assert _read("replay_host_ms", _frame_trace()) == pytest.approx(1.8 / 2)
    assert spans.self_seconds(_frame_trace(), "render.wave") == \
        pytest.approx((1.4 - 1.3) * MS)


def test_readers_return_none_without_their_spans():
    """The parent's trace: the benchmark's spans and render.wave, no
    render.frame and no graph.* span; and a trace with no runtime call."""
    keep = ("bench.", "render.wave", "cuda")
    t = _frame_trace()
    old = trace.Trace(t.device, [x for x in t.host if x[0].startswith(keep)],
                      t.window, t.counts, {})
    for name in ("replay_gap_ms.offline", "replay_gap_ms.preview",
                 "replay_host_ms", "frame_gap_ms", "frame_syncs"):
        assert _read(name, old) is None, name
    quiet = trace.Trace(t.device, [x for x in t.host
                                   if not x[0].startswith("cuda")],
                        t.window, t.counts, {})
    assert _read("frame_syncs", quiet) is None
    assert _read("frame_gap_ms", quiet) is not None
    none_counted = trace.Trace(t.device, t.host, t.window, {}, {})
    assert _read("replay_gap_ms.offline", none_counted) is None
