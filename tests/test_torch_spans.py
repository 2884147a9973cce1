"""The program's profiler spans (utils/log.py::span): a torch.profiler
record_function range while a profiler records, nothing at all while none
does.

On the CPU: the helper enters no record_function with the profiler off
(counted on torch.ops.profiler._record_function_enter_new), nor does a
whole render(), a key's eager call or a replay; under a profiler the
range is recorded. render() gives one "render.frame" a call, holding
"render.setup", "render.film", "render.finalize" and one "render.wave" a
wave, properly nested; GraphCache.run gives "graph.eager" around a key's
op-by-op calls; a captured entry with a stub graph gives "graph.copy_in",
"graph.launch" and "graph.count" in that order, per replay of a wave and
per forward and backward of a two-graph gradient.

Marked `cuda` (skipping without a card): a replayed wave of render()
gives "graph.key", "graph.copy_in", "graph.launch" and "graph.count"
inside "render.wave", and a graphed value_and_grad step the same inside
"diff.value_and_grad"; each replayed call runs with the profiler on under
torch.cuda.set_sync_debug_mode("error"). JAX-free; on the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_spans.py
"""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jet_pbrt_tpu_torch.models import graph as G
from jet_pbrt_tpu_torch.models import render as R
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.utils.log import span

torch.set_num_threads(2)

REPLAY = ("graph.copy_in", "graph.launch", "graph.count")


@pytest.fixture
def enters(monkeypatch):
    """The names of every record_function entered while the test runs."""
    real = torch.ops.profiler._record_function_enter_new
    names = []

    def counting(name, args=None):
        names.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting)
    return names


def _spans(prof, prefixes=("render.", "graph.", "diff.", "li_path.")):
    """(name, start, end) of the program's spans on the host in a trace
    (not their device-side copies), by start."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.name.startswith(prefixes)
           and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _inside(spans, outer):
    """The spans inside each span named outer, in order: [[name, ...]]."""
    return [[n for n, s, e in spans if a <= s and e <= b and (n, s, e)
             != (outer, a, b)]
            for name, a, b in spans if name == outer]


def _nested(spans) -> bool:
    """Whether every two spans are disjoint or one holds the other."""
    return all(e1 <= s2 or e2 <= s1 or (s1 <= s2 and e2 <= e1)
               or (s2 <= s1 and e1 <= e2)
               for i, (_, s1, e1) in enumerate(spans)
               for _, s2, e2 in spans[i + 1:])


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stub_call():
    """A CapturedCall of one [3] input whose graph is a stub."""
    entry = G.CapturedCall.__new__(G.CapturedCall)
    entry.inputs, entry.graph = (torch.zeros(3),), _StubGraph()
    entry.launches, entry.outputs = {}, torch.full((3,), 7.0)
    return entry


def _stub_forward_backward():
    """A CapturedForwardBackward of one [3] input whose graphs are stubs."""
    entry = G.CapturedForwardBackward.__new__(G.CapturedForwardBackward)
    entry.inputs = (torch.zeros(3),)
    entry.forward_graph, entry.backward_graph = _StubGraph(), _StubGraph()
    entry.outputs, entry.grad_outputs = torch.ones(()), torch.zeros(())
    entry.grads = (torch.zeros(3),)
    entry.launches = {"forward": {}, "backward": {}}
    entry._taped = False
    return entry


def _cache_calls(n_eager: int):
    """n_eager eager calls of one key through a GraphCache, then a capture
    by a stub entry and two replays of it."""
    cache = G.GraphCache()

    def capture(fn, inputs):
        entry = _stub_call()
        entry.warmup_outputs = fn(*inputs)
        return entry

    for i in range(n_eager + 3):
        cache.run("k", lambda x: x + 1, (torch.full((3,), float(i)),),
                  n_eager, capture)
    return cache.entries["k"]


def _render_small(**kw):
    # 8^2, 2 spp in waves of one sample (chunk 64): two waves a frame
    return R.render(tscenes.cornell_box(), 8, 8, 2, max_depth=2,
                    device="cpu", chunk=64, **kw)


def test_span_enters_no_record_function_with_the_profiler_off(enters):
    with span("a"), span("b"):
        with span("a"):
            pass
    _render_small()
    _cache_calls(2)
    entry = _stub_forward_backward()
    entry.forward((torch.ones(3),))
    entry.backward(torch.ones(()))
    assert enters == []
    assert span("a") is span("b")


def test_span_is_a_record_function_under_the_profiler(enters):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("a"):
            with span("b"):
                pass
    assert enters == ["a", "b"]
    got = _spans(prof, ("a", "b"))
    assert [n for n, _, _ in got] == ["a", "b"]
    assert got[0][1] <= got[1][1] and got[1][2] <= got[0][2]
    # and off again once the profiler has stopped
    with span("c"):
        pass
    assert enters == ["a", "b"]


def test_render_frame_span_holds_the_frame_steps():
    """Two calls of a two-wave frame on the CPU: two render.frame spans,
    each holding render.setup, render.film (the film's zeros and each
    wave's adds), two render.wave and render.finalize in order, with
    li_path's ranges inside the waves only, every span nested."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render_small()
        img, stats = _render_small(with_stats=True)
    assert img.shape == (8, 8, 3) and stats["rays"] > 0
    spans = _spans(prof)
    assert _nested(spans)
    frames = _inside(spans, "render.frame")
    assert len(frames) == 2
    for inner in frames:
        steps = [n for n in inner if n in ("render.setup", "render.film",
                                           "render.wave", "render.finalize")]
        assert steps == ["render.setup", "render.film", "render.wave",
                         "render.film", "render.wave", "render.film",
                         "render.finalize"]
        assert not any(n.startswith("graph.") for n in inner)
    waves = _inside(spans, "render.wave")
    assert len(waves) == 4
    assert all(w and all(n.startswith("li_path.") for n in w) for w in waves)
    li = sum(n.startswith("li_path.") for n, _, _ in spans)
    assert li == sum(len(w) for w in waves)
    for name in ("render.setup", "render.film", "render.finalize"):
        assert _inside(spans, name) == [[]] * (
            6 if name == "render.film" else 2)


@pytest.mark.parametrize("n_eager", [0, 2])
def test_graph_cache_spans_eager_calls_and_replays(n_eager):
    """A key's op-by-op calls are graph.eager spans; its replays are
    graph.copy_in, graph.launch and graph.count in that order, each
    copying the caller's values in and replaying the graph once."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry = _cache_calls(n_eager)
    spans = _spans(prof)
    assert _nested(spans)
    assert [n for n, _, _ in spans] == ["graph.eager"] * n_eager + \
        list(REPLAY) * 2
    assert entry.graph.replays == 2
    assert torch.equal(entry.inputs[0], torch.full((3,), n_eager + 2.0))


def test_forward_backward_spans_each_replay():
    """A two-graph gradient's forward and backward: each graph.copy_in
    (the inputs; the output's gradient), graph.launch and graph.count,
    in that order."""
    entry = _stub_forward_backward()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry.forward((torch.ones(3),))
        entry.backward(torch.full((), 2.0))
    assert [n for n, _, _ in _spans(prof)] == list(REPLAY) * 2
    assert entry.forward_graph.replays == entry.backward_graph.replays == 1
    assert torch.equal(entry.inputs[0], torch.ones(3))
    assert float(entry.grad_outputs) == 2.0


@contextlib.contextmanager
def _no_sync():
    """Raise at any operation that synchronises the host with the card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _cuda_profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_replayed_wave_spans_on_card():
    """render() at 32^2, 2 spp in one wave, graph=True: after the
    capturing frame each frame's render.wave holds graph.key and a
    replay's three spans, in order, and nothing else of the graph layer;
    the compiled wave's replayed call alone, with the profiler on, does
    not synchronise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    scene = tscenes.cornell_box()
    kw = dict(seed=3, max_depth=3, device="cuda", graph=True)
    G.clear()
    want = R.render(scene, 32, 32, 2, **kw).clone()
    with _cuda_profile() as prof:
        imgs = [R.render(scene, 32, 32, 2, **kw).clone() for _ in range(2)]
        torch.cuda.synchronize()
    assert all(torch.equal(img, want) for img in imgs)
    spans = _spans(prof)
    assert _nested(spans)
    assert _inside(spans, "render.wave") == [["graph.key", *REPLAY]] * 2
    assert len(_inside(spans, "render.frame")) == 2
    _, pack, cam = R.setup(scene, 32, 32, "cuda")
    wave = R.compiled_wave_fn(scene.meta, 32, 3, seed=3)
    pixel = torch.arange(32 * 32, device="cuda")
    sample = torch.zeros_like(pixel)
    wave(pack, cam, sample, pixel)      # the capture
    torch.cuda.synchronize()
    with _cuda_profile() as prof:
        with _no_sync():
            wave(pack, cam, sample, pixel)
        torch.cuda.synchronize()
    assert [n for n, _, _ in _spans(prof)] == ["graph.key", *REPLAY]
    G.clear()


@pytest.mark.cuda
def test_graphed_value_and_grad_spans_on_card():
    """compile_value_and_grad of a 16^2, 1-spp render_fn loss: after the
    capturing call each step is a diff.value_and_grad span holding
    graph.key and a replay's three spans, in order, and the replayed
    steps, with the profiler on, do not synchronise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from jet_pbrt_tpu_torch.diff import params as P
    fn, pack = R.render_fn(tscenes.cornell_box(), 16, 16, 1, seed=1,
                           max_depth=3, device="cuda")
    with torch.no_grad():
        target = fn(pack._replace(light_c=pack.light_c * 1.2))
    vg = P.compile_value_and_grad(P.loss_fn(fn, pack, target))
    params = P.get_params(pack, ("mat_c0", "light_c"))
    G.clear()
    want = vg(params)[0].clone()       # the capture
    torch.cuda.synchronize()
    with _cuda_profile() as prof:
        with _no_sync():
            vals = [vg(params)[0].clone() for _ in range(2)]
        torch.cuda.synchronize()
    assert all(torch.equal(v, want) for v in vals)
    spans = _spans(prof)
    assert _nested(spans)
    assert _inside(spans, "diff.value_and_grad") == [
        ["graph.key", *REPLAY]] * 2
    vg.release()
    G.clear()
