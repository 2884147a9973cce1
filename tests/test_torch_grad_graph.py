"""The graphed gradient paths' parts that run without a card
(models/graph.py, diff/params.py, parallel/train.py).

Capture safety of both gradient paths: a CUDA graph captures only work
that stays on the card, so the forward under grad, the loss and
torch.autograd.grad are recorded op by op (test_torch_graph.OpRecord) on
the CPU, and no operation may read a value back to the host, make a shape
from data or copy host data to the device; the same gradient at two param
values must run the same operations on the same shapes. Cases: render_fn
on the Cornell box at 16^2, depth 3, 2 spp; the every-kind scene on the
wide route and forced onto the sweep; the sharded split, the partial film
of a one-rank world and autograd.grad of it with grad_outputs; each in the
default mode and under deterministic algorithms.

Then the routes (graph.capture_after: graph=True off the card raises,
graph=None on the CPU runs eagerly, fit chooses from its steps, the train
step captures at call CAPTURE_AFTER + 1), the gradient key, and fake
captures (a "replay" re-runs the captured function on its static inputs)
that show the params copied into the static leaves at each call and the
results equal to eager value_and_grad's. The graphed gradients run only on
the card (tests/test_torch_cuda.py, chip_smoke.py phases 11 and 12).
JAX-free.
"""
import contextlib

import pytest
import torch
import torch.distributed as dist

from jet_pbrt_tpu_torch.diff import params as P
from jet_pbrt_tpu_torch.models import graph as G
from jet_pbrt_tpu_torch.models.render import render_fn, setup
from jet_pbrt_tpu_torch.parallel import train as T
from jet_pbrt_tpu_torch.parallel.mesh import make_mesh
from jet_pbrt_tpu_torch.parallel.render import build_sharded_render
from jet_pbrt_tpu_torch.scene import scenes as tscenes

from test_torch_graph import FORBIDDEN, OpRecord, _every_kind, \
    unrecorded_traversals  # noqa: F401 (a fixture)

torch.set_num_threads(2)

RES, DEPTH, SPP = 16, 3, 2
FIELDS = ("mat_c0", "mat_s0", "light_c")
CUDA = torch.device("cuda")


@contextlib.contextmanager
def _deterministic(on: bool):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.fixture
def one_rank(tmp_path):
    """A (1, 1) mesh over a gloo world of this process alone."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _scene(case, monkeypatch):
    if case == "cornell":
        return tscenes.cornell_box()
    return _every_kind(case == "sweep", monkeypatch)


def _record_grad(case, scale, holder, monkeypatch, mesh=None):
    """The ops of one gradient of the case's loss in FIELDS, the params
    scaled by `scale`."""
    scene = _scene(case, monkeypatch)
    fn, pack = render_fn(scene, RES, RES, SPP, seed=1, max_depth=DEPTH,
                         device="cpu")
    leaves = tuple((getattr(pack, k) * scale).detach().requires_grad_(True)
                   for k in FIELDS)
    params = P.with_params(pack, dict(zip(FIELDS, leaves)))
    target = torch.full((RES * RES, 3), 0.25)
    mode = holder["mode"] = OpRecord()
    if mesh is None:
        with mode:
            val = torch.mean((fn(params) - target.view(RES, RES, 3)) ** 2)
            torch.autograd.grad(val, leaves, allow_unused=True)
        return mode.ops
    render = build_sharded_render(scene.meta, mesh, RES, RES, SPP, seed=1,
                                  max_depth=DEPTH, device="cpu")
    cam = setup(scene, RES, RES, "cpu")[2]
    with mode:
        partial = render.partial(params, cam)
    grad_img = (partial.detach() / SPP - target) * (2.0 / target.numel())
    with mode:
        torch.autograd.grad(partial, leaves, grad_outputs=grad_img,
                            allow_unused=True)
    return mode.ops


def _assert_capture_safe(record):
    first = record(1.0)
    bad = sorted({name for name, _, masked in first
                  if masked or name in FORBIDDEN or "unique" in name})
    assert not bad, bad
    assert any(name == "aten::index_add_" or name == "aten::index_add"
               for name, _, _ in first), "no backward recorded"
    assert first == record(0.7)


@pytest.mark.parametrize("mode", ["default", "deterministic"])
@pytest.mark.parametrize("case", ["cornell", "wide", "sweep"])
def test_gradient_is_capture_safe(case, mode, unrecorded_traversals,
                                  monkeypatch):
    with _deterministic(mode == "deterministic"):
        _assert_capture_safe(lambda s: _record_grad(
            case, s, unrecorded_traversals, monkeypatch))


@pytest.mark.parametrize("mode", ["default", "deterministic"])
def test_sharded_gradient_is_capture_safe(mode, one_rank,
                                          unrecorded_traversals, monkeypatch):
    """The train step's two graphs: the partial film under grad, then its
    backward with grad_outputs (the collectives between them run
    eagerly, outside both)."""
    with _deterministic(mode == "deterministic"):
        _assert_capture_safe(lambda s: _record_grad(
            "wide", s, unrecorded_traversals, monkeypatch, one_rank))


def test_capture_route_follows_graph_and_device():
    """graph=False, and None off the card, run eagerly (None); graph=True
    captures at the first call and raises off the card; None on the card
    captures after CAPTURE_AFTER eager calls, or at once where the caller
    will make more than CAPTURE_AFTER calls, and stays eager where it will
    make no more."""
    cpu, after = torch.device("cpu"), G.CAPTURE_AFTER
    assert [G.capture_after(g, cpu) for g in (None, False)] == [None, None]
    for calls in (None, 1, 100):
        with pytest.raises(ValueError, match="graph=True"):
            G.capture_after(True, cpu, calls)
    assert [G.capture_after(g, CUDA) for g in (None, True, False)] == [
        after, 0, None]
    assert [G.capture_after(None, "cuda", n) for n in (1, after, after + 1)] \
        == [None, None, 0]
    assert [G.capture_after(g, CUDA, 1) for g in (True, False)] == [0, None]


def _cornell_loss():
    """(fn, pack, target): the Lambertian Cornell box at 8^2, 2 spp, depth
    2, its albedo set to mat_c0 * 0.5 + 0.1, its own frame the target."""
    fn, pack = render_fn(tscenes.cornell_box(lambert_only=True), 8, 8, SPP,
                         seed=2, max_depth=2, device="cpu")
    with torch.no_grad():
        target = fn(pack)
    return fn, pack._replace(mat_c0=pack.mat_c0 * 0.5 + 0.1), target


def test_graph_true_off_the_card_raises():
    fn, pack, target = _cornell_loss()
    f = P.loss_fn(fn, pack, target)
    with pytest.raises(ValueError, match="on the card"):
        P.fit(fn, pack, target, steps=1, graph=True)
    with pytest.raises(ValueError, match="on the card"):
        P.compile_value_and_grad(f)(P.get_params(pack, FIELDS))
    with pytest.raises(ValueError, match="on the card"):
        T.build_train_step(tscenes.cornell_box(), None, 8, 8, 2,
                           device="cpu", graph=True)


def test_fit_on_the_cpu_runs_eagerly(monkeypatch):
    """graph=None on the CPU is the eager fit, equal bit for bit to
    graph=False, and never compiles."""
    monkeypatch.setattr(P, "compile_value_and_grad",
                        lambda f: pytest.fail("compiled on the CPU"))
    fn, pack, target = _cornell_loss()
    kw = dict(fields=("mat_c0", "light_c"), steps=G.CAPTURE_AFTER + 2,
              lr=4.0)
    a, la = P.fit(fn, pack, target, **kw)
    b, lb = P.fit(fn, pack, target, graph=False, **kw)
    assert la == lb and torch.equal(a["mat_c0"], b["mat_c0"])
    assert all(isinstance(x, float) for x in la) and la[-1] < la[0]


class _FakeCall:
    """A stand-in for graph.CapturedCall: static inputs as the real one
    makes them; its "replay" copies the caller's values in and re-runs fn
    on them."""
    made = []

    def __init__(self, fn, inputs, grad=False):
        self.fn, self.grad = fn, grad
        self.inputs = G._clone(inputs)
        with torch.autograd.set_grad_enabled(grad):
            self.warmup_outputs = fn(*self.inputs)
        self.seen = []
        _FakeCall.made.append(self)

    def __call__(self, inputs):
        G._copy_in(self.inputs, inputs)
        self.seen.append(tuple(x.detach().clone() for x in self.inputs))
        with torch.autograd.set_grad_enabled(self.grad):
            return self.fn(*self.inputs)

    def release(self):
        self.inputs = None


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """The routes take the CPU for the card; captures are _FakeCall."""
    route = G.capture_after
    monkeypatch.setattr(G, "capture_after", lambda graph, device, calls=None:
                        route(graph, CUDA, calls))
    monkeypatch.setattr(G, "CapturedCall", _FakeCall)
    _FakeCall.made = []
    G.clear()
    yield
    G.clear()


def test_compiled_value_and_grad_copies_params_into_its_leaves(
        as_if_on_the_card):
    """One capture, then replays: each call's params are copied into the
    capture's static leaves (which require grad), and each result equals
    eager value_and_grad's bit for bit; release() drops the entry."""
    fn, pack, target = _cornell_loss()
    f = P.loss_fn(fn, pack, target)
    vg = P.compile_value_and_grad(f)
    base = P.get_params(pack, FIELDS)
    for scale in (1.0, 0.5, 0.8):
        p = {k: v * scale for k, v in base.items()}
        val, g = vg(p)
        want, gw = P.value_and_grad(f, p)
        assert val.dim() == 0 and torch.equal(val, want)
        assert all(torch.equal(g[k], gw[k]) for k in FIELDS)
    (made,) = _FakeCall.made
    assert made.grad and all(x.requires_grad and x.is_leaf
                             for x in made.inputs)
    assert [[float(x.sum()) for x in s] for s in made.seen] == [
        [float((base[k] * s).sum()) for k in FIELDS] for s in (0.5, 0.8)]
    assert len(G.GRAD_CACHE.entries) == 1
    vg.release()
    assert not G.GRAD_CACHE.entries and not G.GRAD_CACHE.eager_calls


def test_fit_chooses_its_route_from_steps(as_if_on_the_card):
    """On the card a fit of more than CAPTURE_AFTER steps captures at its
    first step and replays the rest (its losses those of the eager fit); a
    shorter one runs eagerly; the fit releases its capture."""
    fn, pack, target = _cornell_loss()
    kw = dict(fields=("mat_c0", "light_c"), lr=4.0)
    for steps, captures in ((G.CAPTURE_AFTER, 0), (G.CAPTURE_AFTER + 1, 1)):
        _FakeCall.made = []
        params, losses = P.fit(fn, pack, target, steps=steps, **kw)
        eager, want = P.fit(fn, pack, target, steps=steps, graph=False, **kw)
        assert len(_FakeCall.made) == captures
        assert losses == want and all(torch.equal(params[k], eager[k])
                                      for k in eager)
        assert not G.GRAD_CACHE.entries
    assert len(_FakeCall.made[0].seen) == G.CAPTURE_AFTER


def test_gradient_key_follows_shapes_and_determinism():
    """Another shape of one field, another field set or deterministic
    algorithms each give another key; other values of the same shapes
    share one; another owner never shares."""
    owner = object()
    base = {"mat_c0": torch.ones(4, 3), "light_c": torch.ones(2, 3)}
    key = G.grad_key(owner, base)
    assert G.grad_key(owner, {k: v * 2 for k, v in base.items()}) == key
    others = [G.grad_key(owner, base | {"mat_c0": torch.ones(5, 3)}),
              G.grad_key(owner, {"mat_c0": base["mat_c0"]}),
              G.grad_key(owner, base | {"light_c": torch.ones(
                  2, 3, dtype=torch.float64)}),
              G.grad_key(object(), base)]
    with _deterministic(True):
        others.append(G.grad_key(owner, base))
    assert len({key, *others}) == len(others) + 1


class _FakePair:
    """A stand-in for graph.CapturedForwardBackward: its "replays" re-run
    the forward on the static leaves, then autograd.grad of that output."""
    made = []

    def __init__(self, forward, inputs):
        self.fn, self.inputs = forward, G._clone(inputs)
        self.launches, self.pool_bytes = {"forward": {}, "backward": {}}, 0
        self.calls = 0
        _FakePair.made.append(self)

    def forward(self, inputs):
        G._copy_in(self.inputs, inputs)
        with torch.enable_grad():
            self.out = self.fn(*self.inputs)
        self.calls += 1
        return self.out.detach()

    def backward(self, grad_outputs):
        grads = torch.autograd.grad(self.out, self.inputs, grad_outputs,
                                    allow_unused=True)
        return tuple(torch.zeros_like(v) if g is None else g
                     for v, g in zip(self.inputs, grads))

    def release(self):
        pass


def test_train_step_captures_after_its_eager_calls(one_rank, monkeypatch):
    """On the card the step's first CAPTURE_AFTER calls run eagerly and
    the next captures (fake graphs here), the later ones replaying; every
    step's loss and params equal the eager step's bit for bit; a 0-d loss."""
    route = G.capture_after
    monkeypatch.setattr(G, "capture_after", lambda graph, device, calls=None:
                        route(graph, CUDA, calls))
    monkeypatch.setattr(G, "CapturedForwardBackward", _FakePair)
    _FakePair.made = []
    G.clear()
    scene = tscenes.cornell_box()
    kw = dict(fields=("mat_c0", "light_c"), lr=0.5, max_depth=DEPTH,
              device="cpu")
    steps = {g: T.build_train_step(scene, one_rank, 8, 8, SPP, graph=g, **kw)
             for g in (None, False)}
    target = steps[False][2].frame(scene.pack, steps[False][3])
    start = steps[False][1]()
    start["mat_c0"] = start["mat_c0"] * 0.5 + 0.1
    params = {g: dict(start) for g in steps}
    for call in range(G.CAPTURE_AFTER + 3):
        got = {}
        for g, (step, *_) in steps.items():
            params[g], got[g] = step(params[g], target)
        assert len(_FakePair.made) == (call >= G.CAPTURE_AFTER)
        assert got[None].dim() == 0 and torch.equal(got[None], got[False])
        assert all(torch.equal(params[None][k], params[False][k])
                   for k in start)
    assert _FakePair.made[0].calls == 3
    G.clear()
