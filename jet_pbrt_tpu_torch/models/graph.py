"""The compiled wave and the compiled gradients: CUDA graphs, replayed.

PyTorch counterpart of the reference package's `jax.jit(wave)`
(jet_pbrt_tpu/models/render.py:25-54, `_wave_fn`) and, through
diff/params.py and parallel/train.py, of its `jax.jit(jax.value_and_grad)`
(jet_pbrt_tpu/diff/params.py:55) and jitted train step
(jet_pbrt_tpu/parallel/train.py:37). The eager wave
enqueues some thousands of small operations one by one, and their host
dispatch, not the card, sets a frame's pace. Here a wave is captured once
per key into a `torch.cuda.CUDAGraph`, and every later call replays that
graph: one launch of the whole wave.

- Key: what `jax.jit` treats as static and what the wave bakes into a
  launch as a Python scalar: the wave function's arguments (scene meta,
  width, depth, integrator, mis, nee, sampler, spp, seed, sort_rays,
  with_stats), the shapes and dtypes of every input tensor, the inputs'
  non-tensor fields (`WideTables.blas_root` and `depth`,
  `SweepTables.n_groups` and `n_inst`), the lane count and the device.
- When to capture: a capture costs about four eager waves of host time
  (the warm-up wave, the capture's own dispatch, the graph's instantiation
  and its memory pool), which a key repays only if it is replayed. A key
  runs op by op for its first `capture_after` calls and is captured at the
  next; render() on the card takes CAPTURE_AFTER, so a one-shot frame of a
  few waves (a CLI render) pays no capture, and graph=True captures at the
  first call.
- Inputs: the graph reads static buffers, copies of the pack, the camera
  and the [N] sample and pixel ids made at capture; each call copies the
  caller's current values into them before it replays, so a wave always
  sees the pack it was given.
- Outputs: the graph's own tensors (colours and, with_stats, the counts).
  The next replay of the same entry overwrites them: use or clone them
  first.
- Launch counts: a replay runs no kernel wrapper, so it counts on the
  wrappers' counters (ops/kernels.py) what its graph holds: the graph's
  kernel nodes, read by device function through the CUDA driver API
  once at capture. The launches the wrappers counted while capturing
  (where nothing ran) are taken back, and must equal the graph's nodes,
  or the capture raises.
- Capture: a warm-up wave on a side stream first (it runs, counts its
  launches and gives the capturing call its outputs), which fixes the
  kernel libraries' one-time host work (the nvcc build and load, the wide
  walk's cached occupancy grid) before capture starts; then the capture.
  A failure raises: nothing falls back to the eager wave.
- Gradients: a graph has no backward of its own, so a gradient is
  captured whole, its forward and `torch.autograd.grad` recorded together
  under autograd (CapturedCall with grad=True, after GRAD_WARMUPS warm-up
  calls of both), or, where a collective sits between them, as two graphs
  sharing one pool (CapturedForwardBackward, the pattern of
  `torch.cuda.make_graphed_callables`). The forward wave's graph stays a
  no-grad graph: compile_wave refuses an input that requires grad.
- Memory: each entry's graph holds a private pool about the eager call's
  peak (a gradient's: its tape, about 5.4 GB per 2^20-lane depth-5 wave);
  the caches keep MAX_GRAPHS waves and MAX_GRAD_GRAPHS gradients, least
  recently used out first, and `clear()` drops them all.
- Spans: under torch.profiler each step of a call is a span
  (utils/log.py::span): "graph.key" (a wave's key; diff/params.py draws
  the gradient's), "graph.eager" (a key's call op by op before its
  capture), "graph.capture" (a new entry's warm-up and capture), and per
  replay "graph.copy_in" (the caller's values into the static buffers),
  "graph.launch" (`replay()`) and "graph.count" (`kernels.add`).
"""
from __future__ import annotations

import collections
import ctypes
import time

import torch

from ..ops import kernels
from ..utils.log import span

# a frame captures at most two shapes (a short last pixel range, a short
# last sample group); four also keep a second frame's
MAX_GRAPHS = 4
# the eager calls of a key before its capture where render() chooses
CAPTURE_AFTER = 4
# the keys whose eager calls are counted (the most recent)
MAX_COUNTED = 64
# gradient graphs kept: each pool holds a tape (about 5.4 GB per 2^20-lane
# depth-5 wave)
MAX_GRAD_GRAPHS = 2
# warm-up calls before a capture with autograd on, forward and backward
# together (torch.cuda.make_graphed_callables runs 3)
GRAD_WARMUPS = 3


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the CUDA driver API (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_KERNEL_NODE = 0    # CU_GRAPH_NODE_TYPE_KERNEL


def _cu_call(lib, name: str, *args) -> None:
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUresult {rc}")


def kernel_names(graph: torch.cuda.CUDAGraph) -> list:
    """The device function of every kernel node of a captured graph (made
    with keep_graph=True), by the CUDA driver API: the source name of
    an extern "C" function, else its mangled name."""
    lib = ctypes.CDLL("libcuda.so.1")
    get_params = ("cuGraphKernelNodeGetParams_v2"
                  if hasattr(lib, "cuGraphKernelNodeGetParams_v2")
                  else "cuGraphKernelNodeGetParams")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu_call(lib, "cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu_call(lib, "cuGraphGetNodes", g, nodes, ctypes.byref(n))
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    names = []
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        _cu_call(lib, "cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        params.func = params.kern = None
        _cu_call(lib, get_params, node, ctypes.byref(params))
        if params.func:
            _cu_call(lib, "cuFuncGetName", ctypes.byref(name),
                         ctypes.c_void_p(params.func))
        else:
            _cu_call(lib, "cuKernelGetName", ctypes.byref(name),
                         ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return names


def replay_launches(counted: dict, nodes: dict) -> dict:
    """The launches one replay counts: the graph's kernel nodes by
    registered kernel (`nodes`), held against what the wrappers counted
    while capturing (`counted`; None where the function in a wrapper's
    place keeps no count, which is not held). Raises where they differ."""
    wrong = {k: (counted[k], n) for k, n in nodes.items()
             if counted.get(k) is not None and counted[k] != n}
    if wrong:
        raise RuntimeError("the captured wave's kernel nodes differ from the "
                           "launches its wrappers counted while capturing "
                           "({kernel: (counted, nodes)}): " + str(wrong))
    return nodes


def signature(x):
    """The static part of a (nested) input: each tensor's shape and dtype,
    every other leaf (ints, None) as it is, tuples and NamedTuples kept
    with their type."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, tuple):
        return (type(x).__name__,) + tuple(signature(v) for v in x)
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)


def _clone(x):
    """Static copies of a (nested) input, each tensor a new leaf that
    requires grad where the input's tensor does."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone().requires_grad_(x.requires_grad)
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)._make(vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _copy_in(static, inputs) -> None:
    """The caller's values into a capture's static inputs (leaves that
    may require grad: copied outside autograd)."""
    with torch.no_grad():
        for s, x in zip(_tensors(static), _tensors(inputs)):
            s.copy_(x)


def _capture(fn, stream, pool=None):
    """fn() captured on `stream` into a new CUDA graph whose memory pool is
    `pool` (a torch.cuda.graph_pool_handle() another graph shares; None:
    its own): (graph, fn's outputs, the launches one replay counts, held
    against what the wrappers counted while capturing). Raises where the
    capture fails."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture():
        # thread_local: a collective's watchdog thread may query its events
        # while this thread captures; autograd's device thread enqueues the
        # backward on the forward's stream, which is this capturing one
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            return fn()

    outputs, counted = kernels.counted_apart(capture)
    graph.instantiate()
    return graph, outputs, replay_launches(
        counted, kernels.kernel_nodes(kernel_names(graph)))


def _warm_up(fn, dev, n: int):
    """fn() n times on a new side stream, which the captures then use (it
    fixes the kernel libraries' one-time host work, the nvcc build and
    load, the wide walk's occupancy grid, and autograd's lazy state, before
    a capture starts); returns (the side stream, the last call's outputs,
    the seconds taken)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(n):
            out = fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    return side, out, time.perf_counter() - t0


def _device(inputs) -> torch.device:
    return next(_tensors(inputs)).device


class CapturedCall:
    """fn(*inputs) captured as one CUDA graph: its static inputs and
    outputs, the launches one replay counts (its graph's kernel nodes),
    the seconds of the warm-up and of the capture, and the bytes its
    graph's memory pool reserved. `warmup_outputs` are the last warm-up
    call's, the capturing call's result.

    grad=False (a wave): the capture runs under torch.no_grad() after one
    warm-up call. grad=True: autograd is on, so fn may record its forward
    and torch.autograd.grad of it together; the static inputs that stand
    for tensors that require grad are leaves that require grad, and
    GRAD_WARMUPS warm-up calls first run forward and backward together, as
    torch.cuda.make_graphed_callables does. The pool then holds fn's tape
    at its peak, not only its outputs."""

    def __init__(self, fn, inputs, grad: bool = False):
        dev = _device(inputs)
        with span("graph.capture"), torch.cuda.device(dev), \
                torch.autograd.set_grad_enabled(grad):
            self.inputs = _clone(inputs)
            side, self.warmup_outputs, self.warmup_s = _warm_up(
                lambda: fn(*self.inputs), dev, GRAD_WARMUPS if grad else 1)
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            self.graph, self.outputs, self.launches = _capture(
                lambda: fn(*self.inputs), side)
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def __call__(self, inputs):
        with span("graph.copy_in"):
            _copy_in(self.inputs, inputs)
        with span("graph.launch"):
            self.graph.replay()
        with span("graph.count"):
            kernels.add(self.launches)
        return self.outputs

    def release(self) -> None:
        self.graph.reset()
        self.inputs = self.outputs = self.warmup_outputs = None


class CapturedForwardBackward:
    """forward(*inputs) -> one tensor, and its vector-Jacobian product in
    the inputs that require grad, captured as two CUDA graphs that share
    one memory pool (the pattern of torch.cuda.make_graphed_callables):
    the forward graph leaves its tape in the pool and the backward graph
    reads it, so that what cannot be captured (a collective) runs eagerly
    between them. `forward(inputs)` replays the first and returns its
    output (detached); `backward(grad_outputs)` copies the output's
    gradient in, replays the second and returns the inputs' gradients,
    zeros where forward does not depend on one. Replays alternate,
    forward then backward: the backward's transients reuse the tape's
    memory, so each backward needs the forward just before it, and one
    without raises. The outputs are the graphs' own tensors, overwritten
    by the next replay. Warm-up and capture as CapturedCall's with
    grad=True; `launches` are the forward's and the backward's per
    replay."""

    def __init__(self, forward, inputs):
        dev = _device(inputs)
        with span("graph.capture"), torch.cuda.device(dev), \
                torch.enable_grad():
            self.inputs = _clone(inputs)
            leaves = [x for x in _tensors(self.inputs) if x.requires_grad]

            def vjp(out, grad_out):
                grads = torch.autograd.grad(out, leaves, grad_out,
                                            allow_unused=True)
                return tuple(torch.zeros_like(v) if g is None else g
                             for v, g in zip(leaves, grads))

            def both():
                out = forward(*self.inputs)
                vjp(out, torch.ones_like(out))
                return out.detach()

            side, out, self.warmup_s = _warm_up(both, dev, GRAD_WARMUPS)
            t0 = time.perf_counter()
            self.grad_outputs = torch.zeros_like(out)
            del out
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            pool = torch.cuda.graph_pool_handle()
            self.forward_graph, self.outputs, fwd = _capture(
                lambda: forward(*self.inputs), side, pool)
            self.backward_graph, self.grads, bwd = _capture(
                lambda: vjp(self.outputs, self.grad_outputs), side, pool)
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        self.launches = {"forward": fwd, "backward": bwd}
        self._taped = False

    def forward(self, inputs) -> torch.Tensor:
        with span("graph.copy_in"):
            _copy_in(self.inputs, inputs)
        with span("graph.launch"):
            self.forward_graph.replay()
        with span("graph.count"):
            kernels.add(self.launches["forward"])
        self._taped = True
        return self.outputs.detach()

    def backward(self, grad_outputs: torch.Tensor) -> tuple:
        if not self._taped:
            raise RuntimeError("the backward graph replays after its forward "
                               "graph, once per forward")
        self._taped = False
        with span("graph.copy_in"):
            self.grad_outputs.copy_(grad_outputs)
        with span("graph.launch"):
            self.backward_graph.replay()
        with span("graph.count"):
            kernels.add(self.launches["backward"])
        return self.grads

    def release(self) -> None:
        self.forward_graph.reset()
        self.backward_graph.reset()
        self.inputs = self.outputs = self.grads = self.grad_outputs = None


class GraphCache:
    """Captured calls by key, at most max_entries, the least recently used
    released first; and the eager calls of the MAX_COUNTED latest keys not
    captured. grad: calls run with autograd on (a gradient's forward and
    backward), else under torch.no_grad()."""

    def __init__(self, max_entries: int = MAX_GRAPHS, grad: bool = False):
        self.max_entries = max_entries
        self.grad = grad
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.eager_calls: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        """The captured call of key, or None."""
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        while len(self.entries) >= self.max_entries:
            self.entries.popitem(last=False)[1].release()
        self.eager_calls.pop(key, None)
        self.entries[key] = entry

    def count_eager(self, key) -> int:
        """How many eager calls of key came before this one, which it
        adds to."""
        done = self.eager_calls.pop(key, 0)
        self.eager_calls[key] = done + 1
        while len(self.eager_calls) > MAX_COUNTED:
            self.eager_calls.popitem(last=False)
        return done

    def run(self, key, fn, inputs, capture_after: int, capture=None):
        """fn(*inputs) for key: replayed where key is captured, op by op
        for key's first capture_after calls, else captured (capture(fn,
        inputs), default CapturedCall with this cache's grad; the
        capturing call returns the entry's warmup_outputs). A failed
        capture raises and leaves no entry."""
        entry = self.get(key)
        if entry is not None:
            return entry(inputs)
        if self.count_eager(key) < capture_after:
            with span("graph.eager"), \
                    torch.autograd.set_grad_enabled(self.grad):
                return fn(*inputs)
        entry = (capture(fn, inputs) if capture is not None
                 else CapturedCall(fn, inputs, self.grad))
        self.put(key, entry)
        out, entry.warmup_outputs = entry.warmup_outputs, None
        return out

    def drop(self, owner) -> None:
        """Releases the entries, and forgets the eager calls, of the keys
        whose first element is `owner`."""
        for k in [k for k in self.entries if k[0] is owner]:
            self.entries.pop(k).release()
        for k in [k for k in self.eager_calls if k[0] is owner]:
            del self.eager_calls[k]

    def clear(self) -> None:
        while self.entries:
            self.entries.popitem()[1].release()
        self.eager_calls.clear()


CACHE = GraphCache()
# the gradient graphs (diff/params.py, parallel/train.py), apart from the
# waves: each holds a tape
GRAD_CACHE = GraphCache(MAX_GRAD_GRAPHS, grad=True)


def clear() -> None:
    """Release every captured wave and gradient and their graphs' memory
    pools, and forget every key's eager calls."""
    CACHE.clear()
    GRAD_CACHE.clear()


def capture_after(graph: bool | None, device, calls: int | None = None):
    """The route a caller's graph= argument takes on `device`: None, run
    eagerly (graph=False, or None off the card), else the eager calls a
    key runs before its capture. graph=True captures at the first call and
    raises off the card. graph=None on the card captures after
    CAPTURE_AFTER eager calls, which a key repays only if it is called
    again; a caller that knows its number of calls (`calls`) captures at
    the first where they are more than CAPTURE_AFTER and else stays
    eager."""
    device = torch.device(device)
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True: a CUDA graph runs on the card, not on "
                         f"{device}")
    if graph is False or device.type != "cuda":
        return None
    if graph or calls is None:
        return 0 if graph else CAPTURE_AFTER
    return 0 if calls > CAPTURE_AFTER else None


def grad_key(owner, params: dict) -> tuple:
    """The gradient cache's key of a call of `owner` (the compiled function
    it belongs to) on params: their fields, signature and device, and
    whether deterministic algorithms are on (a graph replays the
    algorithms it captured)."""
    xs = tuple(params.values())
    return (owner, tuple(params), signature(xs), _device(xs),
            torch.are_deterministic_algorithms_enabled())


def wave_key(static: tuple, pack, cam, sample, pixel) -> tuple:
    """The cache key of a call: the wave function's arguments, the inputs'
    signature (lane count included) and the device."""
    return static + (signature((pack, cam, sample, pixel)), pixel.device)


def compile_wave(wave, static: tuple, capture_after: int = 0):
    """wave(pack, cam, sample, pixel) -> its outputs: for each key, its
    first `capture_after` calls run wave op by op, the next captures it
    (returning the warm-up wave's outputs) and every later call replays
    its CUDA graph. `static` holds the arguments wave was made with;
    sample and pixel are [N] tensors on the card. Raises off the card,
    where an input requires grad, and where the capture fails."""

    def compiled(pack, cam, sample, pixel):
        inputs = (pack, cam, sample, pixel)
        if not (torch.is_tensor(sample) and sample.shape == pixel.shape):
            raise ValueError("the compiled wave takes [N] tensors of sample "
                             "and pixel ids")
        if any(x.requires_grad for x in _tensors(inputs)):
            raise ValueError("the compiled wave has no backward: an input "
                             "requires grad (a gradient is captured whole, "
                             "diff.params.compile_value_and_grad)")
        if pixel.device.type != "cuda":
            raise ValueError(f"the compiled wave runs on the card, not "
                             f"{pixel.device}; use the eager wave (wave_fn)")
        with span("graph.key"):
            key = wave_key(static, *inputs)
        return CACHE.run(key, wave, inputs, capture_after)

    return compiled
