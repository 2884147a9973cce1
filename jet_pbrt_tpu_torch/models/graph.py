"""The compiled wave: one CUDA graph per wave shape, replayed.

PyTorch counterpart of the reference package's `jax.jit(wave)`
(jet_pbrt_tpu/models/render.py:25-54, `_wave_fn`). The eager wave
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
  wrappers' counters (ops/launches.py) what its graph holds: the graph's
  kernel nodes, read by device function through the CUDA driver API
  once at capture. The launches the wrappers counted while capturing
  (where nothing ran) are taken back, and must equal the graph's nodes,
  or the capture raises.
- Capture: a warm-up wave on a side stream first (it runs, counts its
  launches and gives the capturing call its outputs), which fixes the
  kernel libraries' one-time host work (the nvcc build and load, the wide
  walk's cached occupancy grid) before capture starts; then the capture.
  A failure raises: nothing falls back to the eager wave.
- Gradients: a graph has no backward. An input that requires grad raises;
  render_fn, diff/ and the train step keep the eager wave.
- Memory: each entry's graph holds a private pool about the eager wave's
  peak; the cache keeps MAX_GRAPHS entries, least recently used out
  first, and `clear()` drops them all.
"""
from __future__ import annotations

import collections
import ctypes
import time

import torch

from ..ops import launches

# a frame captures at most two shapes (a short last pixel range, a short
# last sample group); four also keep a second frame's
MAX_GRAPHS = 4
# the eager calls of a key before its capture where render() chooses
CAPTURE_AFTER = 4
# the keys whose eager calls are counted (the most recent)
MAX_COUNTED = 64


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
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)._make(vals) if hasattr(x, "_fields") else tuple(vals)
    return x


class CapturedWave:
    """One wave captured as a CUDA graph: its static inputs and outputs,
    its lanes, the launches one replay counts (its graph's kernel nodes),
    the seconds of the warm-up wave and of the capture, and the bytes its
    graph's memory pool reserved. `warmup_outputs` are the warm-up wave's,
    the capturing call's result."""

    def __init__(self, wave, inputs):
        dev = inputs[-1].device
        self.lanes = inputs[-1].shape[0]
        t0 = time.perf_counter()
        with torch.cuda.device(dev), torch.no_grad():
            self.inputs = _clone(inputs)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.warmup_outputs = wave(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)

            def capture():
                # thread_local: a collective's watchdog thread may query
                # its events while this thread captures
                with torch.cuda.graph(self.graph, stream=side,
                                      capture_error_mode="thread_local"):
                    return wave(*self.inputs)

            self.outputs, counted = launches.counted_apart(capture)
            self.graph.instantiate()
            self.launches = replay_launches(
                counted, launches.kernel_nodes(kernel_names(self.graph)))
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.warmup_s = t1 - t0
        self.capture_s = time.perf_counter() - t1

    def __call__(self, inputs):
        for static, x in zip(_tensors(self.inputs), _tensors(inputs)):
            static.copy_(x)
        self.graph.replay()
        launches.add(self.launches)
        return self.outputs

    def release(self) -> None:
        self.graph.reset()
        self.inputs = self.outputs = self.warmup_outputs = None


class GraphCache:
    """Captured waves by key, at most max_entries, the least recently used
    released first; and the eager calls of the MAX_COUNTED latest keys not
    captured."""

    def __init__(self, max_entries: int = MAX_GRAPHS):
        self.max_entries = max_entries
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.eager_calls: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        """The captured wave of key, or None."""
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

    def run(self, key, wave, inputs, capture_after: int,
            capture=CapturedWave):
        """wave(*inputs) for key: replayed where key is captured, op by op
        for key's first capture_after calls, else captured (capture(wave,
        inputs), its warm-up wave's outputs returned)."""
        entry = self.get(key)
        if entry is not None:
            return entry(inputs)
        if self.count_eager(key) < capture_after:
            with torch.no_grad():
                return wave(*inputs)
        entry = capture(wave, inputs)
        self.put(key, entry)
        out, entry.warmup_outputs = entry.warmup_outputs, None
        return out

    def clear(self) -> None:
        while self.entries:
            self.entries.popitem()[1].release()
        self.eager_calls.clear()


CACHE = GraphCache()


def clear() -> None:
    """Release every captured wave and its graph's memory pool, and forget
    every key's eager calls."""
    CACHE.clear()


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
                             "requires grad (render_fn and diff/ take the "
                             "eager wave)")
        if pixel.device.type != "cuda":
            raise ValueError(f"the compiled wave runs on the card, not "
                             f"{pixel.device}; use the eager wave (wave_fn)")
        return CACHE.run(wave_key(static, *inputs), wave, inputs,
                         capture_after)

    return compiled
