"""The binding between the port's Python and its hand-written CUDA kernels.

Every kernel wrapper (ops/rays.py, wave.py, brute.py, rng.py, shade.py,
wide_bvh.py, sweep_bvh.py and the probes of scripts/) reaches its kernel
through this module, which holds each part of that binding once:

    Library      a library of csrc/: its name and sources, its C functions'
                 argument types (every one returns a C int) and the
                 values its layout exports (`*_args_size`,
                 `shade_table_width`) must equal; loaded through
                 utils/cuda_build.load_library.
    route        the route rule: CPU tensors take the plain version, CUDA
                 tensors the kernel once no input requires grad
                 (`no_grad_inputs`), any other device raises.
    check        a tensor's dtype, shape, contiguity and device.
    launch       a C function called under the device guard on the
                 current stream; a non-zero return raises, and the launch
                 is counted on its wrapper's `.launches`.
    copy_out     the plain version's outputs written into a caller's `out`.
    substitute   another build of a library in its place, for a harness
                 that measures or checks one build against another.

The launch counters, in one registry. Each wrapper (decorated with
`wrapper`) counts in its `.launches` the launches of its CUDA kernel, one
where it launches it and nowhere else (its plain version counts nothing),
and registers the device function that one of its launches runs exactly
once. A launch that no wrapper makes itself, a CUDA graph's replay of
captured launches (models/graph.py), is counted on the same counters:
`kernel_nodes` counts the graph's kernel nodes by device function and
`add` adds them per replay. A counter is read through its wrapper's
module, so a function set in the wrapper's place (a recorder that wraps
it) is the one counted; a function there with no `.launches` counts
nothing and reads None.
"""
from __future__ import annotations

import contextlib
import ctypes
import sys

import torch

from ..utils.cuda_build import load_library

# a C function's argument types: an int, a pointer (or a stream), a uint32
INT, PTR, U32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32
# device function name -> (module name, wrapper name)
REGISTRY: dict = {}
# library name -> Library
LIBRARIES: dict = {}


class Library:
    """A library of csrc/: `functions` {C function: its argument types},
    each returning a C int, and `layouts` {C function of no argument: the
    ctypes Structure whose size it returns, or the int it returns}."""

    def __init__(self, name: str, sources: list, functions: dict,
                 layouts: dict | None = None):
        self.name, self.sources = name, list(sources)
        self.functions, self.layouts = functions, layouts or {}
        self._in_place = None
        LIBRARIES[name] = self

    def declare(self, lib) -> None:
        """Sets the argument and return types of lib's functions and raises
        where one of its layouts differs from the wrapper's."""
        for fn, argtypes in self.functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        for fn, want in self.layouts.items():
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
            size = want if isinstance(want, int) else ctypes.sizeof(want)
            got = getattr(lib, fn)()
            if got != size:
                raise RuntimeError(
                    f"{self.name}: the build and its wrapper disagree on "
                    f"{getattr(want, '__name__', 'a width')}: {fn}() gives "
                    f"{got}, the wrapper {size}")

    def build(self, sources=None, name: str | None = None) -> ctypes.CDLL:
        """This library's C functions compiled from `sources` (files of
        csrc/ or absolute paths; default its own) under `name` (default
        its own), loaded and declared."""
        return load_library(name or self.name, list(sources or self.sources),
                            self.declare)

    def load(self) -> ctypes.CDLL:
        """The build the wrappers launch: the one `substitute` put in its
        place, else its own."""
        return self.build() if self._in_place is None else self._in_place


@contextlib.contextmanager
def substitute(library: Library, lib: ctypes.CDLL):
    """While open, `library`'s wrappers launch through `lib`, another build
    with its C functions (`Library.build`)."""
    saved, library._in_place = library._in_place, lib
    try:
        yield lib
    finally:
        library._in_place = saved


def wrapper(kernel: str):
    """Decorates a kernel wrapper: it counts one launch per launch of device
    function `kernel` (its name in the source, a template's without
    arguments) in its `.launches`."""
    def register(fn):
        fn.launches = 0
        REGISTRY[kernel] = (fn.__module__, fn.__name__)
        return fn
    return register


def no_grad_inputs(name: str, **inputs) -> None:
    """Raise where a kernel's input requires grad: its launch reads raw
    pointers and has no backward, so the gradient would be lost without a
    word. The integrators detach every ray they cast. None inputs are
    skipped."""
    bad = [k for k, x in inputs.items()
           if x is not None and x.requires_grad]
    if bad:
        raise ValueError(f"{name}: {', '.join(bad)} require grad, and the "
                         "kernel has no backward; detach them")


def route(name: str, dev, **inputs) -> bool:
    """True where wrapper `name` launches its kernel (a CUDA device, no
    input requiring grad), False on the CPU (the plain version); raises on
    another device and, on the card, where an input requires grad."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {name} route for device {dev}")
    no_grad_inputs(name, **inputs)
    return True


def check(name: str, x, dtype, shape, dev) -> None:
    """Raise unless x is a contiguous `dtype` tensor of `shape` (None: any)
    on dev."""
    if x.dtype != dtype or not x.is_contiguous() or x.device != dev \
            or (shape is not None and tuple(x.shape) != tuple(shape)):
        want = "" if shape is None else f" {list(shape)}"
        raise ValueError(f"{name}: expected a contiguous {dtype}{want} "
                         f"tensor on {dev}, got {x.dtype} {list(x.shape)} on "
                         f"{x.device}"
                         + ("" if x.is_contiguous() else ", not contiguous"))


def check_lanes(n: int) -> None:
    """Raise unless n lanes fit a kernel's int32 lane index."""
    if n >= 2 ** 31:
        raise ValueError("the kernels' int32 lane index holds fewer than "
                         "2^31 lanes")


def ptr(x):
    """A tensor's address for a C argument: None for None or no element."""
    return None if x is None or not x.numel() else x.data_ptr()


def launch(fn, dev, call, *args, after=(), sized: bool = False) -> int:
    """call(*args, stream, *after), a C function of a wrapper fn's library,
    under dev's device guard with the current stream of dev. It returns 0
    or a CUDA error (where sized, the launch's width or minus a CUDA
    error), on which this raises. The launch is then counted on
    fn.launches. Returns what call returned."""
    with torch.cuda.device(dev):
        got = call(*args, torch.cuda.current_stream(dev).cuda_stream, *after)
    err = -min(got, 0) if sized else got
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    fn.launches += 1
    return got


def copy_out(got, out):
    """The plain version's outputs got (a tensor, or a tuple of tensors)
    written into out (the same, or None: got is returned)."""
    if out is None:
        return got
    if torch.is_tensor(got):
        return out.copy_(got)
    return type(got)(*(y.copy_(x) for x, y in zip(got, out)))


# --------------------------------------------------------------------------
# the launch counters
# --------------------------------------------------------------------------

def _wrapper(kernel: str):
    module, name = REGISTRY[kernel]
    return getattr(sys.modules[module], name)


def counts() -> dict:
    """{kernel: its wrapper's `.launches`, or None where the function in
    the wrapper's place keeps no count}."""
    return {k: getattr(_wrapper(k), "launches", None) for k in REGISTRY}


def add(delta: dict) -> None:
    """Adds delta[kernel] to each counting wrapper's `.launches`."""
    for k, n in delta.items():
        fn = _wrapper(k)
        if n and hasattr(fn, "launches"):
            fn.launches += n


def counted_apart(fn):
    """(fn(), {kernel: launches its wrappers counted during fn}); the
    counts are set back to what they were before fn, also when fn
    raises."""
    before = counts()
    try:
        out = fn()
        after = counts()
        return out, {k: (after[k] - before[k] if before[k] is not None
                         and after[k] is not None else None)
                     for k in before}
    finally:
        now = counts()
        add({k: before[k] - now[k] for k in before
             if before[k] is not None and now[k] is not None})


def is_function(name: str, kernel: str) -> bool:
    """Whether device function `name`, as the CUDA driver API names it
    (the source name of an extern "C" function, else its Itanium-mangled
    name), is `kernel` (an unqualified name, templates included)."""
    return name == kernel or (name.startswith("_Z")
                              and f"{len(kernel)}{kernel}" in name)


def kernel_nodes(names) -> dict:
    """{kernel: how many of the device function names `names` are it}, for
    every registered kernel."""
    names = list(names)
    return {k: sum(is_function(n, k) for n in names) for k in REGISTRY}
