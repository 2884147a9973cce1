"""The kernel wrappers' launch counters, in one registry.

Each kernel wrapper counts in its `.launches` the launches of its CUDA
kernel, one where it launches it and nowhere else (its plain version counts
nothing), and registers here the device function that one of its launches
runs exactly once. A launch that no wrapper makes itself, a CUDA graph's
replay of captured launches (models/graph.py), is counted on the same
counters: `kernel_nodes` counts the graph's kernel nodes by device function
and `add` adds them per replay. A counter is read through its wrapper's
module, so a function set in the wrapper's place (a recorder that wraps it)
is the one counted; a function there with no `.launches` counts nothing
and reads None.
"""
from __future__ import annotations

import sys

# device function name -> (module name, wrapper name)
REGISTRY: dict = {}


def register(module: str, wrapper: str, kernel: str) -> None:
    """`module.wrapper` counts one launch per launch of device function
    `kernel` (its name in the source, a template's without arguments)."""
    REGISTRY[kernel] = (module, wrapper)


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
