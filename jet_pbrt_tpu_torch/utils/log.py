"""Logging, wall-clock performance counters and profiler spans.

PyTorch-side counterpart of jet_pbrt_tpu/utils/log.py: log_print
(reference: src/pbrt.cc:13-20) and FPerformanceCounter (reference:
src/pbrt.h:128-148) on Python's logging and time, under the port's own
logger name. `span` names a stretch of the program's host work in a
torch.profiler trace.
"""
from __future__ import annotations

import contextlib
import logging
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

logger = logging.getLogger("jet_pbrt_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[jet_pbrt_tpu_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def log_print(msg: str) -> None:
    logger.info(msg)


class PerfCounter:
    """start/stop microsecond timer (reference: src/pbrt.h:128-148)."""

    def __init__(self):
        self._t0 = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def stop_s(self) -> float:
        return time.perf_counter() - self._t0


# the context `span` returns while no profiler records: entered and left
# any number of times, nested or not, it does nothing
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming the host work inside it `name` in a torch.profiler
    trace: the profiler's own record_function range, on the clock of the
    device events it records, while a profiler records; else a shared
    context that does nothing. Entering a record_function costs some
    microseconds of host time even with no profiler running, the flag
    check a fraction of one. A span does only host work: no sync, no
    device allocation, no launch."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN
