"""Logging and wall-clock performance counters.

PyTorch-side counterpart of jet_pbrt_tpu/utils/log.py: log_print
(reference: src/pbrt.cc:13-20) and FPerformanceCounter (reference:
src/pbrt.h:128-148) on Python's logging and time, under the port's own
logger name.
"""
from __future__ import annotations

import logging
import time

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
