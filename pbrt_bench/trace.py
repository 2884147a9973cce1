"""Reading a torch.profiler trace into what the per-layer readers need:
the device's operations and the host's ranges in seconds on one clock,
the traced window, the union of busy intervals, and the breakdown."""
from __future__ import annotations

import time

import torch

from . import yardstick

TRIES = 3


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def busy_intervals(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class Trace:
    """One traced window. device: (name, start, end) of every device
    operation (kernels, memsets, copies) inside the window; host: (name,
    start, end) of the host ranges (record_function) inside it; window:
    (start, end), all in seconds."""

    def __init__(self, device, host, window, counts: dict, facts: dict):
        self.device = device
        self.host = host
        self.window = window
        self.counts = counts
        self.facts = facts

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device])

    def kernel_s(self, *names) -> float:
        """Device seconds of the operations whose name holds any of names."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names))

    def ranges(self, name):
        return [(s, e) for n, s, e in self.host if n == name]

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, labels: dict) -> dict:
        """The ten device operations that took most time (summed by name)
        and the ten longest idle gaps, each named by the innermost of the
        host ranges in `labels` (range name -> label) that holds it."""
        by_name = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = busy_intervals([(s, e) for _, s, e in self.device])
        edges = [self.window[0]] + [x for b in busy for x in b] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = [(s, e, labels[n]) for n, s, e in self.host if n in labels]

        def label(a, b):
            mid = 0.5 * (a + b)
            inner = [x for x in spans if x[0] <= mid <= x[1]]
            if not inner:
                return "other"
            return min(inner, key=lambda x: x[1] - x[0])[2]

        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:200], v] for n, v in ops],
                "idle_gaps": [[label(a, b), b - a] for a, b in gaps]}


def _is_device(e) -> bool:
    dt = getattr(e, "device_type", None)
    return (dt == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep"))


def traced(warm, active, counts: dict, facts: dict) -> Trace:
    """Trace warm() (a discarded step of at least PROFILER_WARMUP_S, which
    absorbs the launches the profiler drops when its trace starts), then
    active() inside a "bench.window" range; a trace that recorded no device
    operation is made again, up to TRIES times. active() returns the counts
    of the work it did (waves, frames, steps), merged into counts."""
    from torch.profiler import ProfilerActivity, profile, record_function, \
        schedule

    for _ in range(TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            t0 = time.perf_counter()
            while True:
                warm()
                if time.perf_counter() - t0 >= yardstick.PROFILER_WARMUP_S:
                    break
            torch.cuda.synchronize()
            prof.step()
            with record_function("bench.window"):
                done = active()
                torch.cuda.synchronize()
            prof.step()
        events = prof.events()
        host = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in events
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CPU]
        win = [(s, e) for n, s, e in host if n == "bench.window"]
        if not win:
            continue
        window = win[0]
        device = [(e.name, e.time_range.start * 1e-6,
                   e.time_range.end * 1e-6) for e in events if _is_device(e)]
        device = [(n, max(s, window[0]), min(e, window[1]))
                  for n, s, e in device if e > window[0] and s < window[1]]
        host = [(n, s, e) for n, s, e in host
                if e > window[0] and s < window[1]]
        if device:
            return Trace(device, host, window, {**counts, **done}, facts)
    raise RuntimeError("the profiler recorded no device operation in "
                       f"{TRIES} traced windows")
