"""The spans of a traced window, and the device's idle gaps put down to
them: what the readers of replay_gap_ms.*, replay_host_ms, frame_gap_ms
and frame_syncs share.

A span is a host range (record_function) whose name begins with one of
SPAN_PREFIXES: the program's (render., graph., diff., li_path.) and the
benchmark's own (bench.), but for bench.window, which is the window
itself. An idle gap is a stretch of the window in which the device runs
nothing: the complement of the union of its operations
(trace.busy_intervals). A gap shorter than MIN_GAP_S is not put down to
a span: such gaps are a graph's own node-to-node gaps (5.6-5.9 us in the
fit, while the host runs ahead). Each longer gap is split among the
innermost spans that cover it, in proportion to the time each covers; a
part that no span covers is put down to OUTSIDE. So the idle put down to
the spans, SHORT and OUTSIDE sum to idle_pct x the window. A checkout
whose program draws no such span gives no reading: the readers return
None."""
from __future__ import annotations

from .trace import busy_intervals

SPAN_PREFIXES = ("render.", "graph.", "diff.", "li_path.", "bench.")
WINDOW = "bench.window"
MIN_GAP_S = 20e-6
SHORT = "short gaps"
OUTSIDE = "outside spans"
# the CUDA runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def spans(trace) -> list:
    """(name, start, end) of the window's spans, by start."""
    return sorted(((n, s, e) for n, s, e in trace.host
                   if n.startswith(SPAN_PREFIXES) and n != WINDOW),
                  key=lambda x: (x[1], -x[2]))


def idle_gaps(trace) -> list:
    """(start, end) of every stretch of the window with no device
    operation running."""
    out, t = [], trace.window[0]
    for s, e in busy_intervals([(s, e) for _, s, e in trace.device]):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        out.append((t, trace.window[1]))
    return out


def _innermost(over, t):
    inner = [x for x in over if x[1] <= t <= x[2]]
    return min(inner, key=lambda x: x[2] - x[1])[0] if inner else OUTSIDE


def idle_split(trace) -> dict:
    """Seconds of the window's idle by where they go: {span name: seconds
    of the gaps of at least MIN_GAP_S under it as the innermost span,
    SHORT: seconds of the shorter gaps, OUTSIDE: seconds of the longer
    gaps under no span}."""
    sp = spans(trace)
    out = {SHORT: 0.0, OUTSIDE: 0.0}
    for a, b in idle_gaps(trace):
        if b - a < MIN_GAP_S:
            out[SHORT] += b - a
            continue
        over = [x for x in sp if x[1] < b and x[2] > a]
        cuts = sorted({a, b} | {t for _, s, e in over for t in (s, e)
                                if a < t < b})
        for u, v in zip(cuts, cuts[1:]):
            name = _innermost(over, 0.5 * (u + v))
            out[name] = out.get(name, 0.0) + (v - u)
    return out


def has(trace, prefix: str) -> bool:
    return any(n.startswith(prefix) for n, _, _ in spans(trace))


def idle_under(trace, prefix: str):
    """Seconds of idle put down to the spans whose name begins with
    prefix; None where the window has no such span."""
    if not has(trace, prefix):
        return None
    return sum(v for k, v in idle_split(trace).items()
               if k.startswith(prefix))


def self_seconds(trace, prefix: str):
    """The host self time, in seconds, of the spans whose name begins with
    prefix: each span's length minus what the spans inside it cover; None
    where the window has no such span."""
    sp = spans(trace)
    mine = [x for x in sp if x[0].startswith(prefix)]
    if not mine:
        return None
    total = 0.0
    for x in mine:
        _, s, e = x
        inner = busy_intervals([(y[1], y[2]) for y in sp if y is not x
                                and s <= y[1] and y[2] <= e])
        total += (e - s) - sum(b - a for a, b in inner)
    return total


def per(trace, seconds, count: str):
    """seconds in ms per counts[count] (waves, steps, frames); None where
    there is no reading or nothing was counted."""
    n = trace.counts.get(count, 0)
    if seconds is None or not n:
        return None
    return 1e3 * seconds / n


def syncs_per_frame(trace):
    """The CUDA runtime calls that wait for the device (SYNC_CALLS) inside
    the program's render.frame spans, per such span; None where the window
    has no render.frame span or its trace records no runtime call."""
    frames = [(s, e) for n, s, e in trace.host if n == "render.frame"]
    if not frames or not any(n.startswith("cuda") for n, _, _ in trace.host):
        return None
    calls = [(s, e) for n, s, e in trace.host if n in SYNC_CALLS]
    inside = sum(1 for s, e in calls
                 if any(a <= s and e <= b for a, b in frames))
    return inside / len(frames)
