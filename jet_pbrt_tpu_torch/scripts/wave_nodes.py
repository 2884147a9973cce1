"""A wave's device operations by range and class, eager and replayed from
its CUDA graph: `python -m jet_pbrt_tpu_torch.scripts.wave_nodes [scene
...]` (scenes: bunny, bunny600k, cornell; default all three; 1024^2,
1-spp, depth 5, on the card).

One 1-spp wave of render() is captured (graph=True), then traced twice by
the profiler, eager and replayed, each after a discarded warm-up step (the
profiler loses the first launches after its trace starts). Every eager
device operation takes the range whose device span holds its start: one
of li_path's record_function ranges (models/integrators.py); else, inside
render()'s "render.wave" span, "camera/init" before li_path's first range,
"end" after its last and "between" between its ranges; else "frame"
(render()'s own operations around the wave: its pixel and sample ids, the
film). A replay carries no ranges, so
its operations take the eager wave's ranges in order, by name; the replay
call's copies of its inputs into the graph's buffers are "graph inputs".
Each operation's class is the port's kernel (a device function of
ops/kernels.py's registry, or the wide kernel's cull pass), a pass of
CUB's radix sort (torch.argsort), a memset, a copy, or other. The script
prints one JSON line per scene: operations and device ms by range and
class, and the names of the operations of class other.

It uses only render(), models/graph.py's cache and the launch registry,
so it also counts the waves of an earlier checkout of the package (put
that checkout first on PYTHONPATH); where a checkout has no render.wave
span, its operations outside li_path's ranges are all "frame".
"""
from __future__ import annotations

import collections
import json
import sys

import torch

from jet_pbrt_tpu_torch.models import graph as graph_mod
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import kernels

# li_path's record_function ranges (models/integrators.py), in wave order
WAVE_RANGES = ("li_path.intersect", "li_path.rng", "li_path.vertex",
               "li_path.occluded", "li_path.nee_accumulate", "li_path.sort")
# render()'s range around each wave (models/render.py)
WAVE_SPAN = "render.wave"
# a wave's operations outside li_path's ranges, and render()'s own
OUTER_RANGES = ("camera/init", "between", "end", "frame")
RANGES = WAVE_RANGES + OUTER_RANGES + ("graph inputs",)
NODE_CLASSES = ("port kernel", "argsort", "memset", "copy", "other")
PORT_KERNEL_NAMES = tuple(kernels.REGISTRY) + ("wide_cull_kernel",)


def node_class(name: str) -> str:
    """NODE_CLASSES' class of a device operation by its profiler name."""
    if any(k in name for k in PORT_KERNEL_NAMES):
        return "port kernel"
    if "cub::" in name or "RadixSort" in name:
        return "argsort"
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        return "copy"
    return "other"


def device_ops(call):
    """One traced call (after a discarded warm-up step): its device
    operations (kernels, memsets, copies) sorted by start, and the
    device-side spans of li_path's ranges and render()'s wave span."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        call()
        torch.cuda.synchronize()
        prof.step()
    dev_events = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
    ops = sorted((e for e in dev_events
                  if not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    spans = [e for e in dev_events if getattr(e, "is_user_annotation", False)
             and e.name in WAVE_RANGES + (WAVE_SPAN,)]
    return ops, spans


def op_labels(starts, spans) -> list:
    """The range of each eager operation (by its start): the li_path range
    whose device span holds it; else, inside a wave span, "camera/init"
    before li_path's first range, "end" after its last and "between"
    between them; else "frame". spans are (name, start, end)."""
    inner = [sp for sp in spans if sp[0] in WAVE_RANGES]
    waves = [sp for sp in spans if sp[0] == WAVE_SPAN]
    first = min((sp[1] for sp in inner), default=float("inf"))
    last = max((sp[2] for sp in inner), default=float("-inf"))
    labels = []
    for t in starts:
        lab = next((name for name, a, b in inner if a <= t < b), None)
        if lab is None:
            in_wave = any(a <= t < b for _, a, b in waves)
            lab = ("frame" if not in_wave else "camera/init" if t < first
                   else "end" if t >= last else "between")
        labels.append(lab)
    return labels


def replay_labels(eager: list, labels: list, replay: list):
    """The ranges of a replay's operations (names, in order) from the
    eager wave's (names and their ranges, in order): each replay operation
    that is the next eager operation by name takes its range, any other is
    the replay call's copy of an input into the graph's buffers ("graph
    inputs"); None where not every eager operation is found so."""
    out, i = [], 0
    for name in replay:
        if i < len(eager) and name == eager[i]:
            out.append(labels[i])
            i += 1
        else:
            out.append("graph inputs")
    return out if i == len(eager) else None


def by_class(names, ms, labels) -> tuple:
    """({range: {class: operations}}, {range: {class: ms}}, {"range: name":
    operations of class other}) of operations (names, device ms, ranges)."""
    nodes = {k: dict.fromkeys(NODE_CLASSES, 0) for k in RANGES}
    class_ms = {k: dict.fromkeys(NODE_CLASSES, 0.0) for k in RANGES}
    other = collections.Counter()
    for name, t, lab in zip(names, ms, labels):
        c = node_class(name)
        nodes[lab][c] += 1
        class_ms[lab][c] += t
        if c == "other":
            other[f"{lab}: {name[:90]}"] += 1
    return nodes, class_ms, dict(other)


def wave_nodes(scene, dev, res: int = 1024, depth: int = 5) -> dict:
    """Device time and operations of one 1-spp wave of scene at res^2 by
    range, eager and replayed, and by class (the replay's, or the eager
    wave's where the replay is not split). Returns {"eager": {range: ms},
    "replayed": {range: ms} or None, "eager_ms", "replayed_ms", "ops",
    "replayed_ops", "spans", "nodes", "class_ms", "other"}."""
    call = lambda graph: render(scene, res, res, spp=1, max_depth=depth,
                                seed=1, device=dev, graph=graph)
    call(True)  # captures the wave
    eager, spans = device_ops(lambda: call(False))
    replay, _ = device_ops(lambda: call(True))
    labels = op_labels([e.time_range.start for e in eager],
                       [(s.name, s.time_range.start, s.time_range.end)
                        for s in spans])
    replayed = replay_labels([e.name for e in eager], labels,
                             [e.name for e in replay])
    ms = lambda evs: [e.time_range.elapsed_us() / 1e3 for e in evs]
    split = lambda evs, lbs: {k: sum(t for t, lb in zip(ms(evs), lbs)
                                     if lb == k) for k in RANGES}
    evs, lbs = (replay, replayed) if replayed is not None else (eager,
                                                               labels)
    nodes, class_ms, other = by_class([e.name for e in evs], ms(evs), lbs)
    return {"eager": split(eager, labels),
            "replayed": None if replayed is None else split(replay, replayed),
            "eager_ms": sum(ms(eager)), "replayed_ms": sum(ms(replay)),
            "ops": len(eager), "replayed_ops": len(replay),
            "spans": len(spans), "nodes": nodes, "class_ms": class_ms,
            "other": other}


def scene_by_name(name: str):
    from jet_pbrt_tpu_torch.scene.scenes import bunny_obj, bunny_scene, \
        cornell_box
    if name == "bunny":
        return bunny_scene()
    if name == "bunny600k":
        return bunny_scene(bunny_path=bunny_obj(600_000))
    if name == "cornell":
        return cornell_box()
    raise ValueError(f"unknown scene {name!r}: bunny, bunny600k, cornell")


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or [
        "bunny", "bunny600k", "cornell"]
    dev = torch.device("cuda")
    for name in names:
        scene = scene_by_name(name).to(dev)
        graph_mod.clear()
        got = wave_nodes(scene, dev)
        graph_mod.clear()
        print(json.dumps({"scene": name, **{k: got[k] for k in (
            "replayed_ops", "replayed_ms", "ops", "eager_ms", "nodes",
            "class_ms", "other")}}), flush=True)
        del scene
    return 0


if __name__ == "__main__":
    sys.exit(main())
