"""One run of one cell: resolve the cell's files by the names that
BENCHMARK.json gives, set up the program, run the traffic's window (or its
traced window), read the metrics, and decide `correct` against the plain
reference once the window has closed."""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from . import check, refcheck, trace as trace_mod, traffic as traffic_mod
from . import program_scene, yardstick
from .reference import scene as ref_scene

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.join(ROOT, "BENCHMARK.json")
# top-level module names no run may load: JAX, and the JAX package (whose
# name the port's begins with, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "jet_pbrt_tpu")
# the host ranges that name an idle gap in the breakdown
GAP_LABELS = {"render.wave": "wave", "bench.render": "render",
              "bench.sync": "sync", "bench.gather": "check_gather",
              "bench.step": "step", "bench.update": "update"}


# a configuration's render block: the keys the harness reads, and the
# values of those that both sides compute as the configuration states
RENDER_KEYS = ("width", "height", "max_depth", "integrator", "sampler",
               "nee", "mis")
HONOURED = {"integrator": ("path",), "sampler": ("random",)}


def check_render(config: dict, traffic: dict) -> None:
    """Raise ValueError, naming the key, where a configuration's render
    block states what the harness cannot honour: a key it does not read,
    or one it needs left out; an integrator other than path or a sampler
    other than random (the reference runs those alone); nee or mis other
    than true or false; MIS without NEE (the program's MIS term would add
    weighted emission on top of the full emission that nee false credits,
    an estimator no user runs); and a fit without NEE (render_fn has no
    nee)."""
    name, r = config["name"], config["render"]
    for key in r:
        if key not in RENDER_KEYS:
            raise ValueError(f"{name}: render.{key} is not a key the "
                             f"harness reads ({', '.join(RENDER_KEYS)})")
    for key in RENDER_KEYS:
        if key not in r:
            raise ValueError(f"{name}: render.{key} is not stated")
    for key, values in HONOURED.items():
        if r[key] not in values:
            raise ValueError(f"{name}: render.{key} {r[key]!r}: the harness "
                             f"honours {' or '.join(values)} alone")
    for key in ("nee", "mis"):
        if not isinstance(r[key], bool):
            raise ValueError(f"{name}: render.{key} {r[key]!r} is not true "
                             f"or false")
    if r["mis"] and not r["nee"]:
        raise ValueError(f"{name}: render.mis true with render.nee false: "
                         "MIS weights light samples that nee false never "
                         "draws")
    if traffic["kind"] == "fit" and not r["nee"]:
        raise ValueError(f"{name}: render.nee false under fit traffic: "
                         "render_fn has no nee")


class Cell:
    """A cell's entries and files, found by name; a configuration whose
    render block the harness cannot honour is refused (check_render)."""

    def __init__(self, spec: dict, workload: str, base: str = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.workload = cells[workload]
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        with open(os.path.join(ROOT, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(base, "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        check_render(self.config, self.traffic)
        with open(os.path.join(base, "limits", workload + ".json")) as f:
            self.limits = json.load(f)
        mine = lambda m: "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.base = base


def load(workload: str, bench: str = BENCH) -> Cell:
    with open(bench) as f:
        return Cell(json.load(f), workload)


def reader(base: str, name: str):
    """The read(trace) function of a per-layer metric's reader file."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "pbrt_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=FORBIDDEN) -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(names))


def scene_facts(layout, width: int, height: int, depth: int) -> dict:
    """The counts the readers' byte bounds take, from the benchmark's own
    layout of the scene."""
    lights = layout.static_lights()
    nee = sum(1 for lt in lights if not lt.static_black)
    n_mats, n_lights = len(layout.mats), len(lights)
    return {"lanes": width * height, "depth": depth, "n_lights": n_lights,
            "nee_lights": nee, "n_mats": n_mats,
            "tables": yardstick.table_bytes(n_mats, n_lights, 0, nee),
            "slots": 8 * n_mats + 3 * n_lights + 3}


def _sizes(cell: Cell, sizes: dict | None) -> dict:
    r = cell.config["render"]
    out = {"width": int(r["width"]), "height": int(r["height"])}
    out.update(sizes or {})
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, sizes: dict | None = None, fault=None) -> dict:
    """One run; returns the result line's object. sizes overrides the
    film, samples and pixel count (CPU tests only); fault(loop) plants
    a fault in the timed path (tests only)."""
    device = torch.device(device)
    sz = _sizes(cell, sizes)
    w, h = sz["width"], sz["height"]
    tr = dict(cell.traffic, **{k: v for k, v in sz.items()
                               if k in ("spp", "target_spp")})
    check_cfg = dict(tr.get("check", {}), **{k: v for k, v in sz.items()
                                             if k == "pixels_per_view"})
    phase = _Phases(t_start)
    layout = ref_scene.Layout(cell.config)
    facts = scene_facts(layout, w, h, int(cell.config["render"]["max_depth"]))
    fit = tr["kind"] == "fit"
    if fit:
        # the fit's input, made by the benchmark; the reference's memory is
        # freed and the peak read from here on, so that it is the program's
        target = refcheck.fit_target(cell.config, layout, tr, seed, w, h,
                                     device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        phase("target")
    scene = program_scene.build(cell.config).to(device)
    phase("scene")
    if fit:
        loop = traffic_mod.Fit(scene, cell.config, tr, seed, device, w, h,
                               target)
    else:
        loop = traffic_mod.Frames(scene, cell.config, tr, seed, device, w, h,
                                  int(check_cfg["pixels_per_view"]))
    del scene
    phase("traffic set-up")
    if fault is not None:
        fault(loop)
    if fit:
        loop.first_steps(3)
    else:
        loop.warm_up(int(sz.get("warmup_frames", tr["warmup_frames"])))
    traffic_mod.sync(device)
    phase("warm-up")
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    traced = None
    if trace:
        n = int(tr["trace"]["steps" if fit else "frames"])
        if fit:
            traced = trace_mod.traced(loop.step, lambda: loop.count(n), {},
                                      facts)
        else:
            traced = trace_mod.traced(lambda: loop.frame(0),
                                      lambda: loop.count(n), {}, facts)
        info = dict(traced.counts)
    else:
        info = loop.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    phase("window")

    # the check, once the window has closed and the program's state is freed
    if fit:
        attempted = info["steps"]
        failed = int(not all(bool(torch.isfinite(v).all())
                             for v in loop.params.values()))
        record = loop.record
        loop.release()
        del loop
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = refcheck.fit_record(cell.config, layout, tr, seed, w, h,
                                  target, device)
        numbers = check.fit_numbers(record, ref)
    else:
        attempted = info["frames"]
        kept, times = loop.kept, loop.times
        failed = sum(1 for _, got in kept
                     if not bool(torch.isfinite(got).all()))
        views, pixels = loop.view_list, loop.pixels
        spp = loop.spp
        del loop
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = refcheck.frame_pixels(cell.config, layout, views,
                                    [v for v, _ in kept], pixels, spp, seed,
                                    w, h, device)
        numbers = {"mismatch_pct": check.mismatch_pct(
            kept, ref, float(check_cfg["tolerance"]))}
    phase("reference check")
    correct, checks = check.judge(numbers, cell.limits)

    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(cell.base, m["name"])(traced)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s}
        if fit:
            values["step_ms"] = info["wall_s"] / info["steps"] * 1e3
        else:
            values.update(frame_values(times, info["wall_s"], w * h * spp))
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    out["metrics"] = metrics
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else device.type),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev_info["busy_s"] = traced.busy_s
        dev_info["window_s"] = traced.window_s
        out["breakdown"] = traced.breakdown(GAP_LABELS)
    out["device"] = dev_info
    out["checks"] = checks
    return out


def frame_values(times, wall_s: float, samples_per_frame: int) -> dict:
    """samples_per_s: the samples of every frame completed in the window
    over the window's wall time; frame_ms_p95: the 95th percentile of every
    frame's time, call to synchronised image (the median and the count go
    to standard error)."""
    ms = [t * 1e3 for t in times]
    p95 = float(np.percentile(ms, 95))
    print(f"frames {len(ms)}, frame ms median {statistics.median(ms)!r}, "
          f"p95 {p95!r}", file=sys.stderr, flush=True)
    return {"samples_per_s": len(ms) * samples_per_frame / wall_s,
            "frame_ms_p95": p95}


class _Phases:
    """Prints each phase's seconds on standard error as it ends."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = now


def report(out: dict, stream=sys.stdout) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), file=stream, flush=True)

