#!/usr/bin/env python3
"""Two builds of a kernel on one card, in turns:

    python3 sweep_ab.py OTHER.cu                   # the cull-sweep kernel (K2)
    python3 sweep_ab.py --wide OTHER.cu            # the wide-BVH kernel (K1)
    python3 sweep_ab.py --lib threefry OTHER.cu    # the random streams' kernel
    python3 sweep_ab.py --lib sweep_prims OTHER.cu # the sweep primitives (K3)
    python3 sweep_ab.py --lib brute OTHER.cu       # the brute-force casts
    python3 sweep_ab.py --lib shade_grad OTHER.cu  # the vertex's backward

OTHER.cu is another version of the kernel's source, for example an earlier
commit's, written into a directory that .gitignore lists:

    git show <commit>:jet_pbrt_tpu_torch/csrc/sweep_bvh.cu > _ab/other.cu
    git show 9f3021c:jet_pbrt_tpu_torch/csrc/brute.cu > _ab/brute_old.cu

A source that includes a header takes the one beside it, so an earlier
commit's shade_grad.cu goes into a directory of its own with that
commit's shade.cuh:

    mkdir -p _ab/feed372
    cd _ab/feed372
    git show feed372:jet_pbrt_tpu_torch/csrc/shade_grad.cu > shade_grad.cu
    git show feed372:jet_pbrt_tpu_torch/csrc/shade.cuh > shade.cuh

Each kernel is timed in the order other, this, this, other (CUDA events).
Prints the card's name and power limit first. Needs one GPU.

Sweep: OTHER.cu has the same C entry point (`sweep_bvh_launch`). On
chip_smoke's 2^20-ray wave (wave_rays(scene, 1024, 11)) of the
600k-target instanced bunny and of the 150k x4 soup, 5 launches per turn:
closest hit and any hit (tmax 10% short of the closest hit) on the
instanced bunny, closest hit on the soup; then the instanced bunny's
1024^2, 4-spp, depth-5 frame through each (host wall ending in a
synchronize). The two kernels' outputs, and the two frames, must be equal
bit for bit.

Wide: OTHER.cu exports one of three C entry points: this source's
(`wide_bvh_cast`, ...; a variant of this kernel), the one-launch design's
(`wide_bvh_one_pass`: persistent warps scan the lanes and queue the
survivors in shared memory; no scratch arguments, a stats row per warp)
or the node-major kernel's (`wide_bvh_launch`: one thread per lane over
node-major bounds, no pinned rounding). On the default bunny, 10 launches
per turn: chip_smoke's 2^20-ray wave and its 2^20-ray targeted set,
closest hit and any hit (tmax 10% short of the closest hit), then the 16
wide casts of one 1-spp wave as chip_smoke records them (5 launches of
each per turn, summed over the casts, with the host's enqueue time, its
slowest call, and what could stall the host during the event-timed calls:
chip_smoke.host_stalls); then the 1024^2, 4-spp, depth-5 frame through
each. After the turns each build's device time per call is read by the
profiler (chip_smoke.profiled_ms, 10 calls; each device operation by
name: kernels and memsets). A variant must give outputs and frames equal
bit for bit, and its counters and this kernel's are printed (visits, SIMD
efficiency, lane-0 cycle split); the one-launch design pins its
arithmetic as this one does, so it too must agree bit for bit. The
node-major kernel pins neither its arithmetic nor its child order, so
there the count of lanes whose output differs is printed and each is put
through chip_smoke's float64 forensic, and the frames' largest pixel
difference is printed.

--lib NAME: a kernel behind a ctypes wrapper whose module loads its
library through _library(), which is swapped per turn (LIB_AB). OTHER.cu
has the same C entry points. Each case's output of both builds is held
equal to the plain version's bit for bit, and the timed cases run 20 or
100 calls per turn (chip_smoke.kernel_times: events, host enqueue, and
the profiler's device time). threefry, at chip_smoke's 2^20 lanes
(rng_phase's keys): a lane_keys call and a uniforms call at S = 2, 6, 8,
10 and 13 (the camera, 1-3 lights, and a width of the generic
instantiation); each build's SASS per lane at S = 8 (ALU-pipe,
FMA-heavy-pipe, all; chip_smoke.threefry_sass) beside the function's
bound; then the default bunny's 1024^2, 4-spp, depth-5 frame through
each build (frames equal bit for bit) and each build's profiled 1-spp
wave (chip_smoke.profile_wave, the Threefry share of device time).
sweep_prims: chip_smoke.prims' six inputs held equal, the harness's
inputs timed. brute: the Cornell box's bounce-1 closest cast and its first
shadow cast of a 1024^2 wave (2^20 lanes, as chip_smoke.time_brute records
them) and the many-shapes scene's 256^2 wave rays (more than one tile of
each kind), closest hit and any hit (tmax 10% short of the closest hit),
each against both bounds (chip_smoke.brute_bounds: one issued instruction
per operation, and F32_PEAK); then the Cornell 512^2, 16-spp, depth-5
frame through each build (frames equal bit for bit) and each build's
profiled 1024^2 1-spp Cornell wave. Each build's ptxas registers, shared
memory and spills are printed where this process built it.

shade_grad: OTHER.cu has this source's C entry points (a variant: one
launch per tangent set) or commit feed372's (one vertex_backward launch a
vertex, its grid by lanes, grad_reduce in block order); ops/shade.py's
vertex_backward and grad_reduce are swapped per turn for the other
build's. Both builds' ptxas lines per kernel first. On the bunny's and
the Cornell box's 1024^2 1-spp gradient waves (chip_smoke.grad_wave_calls,
every appearance field on the tape): the bounce-1 vertex's backward at
2^20 lanes with seeded upstream gradients, d loss / d beta equal bit
for bit between the builds and each parameter field within
chip_smoke.GRAD_FIELD_TOL of its largest |gradient|; its vertex_backward
call timed per turn (events over 20 calls, host enqueue, and the device
time by events behind a held stream, warm and after an L2 flush each:
shade_grad_times), its grad_reduce on that build's partials and
torch.sum(partials, 0) on the same; every vertex of the wave's backward
(vertex_grads of the six, both kernels) per turn. Then the bunny's loss
mean((img - target)^2) over mat_c0 and light_c at 1024^2, 1 spp, depth
5 (chip_smoke.diff_phase's): each build's profiled backward
(chip_smoke.profile_backward: every device operation), and in turns
the eager and the graphed value_and_grad (the graph captured anew under
each build; medians of 5 calls after a warm-up), a 6-step fit graphed
and eager (median ms a step) and the (1, 1) train step of chip_smoke's
phase 12 (train_steps over a one-rank NCCL world), graphed and eager;
each turn's gradient against the other build's within GRAD_FIELD_TOL.

Frames replay their waves from CUDA graphs (models/graph.py), and a graph
keeps the kernels it captured: each turn empties the graph cache and
renders the frame once under its build with graph=True (the capture,
untimed) before the timed frame, and each build's profiled wave is
captured under it.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke
from jet_pbrt_tpu_torch.diff import params as dparams
from jet_pbrt_tpu_torch.models import graph as graph_mod
from jet_pbrt_tpu_torch.models.render import render, render_fn
from jet_pbrt_tpu_torch.ops import brute as brute_ops
from jet_pbrt_tpu_torch.ops import intersect as isect_ops
from jet_pbrt_tpu_torch.ops import rng, sweep_bvh, wide_bvh
from jet_pbrt_tpu_torch.ops import shade as shade_ops
from jet_pbrt_tpu_torch.ops.intersect import KindHit
from jet_pbrt_tpu_torch.parallel import mesh as pmesh
from jet_pbrt_tpu_torch.parallel import multihost
from jet_pbrt_tpu_torch.scene import pack as scene_pack
from jet_pbrt_tpu_torch.scene.scenes import bunny_scene, cornell_box
from jet_pbrt_tpu_torch.scripts import sweep_prims
from jet_pbrt_tpu_torch.utils import cuda_build

ORDER = ("other", "this", "this", "other")


def _card():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return torch.device("cuda")


def sweep_main(path) -> int:
    dev = _card()
    libs = {"this": sweep_bvh.load_kernel(),
            "other": sweep_bvh.load_kernel(path, "sweep_bvh_other")}
    this_kernel = sweep_bvh.load_kernel
    inst = chip_smoke.build_sweep_scene(
        "bunny 600k instanced", dev,
        bunny_path=chip_smoke.dense_obj(600_000))[0]
    soup = chip_smoke.build_sweep_scene(
        "bunny 150k x4 soup", dev, bunny_path=chip_smoke.dense_obj(150_000),
        instancing=False)[0]
    for label, scene, modes in (("instanced", inst, ("closest", "any")),
                                ("soup", soup, ("closest",))):
        route = chip_smoke.sweep_route(scene)
        tables = (scene.pack.inst_sweep[0] if any(scene.meta.pallas_blas)
                  else scene.pack.bvh_sweep)
        o, d, tmin, tmax = chip_smoke.wave_rays(scene, 1024, 11, dev)
        tmax_sh = chip_smoke._shadow_tmax(route, o, d, tmin, tmax)[0]
        for mode in modes:
            tm = tmax if mode == "closest" else tmax_sh
            times = {"this": [], "other": []}
            outs = {}
            for who in ORDER:
                ms, out = chip_smoke.time_ms(lambda: sweep_bvh.launch(
                    libs[who], tables, o, d, tmin, tm,
                    any_hit=mode == "any", n_tris=route.n_tris), 5)
                times[who].append(ms)
                outs[who] = out
            same = all(torch.equal(a, b) for a, b in zip(outs["this"],
                                                         outs["other"]))
            if not same:
                raise AssertionError(f"{label} {mode}: the two kernels differ")
            print(f"sweep A/B {label} {mode} at {o.shape[0]} rays (order "
                  f"other, this, this, other): other "
                  f"{times['other'][0]:.4f} / {times['other'][1]:.4f} ms, "
                  f"this {times['this'][0]:.4f} / {times['this'][1]:.4f} ms; "
                  "outputs equal bit for bit", flush=True)
    del soup

    imgs, walls = {}, {"this": [], "other": []}
    render(inst, 64, 64, spp=1, max_depth=5, device=dev)  # warm-up
    for who in ORDER:
        sweep_bvh.load_kernel = lambda lib=libs[who]: lib
        try:
            _captured_frame(inst, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(inst, 1024, 1024, spp=4, max_depth=5, seed=0,
                         clamp=False, device=dev)
            torch.cuda.synchronize()
            walls[who].append(time.perf_counter() - t0)
        finally:
            sweep_bvh.load_kernel = this_kernel
        imgs.setdefault(who, img)
    if not torch.equal(imgs["this"], imgs["other"]):
        raise AssertionError("the two kernels render different frames")
    print(f"sweep A/B frame 1024^2 spp 4 depth 5 (order other, this, this, "
          f"other): other {walls['other'][0]:.3f} / {walls['other'][1]:.3f} "
          f"s, this {walls['this'][0]:.3f} / {walls['this'][1]:.3f} s; "
          "frames equal bit for bit", flush=True)
    return 0


# --------------------------------------------------------------------------
# the wide kernel
# --------------------------------------------------------------------------

# the device operations of a cast by any of the three entry points (the
# one-launch design and the node-major kernel name their one kernel
# wide_bvh_kernel)
WIDE_OPS = chip_smoke.WIDE_OPS + ("wide_bvh_kernel",)


def _entry(lib) -> str:
    return next(e for e in ("wide_bvh_cast", "wide_bvh_one_pass",
                            "wide_bvh_launch") if hasattr(lib, e))


def _declare_wide(lib):
    """This source's entry points; or the one-launch design's
    wide_bvh_one_pass (planar, child, tris, inst, o, d, tmin, tmax, n,
    blas_root, leaf_size, n_tris, any_hit, has_inst, t_out, idx_out, stats,
    stream); or the node-major kernel's wide_bvh_launch (bounds, child,
    tris, inst, o, d, tmin, tmax, n, blas_root, leaf_size, n_tris, any_hit,
    has_inst, t_out, idx_out, stream)."""
    entry = _entry(lib)
    if entry == "wide_bvh_cast":
        wide_bvh._declare(lib)
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [vp] * 8 + [ci] * 6 + [vp] * (
        4 if entry == "wide_bvh_one_pass" else 3)
    fn.restype = ci


def wide_call(lib, tables, o, d, tmin, tmax, *, any_hit, has_inst,
              leaf_size, n_tris, stats=None, out=None):
    """One cast through lib on the current stream -> KindHit, copied into
    out = (t, index, valid) where the caller hands its slab rows."""
    hit = _wide_call(lib, tables, o, d, tmin, tmax, any_hit=any_hit,
                     has_inst=has_inst, leaf_size=leaf_size, n_tris=n_tris,
                     stats=stats)
    if out is None:
        return hit
    return KindHit(*(y.copy_(x) for x, y in zip(hit, out)))


def _wide_call(lib, tables, o, d, tmin, tmax, *, any_hit, has_inst,
               leaf_size, n_tris, stats=None):
    entry = _entry(lib)
    if entry == "wide_bvh_cast":
        t, idx = wide_bvh.launch(lib, tables, o, d, tmin, tmax,
                                 any_hit=any_hit, has_inst=has_inst,
                                 leaf_size=leaf_size, n_tris=n_tris,
                                 stats=stats)
        return KindHit(t=t, index=idx, valid=torch.isfinite(t))
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    idx = torch.empty((n,), dtype=torch.int32, device=o.device)
    one_pass = entry == "wide_bvh_one_pass"
    err = getattr(lib, entry)(
        tables.planar.data_ptr() if one_pass else tables.bounds.data_ptr(),
        tables.child.data_ptr(), tables.tris.data_ptr(),
        tables.inst.data_ptr(), o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
        tmax.data_ptr(), n, tables.blas_root, leaf_size, n_tris, int(any_hit),
        int(has_inst), t.data_ptr(), idx.data_ptr(),
        *((None,) if one_pass else ()),
        torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"other wide kernel: CUDA error {err}")
    return KindHit(t=t, index=idx, valid=torch.isfinite(t))


def _wide_stats(lib, tables, rays, kw):
    warps = lib.wide_bvh_walk_warps(int(kw["any_hit"]), int(kw["has_inst"]), 1)
    stats = torch.empty((1 + warps, wide_bvh.STATS_COLS), dtype=torch.int64,
                        device=rays[0].device)
    wide_call(lib, tables, *rays, stats=stats, **kw)
    return wide_bvh.stats_summary(stats, kw["leaf_size"])


def _device(lib, call) -> tuple[float, str]:
    """(device ms per call, its split by operation) of call(lib)."""
    parts = {k: v for k, v in chip_smoke.profiled_ms(
        lambda: call(lib), 10, WIDE_OPS, each=()).items() if v}
    return sum(parts.values()), ", ".join(f"{k} {v:.4f}"
                                          for k, v in parts.items())


def _held(route, label, rays, kw, out_this, out_other, pinned):
    """A build that pins its arithmetic: equal bit for bit. The
    node-major kernel: lanes that differ, through the forensic."""
    if pinned:
        if not all(torch.equal(a, b) for a, b in zip(out_this, out_other)):
            raise AssertionError(f"{label}: the other build's output differs")
        return "outputs equal bit for bit"
    chip_smoke.check_lanes(route, f"wide A/B {label}, this vs other", *rays,
                           kw["any_hit"], out_this, out_other, exact=False)
    return "differing lanes explained (line above)"


def wide_main(path) -> int:
    dev = _card()
    libs = {"this": wide_bvh.load_kernel(),
            "other": cuda_build.load_library("wide_bvh_other", [path],
                                             _declare_wide)}
    entry = _entry(libs["other"])
    variant, pinned = entry == "wide_bvh_cast", entry != "wide_bvh_launch"
    print(f"other kernel: {path} (entry {entry})", flush=True)
    bunny = bunny_scene().to(dev)
    route = chip_smoke.wide_route(bunny)
    tables = bunny.pack.inst_wide[0]
    base = dict(has_inst=True, leaf_size=bunny.meta.blas_leaf_size[0],
                n_tris=bunny.meta.n_blas_tris[0])

    sets = (("wave", chip_smoke.wave_rays(bunny, 1024, 11, dev)),
            ("targeted",
             chip_smoke.targeted_rays(bunny, route, 1 << 20, 12, dev)))
    for label, (o, d, tmin, tmax) in sets:
        tmax_sh = chip_smoke._shadow_tmax(route, o, d, tmin, tmax)[0]
        for mode, tm in (("closest", tmax), ("any", tmax_sh)):
            rays = (o, d, tmin, tm)
            kw = dict(base, any_hit=mode == "any")
            call = lambda lib: wide_call(lib, tables, *rays, **kw)
            times, outs = {"this": [], "other": []}, {}
            for who in ORDER:
                ms, out = chip_smoke.time_ms(lambda: call(libs[who]), 10)
                times[who].append(ms)
                outs.setdefault(who, out)
            held = _held(route, f"{label} {mode}", rays, kw, outs["this"],
                         outs["other"], pinned)
            dev_ms = {who: _device(libs[who], call) for who in ORDER[:2]}
            print(f"wide A/B {label} {mode} at {o.shape[0]} rays (order other, "
                  f"this, this, other): other {times['other'][0]:.4f} / "
                  f"{times['other'][1]:.4f} ms, this {times['this'][0]:.4f} / "
                  f"{times['this'][1]:.4f} ms by events; device time other "
                  f"{dev_ms['other'][0]:.4f} ms ({dev_ms['other'][1]}), this "
                  f"{dev_ms['this'][0]:.4f} ms ({dev_ms['this'][1]}); {held}",
                  flush=True)
            for who in ("other", "this") if variant else ("this",):
                st = _wide_stats(libs[who], tables, rays, kw)
                print(f"  {who} counters: node visits {st['node_visits']}, "
                      f"triangle tests {st['tri_tests']}, "
                      + chip_smoke.counters_line(st), flush=True)
        del o, d, tmin, tmax, tmax_sh

    casts = chip_smoke.wide_casts(bunny, dev)
    sums = {"this": [], "other": []}
    for who in ORDER:
        total = host = slowest = 0.0
        stalls = dict.fromkeys(("gc", "gc_ms", "mallocs", "frees"), 0)
        for tb, o, d, tmin, tmax, kw in casts:
            ms, host_ms, slow, st, _ = chip_smoke.time_enqueue_ms(
                lambda: wide_call(libs[who], tb, o, d, tmin, tmax, **kw), 5)
            total += ms
            host += host_ms
            slowest = max(slowest, slow)
            for k in stalls:
                stalls[k] += st[k]
        sums[who].append((total, host, slowest, stalls))
    dev_sum = {who: sum(_device(libs[who], lambda lib: wide_call(
        lib, tb, o, d, tmin, tmax, **kw))[0]
        for tb, o, d, tmin, tmax, kw in casts) for who in ORDER[:2]}
    for j, (tb, o, d, tmin, tmax, kw) in enumerate(casts):
        _held(route, f"cast {j}", (o, d, tmin, tmax), kw,
              wide_call(libs["this"], tb, o, d, tmin, tmax, **kw),
              wide_call(libs["other"], tb, o, d, tmin, tmax, **kw), pinned)
    turn = lambda x: (f"{x[0]:.4f} ms (host enqueue {x[1]:.4f} ms, slowest "
                      f"call {x[2]:.4f} ms; "
                      + chip_smoke.stalls_line(x[3]) + ")")
    print(f"wide A/B the {len(casts)} casts of one 1-spp wave, summed (order "
          f"other, this, this, other): other {turn(sums['other'][0])} / "
          f"{turn(sums['other'][1])}, this {turn(sums['this'][0])} / "
          f"{turn(sums['this'][1])} by events; device time other "
          f"{dev_sum['other']:.4f} ms, this {dev_sum['this']:.4f} ms",
          flush=True)
    del casts

    inner = wide_bvh.intersect_wide
    imgs, walls = {}, {"this": [], "other": []}
    render(bunny, 64, 64, spp=1, max_depth=5, device=dev)  # warm-up
    for who in ORDER:
        wide_bvh.intersect_wide = (
            lambda tb, o, d, tmin, tmax, lib=libs[who], **kw:
            wide_call(lib, tb, o, d, tmin, tmax, **kw))
        try:
            _captured_frame(bunny, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(bunny, 1024, 1024, spp=4, max_depth=5, seed=0,
                         clamp=False, device=dev)
            torch.cuda.synchronize()
            walls[who].append(time.perf_counter() - t0)
        finally:
            wide_bvh.intersect_wide = inner
        imgs.setdefault(who, img)
    diff = (imgs["this"] - imgs["other"]).abs()
    if pinned and float(diff.max()) != 0.0:
        raise AssertionError("the other build renders a different frame")
    print(f"wide A/B frame 1024^2 spp 4 depth 5 (order other, this, this, "
          f"other): other {walls['other'][0]:.3f} / {walls['other'][1]:.3f} "
          f"s, this {walls['this'][0]:.3f} / {walls['this'][1]:.3f} s; "
          f"frames: {int((diff.amax(-1) > 0).sum())} pixels differ, largest "
          f"difference {float(diff.max()):.6g}", flush=True)
    return 0


# --------------------------------------------------------------------------
# --lib: a kernel behind a ctypes wrapper whose module loads its library
# through a module-level _library(), swapped per turn
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _using(module, lib):
    this = module._library
    module._library = lambda: lib
    try:
        yield
    finally:
        module._library = this


def _turns(module, libs, call, names, reps):
    """{who: [kernel_times of each turn]} of call() with module's wrapper
    on each build, in ORDER."""
    times = {"this": [], "other": []}
    for who in ORDER:
        with _using(module, libs[who]):
            times[who].append(chip_smoke.kernel_times(call, names, reps))
    return times


def _turns_line(times) -> str:
    turn = lambda t: (f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, "
                      f"enqueue {t['enqueue_ms']:.4f})")
    return (f"other {turn(times['other'][0])} / {turn(times['other'][1])}, "
            f"this {turn(times['this'][0])} / {turn(times['this'][1])}")


def _held_equal(label, outs):
    """outs: tuples of tensors, each equal to the first bit for bit."""
    if not all(torch.equal(x, y) for other in outs[1:]
               for x, y in zip(outs[0], other)):
        raise AssertionError(f"{label}: the builds and the plain version "
                             "differ")


def threefry_cases(dev):
    """--lib threefry: [(label, call, plain output, kernel names, reps)]."""
    n = 1 << 20
    seed, sample, pixel, _ = chip_smoke.rng_inputs(dev, n)
    keys = rng.lane_keys(seed, sample, pixel)
    kb, kby = chip_smoke.threefry_bounds(n, 2)[1]
    cases = [(f"lane_keys at {n} lanes (bound {kb:.6f} ms, {kby})",
              lambda: tuple(rng.lane_keys(seed, sample, pixel)[:2]),
              tuple(rng.lane_keys_plain(seed, sample, pixel)[:2]),
              ("lane_keys_kernel",), 20)]
    for s in (2, 6, 8, 10, 13):
        purpose = rng.PURPOSE_CAMERA if s == 2 else rng.PURPOSE_PATH_BASE + 2
        ub, uby = chip_smoke.threefry_bounds(n, s)[0]
        cases.append((f"uniforms S = {s} at {n} lanes (bound {ub:.6f} ms, "
                      f"{uby})",
                      lambda s=s, p=purpose: (rng.uniforms(keys, p, s),),
                      (rng.uniforms_plain(keys, purpose, s),),
                      ("uniforms_kernel",), 20))
    return cases


def prims_cases(dev):
    """--lib sweep_prims: chip_smoke.prims' inputs, the first timed."""
    cases = []
    for seed, ties in chip_smoke.PRIMS_INPUTS:
        a, b = (torch.from_numpy(x).to(dev)
                for x in sweep_prims.inputs(seed, ties))
        cases.append((f"sweep_prims seed {seed} ties {ties}",
                      lambda a=a, b=b: (sweep_prims.sweep_prims(a, b),),
                      (sweep_prims.sweep_prims_plain(a, b),),
                      ("sweep_prims_kernel",), 0 if cases else 100))
    return cases


def brute_cases(dev):
    """--lib brute: the Cornell box's bounce-1 closest and first shadow
    casts at 2^20 lanes, and the many-shapes scene's 256^2 wave rays in
    both modes, each output as its t bits, index and valid per kind (or
    the any-hit flag)."""
    cornell = cornell_box().to(dev)
    calls, _ = chip_smoke.brute_wave("cornell", cornell, 1024, dev)
    (closest, _, _), (shadow, _, _) = chip_smoke.timed_brute_calls(calls)
    del calls
    many = chip_smoke.many_shapes_scene().to(dev)
    ms = scene_pack.brute_shapes(many.meta, many.pack)
    o, d, tmin, tmax = chip_smoke.wave_rays(many, 256, 24, dev)
    any_tmax = chip_smoke.short_of_closest(o, d, tmin, tmax, ms)
    cases = []
    for label, a in (("Cornell bounce-1 closest", closest),
                     ("Cornell first shadow", shadow),
                     ("many-shapes closest", (o, d, tmin, tmax, ms, False)),
                     ("many-shapes any-hit",
                      (o, d, tmin, any_tmax, ms, True))):
        b = chip_smoke.brute_bounds(*a)
        (bms, bby), (fms, fby) = b["bound"], b["flop_bound"]
        counts = {f: getattr(a[4], f)[0].shape[0] for f in a[4].present}
        cases.append((
            f"{label} cast ({a[0].shape[0]} lanes, {b['work']['live']} live, "
            f"shapes {counts}; bound {bms:.6f} ms by {bby}, one issued "
            f"instruction an operation; {fms:.6f} ms by {fby} at "
            f"{chip_smoke.F32_PEAK / 1e12:.0f} TFLOP/s)",
            lambda a=a: _brute_bits(brute_ops.brute_hits(*a), a[5]),
            _brute_bits(isect_ops.brute_hits_plain(*a), a[5]),
            ("brute_hits_kernel",), 20))
    return cases


def _brute_bits(got, any_hit: bool) -> tuple:
    """A brute_hits output as exact tensors: t as its bits."""
    if any_hit:
        return (got,)
    return tuple(x for h in got for x in (h.t.view(torch.int32), h.index,
                                          h.valid))


def _frames(module, libs, dev, label, scene, res, spp):
    """The scene's res^2, spp frame through each build, equal bit for
    bit, then each build's profiled 1024^2 1-spp wave."""
    imgs, walls = {}, {"this": [], "other": []}
    render(scene, 64, 64, spp=1, max_depth=5, device=dev)  # warm-up
    for who in ORDER:
        with _using(module, libs[who]):
            _captured_frame(scene, dev, res, spp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(scene, res, res, spp=spp, max_depth=5, seed=0,
                         clamp=False, device=dev)
            torch.cuda.synchronize()
            walls[who].append(time.perf_counter() - t0)
        imgs.setdefault(who, img)
    if not torch.equal(imgs["this"], imgs["other"]):
        raise AssertionError("the two builds render different frames")
    print(f"A/B {label} frame {res}^2 spp {spp} depth 5 (order other, this, "
          f"this, other): other {walls['other'][0]:.4f} / "
          f"{walls['other'][1]:.4f} s, this {walls['this'][0]:.4f} / "
          f"{walls['this'][1]:.4f} s; frames equal bit for bit", flush=True)
    for who in ORDER:
        with _using(module, libs[who]):
            graph_mod.clear()
            chip_smoke.profile_wave(scene, dev, f"A/B {who} {label}:",
                                    table=False)
    graph_mod.clear()


def _captured_frame(scene, dev, res=1024, spp=4):
    """The turn's frame captured under the build in place (untimed): the
    graph cache emptied, then one frame rendered."""
    graph_mod.clear()
    return render(scene, res, res, spp=spp, max_depth=5, seed=0, clamp=False,
                  device=dev, graph=True)


# --lib shade_grad: the vertex's backward
# --------------------------------------------------------------------------

class _OneLaunchArgs(ctypes.Structure):
    """Commit feed372's argument layout: this one's without first and
    device_acc."""
    _fields_ = [f for f in shade_ops._GradArgs._fields_
                if f[0] not in ("first", "device_acc")]


def _declare_shade_grad(lib):
    """Declares a build of this source's entry points, or commit
    feed372's."""
    if hasattr(lib, "vertex_backward_rows"):
        shade_ops._declare_grad(lib)
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.vertex_backward.argtypes = [ctypes.POINTER(_OneLaunchArgs), vp]
    lib.grad_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.vertex_backward_grid.argtypes = [ci]
    for name in ("vertex_backward", "grad_reduce", "vertex_backward_grid",
                 "shade_grad_args_size"):
        getattr(lib, name).restype = ci
    if lib.shade_grad_args_size() != ctypes.sizeof(_OneLaunchArgs):
        raise RuntimeError("OTHER.cu's argument layout is neither this "
                           "source's nor feed372's")


def _one_launch_wrappers(lib):
    """vertex_backward and grad_reduce on a build of feed372's entry points:
    one launch a vertex, partials [grid, slots] summed in block order."""
    def vertex_backward(meta, pack, hit, state, u_vertex, bounce, max_depth,
                        lights, occ, gL, gbeta=None, taps=False):
        dev = gL.device
        shade_ops.check_backward_inputs(meta, pack, hit, state, u_vertex,
                                        bounce, max_depth, occ, gL, gbeta,
                                        dev)
        n, last = gL.shape[0], bounce >= max_depth
        n_nee = shade_ops._check_lights(meta, lights, dev)
        slots = shade_ops.n_grad_slots(pack)
        f32 = dict(dtype=torch.float32, device=dev)
        gbeta_in = torch.empty((n, 3), **f32)
        partials = torch.empty((lib.vertex_backward_grid(n), slots), **f32)
        tap_g = torch.empty((n, 4, 3), **f32) if taps else None
        tap_rows = torch.empty((n, 4), dtype=torch.int64, device=dev) \
            if taps else None
        g = _OneLaunchArgs()
        g.a = shade_ops._shade_args(meta, pack, hit, state, u_vertex, bounce,
                                    max_depth, lights, 0 if last else n_nee,
                                    {})
        for k, v in dict(gL=gL, gbeta=gbeta, occ=None if last else occ,
                         gbeta_in=gbeta_in, partials=partials, taps=tap_g,
                         tap_rows=tap_rows).items():
            setattr(g, k, None if v is None else v.data_ptr())
        g.n_mat, g.n_tex_rows = pack.mat_c0.shape[0], pack.tex_c0.shape[0]
        g.n_slots = slots
        if lib.vertex_backward(ctypes.byref(g),
                               torch.cuda.current_stream(dev).cuda_stream):
            raise RuntimeError("the other build's vertex_backward launch "
                               "failed")
        vertex_backward.launches += 1
        return gbeta_in, partials, tap_g, tap_rows

    def grad_reduce(partials):
        grid, slots = partials.shape
        out = torch.empty((slots,), dtype=torch.float32,
                          device=partials.device)
        if lib.grad_reduce(partials.data_ptr(), grid, slots, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the other build's grad_reduce launch failed")
        grad_reduce.launches += 1
        return out

    vertex_backward.launches = grad_reduce.launches = 0
    return vertex_backward, grad_reduce


@contextlib.contextmanager
def _grad_build(lib):
    """While open, ops/shade.py's backward runs on lib (this source's
    entry points through _grad_library, feed372's through its wrappers) and
    no graph captured under another build is replayed."""
    saved = (shade_ops._grad_library, shade_ops.vertex_backward,
             shade_ops.grad_reduce)
    if hasattr(lib, "vertex_backward_rows"):
        shade_ops._grad_library = lambda: lib
    else:
        shade_ops.vertex_backward, shade_ops.grad_reduce = \
            _one_launch_wrappers(lib)
    graph_mod.clear()
    try:
        yield
    finally:
        graph_mod.clear()
        (shade_ops._grad_library, shade_ops.vertex_backward,
         shade_ops.grad_reduce) = saved


def _ptxas(name: str, log: str, who: str) -> None:
    """Each kernel's ptxas registers, stack and spills in a build log."""
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)[-48:]
        elif kernel and ("registers" in line or "spill" in line):
            print(f"{who} {name} {kernel}: {line.strip()}", flush=True)


def shade_grad_times(call, flush, reps: int = 20) -> dict:
    """One build's call: events ms over reps calls, host enqueue ms a call,
    device ms by events behind a held stream (chip_smoke.queued_events_ms),
    and the same after an L2 flush each (the flush's own time taken
    off)."""
    ms, host = chip_smoke.time_enqueue_ms(call, reps)[:2]
    dev = chip_smoke.queued_events_ms(call, reps)
    cold = chip_smoke.queued_events_ms(lambda: (flush.fill_(0), call()),
                                       reps) \
        - chip_smoke.queued_events_ms(lambda: flush.fill_(0), reps)
    return {"ms": ms, "enqueue_ms": host, "device_ms": dev,
            "device_cold_ms": cold}


def _grads_close(label, a: dict, b: dict) -> float:
    """Each field of a within GRAD_FIELD_TOL of b's largest |gradient|;
    returns the largest error relative to it."""
    worst = 0.0
    for k in (k for k in b if b[k].numel()):
        scale = float(b[k].abs().max())
        err = float((a[k] - b[k]).abs().max())
        if not (err <= chip_smoke.GRAD_FIELD_TOL * scale or err == 0.0) \
                or not bool(torch.isfinite(a[k]).all()):
            raise AssertionError(f"{label}: d loss / d {k} of the builds "
                                 f"differ by {err} (largest {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def _line(label, times) -> str:
    t = lambda x: (f"{x['ms']:.4f} ms (device {x['device_ms']:.4f}, after "
                   f"an L2 flush {x['device_cold_ms']:.4f}, enqueue "
                   f"{x['enqueue_ms']:.4f})")
    return (f"shade_grad A/B {label} (order other, this, this, other): other "
            f"{t(times['other'][0])} / {t(times['other'][1])}, this "
            f"{t(times['this'][0])} / {t(times['this'][1])}")


def shade_grad_main(path) -> int:
    dev = _card()
    # both builds at once: each takes minutes
    cuda_build.build_libraries([("shade_grad", ["shade_grad.cu"]),
                                ("shade_grad_other", [path])])
    libs = {"this": shade_ops._grad_library(),
            "other": cuda_build.load_library("shade_grad_other", [path],
                                             _declare_shade_grad)}
    print(f"other kernel: {path}", flush=True)
    for who, built in (("other", "shade_grad_other"), ("this", "shade_grad")):
        _ptxas("shade_grad", cuda_build.BUILD_LOG.get(built, (0, ""))[1],
               who)
    flush = torch.empty((chip_smoke.L2_FLUSH_BYTES // 4,), dtype=torch.int32,
                        device=dev)
    for label, scene in (("bunny", bunny_scene()), ("Cornell",
                                                    cornell_box())):
        calls = chip_smoke.grad_wave_calls(label, scene.to(dev), 1024, dev)
        vertices = [a for k, a in calls if k == "vertex"]
        seeded = [chip_smoke.seeded_grads(r[3].L.shape[0], 7 + r[5], dev,
                                          r[5] >= r[6]) for r in vertices]
        run = lambda r, g: shade_ops.vertex_grads(
            *r[:3], chip_smoke.kernel_state(r[3]), *r[4:], *g)
        rec, grads = vertices[1], seeded[1]
        outs = {}
        for who in ORDER[:2]:
            with _grad_build(libs[who]):
                gl, gb, g, ge = run(rec, grads)
                outs[who] = (gb, {**g, "le_env": ge})
        if not torch.equal(outs["this"][0], outs["other"][0]):
            raise AssertionError(f"{label}: the builds' d loss / d beta "
                                 "differ")
        worst = _grads_close(label, outs["this"][1], outs["other"][1])
        meta, pack, hit, state, u, bounce, depth, lights, occ = rec
        kernel = lambda: shade_ops.vertex_backward(
            meta, pack, hit, chip_smoke.kernel_state(state), u, bounce,
            depth, lights, occ, *grads)
        times = {"this": [], "other": []}
        reduce_times = {"this": [], "other": []}
        wave_times = {"this": [], "other": []}
        for who in ORDER:
            with _grad_build(libs[who]):
                times[who].append(shade_grad_times(kernel, flush))
                partials = kernel()[1]
                reduce_times[who].append(shade_grad_times(
                    lambda: shade_ops.grad_reduce(partials), flush))
                wave_times[who].append(chip_smoke.queued_events_ms(
                    lambda: [run(r, g) for r, g in zip(vertices, seeded)],
                    5))
        partials = kernel()[1]
        lib_ms = shade_grad_times(lambda: torch.sum(partials, 0), flush)
        print(_line(f"{label} bounce-1 vertex_backward ({state.L.shape[0]} "
                    "lanes)", times) + f"; d loss / d beta equal bit for bit, "
              f"fields within {worst:.2e} of their largest |gradient|",
              flush=True)
        print(_line(f"{label} grad_reduce (each build's partials)",
                    reduce_times) + f"; torch.sum(partials, 0) on this "
              f"build's {list(partials.shape)}: {lib_ms['device_ms']:.4f} "
              "ms device", flush=True)
        print(f"shade_grad A/B {label} the wave's {len(vertices)} vertices' "
              f"backward (vertex_backward and grad_reduce, device ms by "
              f"events behind a held stream; order other, this, this, "
              f"other): other {wave_times['other'][0]:.4f} / "
              f"{wave_times['other'][1]:.4f}, this "
              f"{wave_times['this'][0]:.4f} / {wave_times['this'][1]:.4f}",
              flush=True)
        del calls, vertices, rec, partials
    _shade_grad_steps(libs, dev)
    return 0


def _shade_grad_steps(libs, dev, res: int = 1024) -> None:
    """The bunny loss's profiled backward under each build, then in turns
    eager and graphed value_and_grad, a fit and the (1, 1) train step."""
    scene = bunny_scene().to(dev)
    fn, pack = render_fn(scene, res, res, spp=1, seed=0, max_depth=5,
                         device=dev)
    with torch.no_grad():
        target = fn(dparams.with_params(pack,
                                        {"light_c": pack.light_c * 1.2}))
    loss = lambda img: torch.mean((img - target) ** 2)
    fields = ("mat_c0", "light_c")
    for who in ORDER[:2]:
        with _grad_build(libs[who]):
            chip_smoke.profile_backward(fn, pack, fields, loss,
                                        f"shade_grad A/B {who} bunny")
    f = dparams.loss_fn(fn, pack, target)
    params = dparams.get_params(pack, fields)
    wrong = pack.mat_c0.clone()
    wrong[0] = torch.tensor([0.9, 0.1, 0.7], device=dev)
    with torch.no_grad():
        fit_target = fn(pack)
    world = multihost.initialize(f"localhost:{chip_smoke.free_port()}", 1, 0,
                                 device=dev,
                                 timeout=chip_smoke.RANK_TIMEOUT)
    assert world == 1
    mesh = pmesh.make_mesh(device=dev)
    got, steps = {}, {"this": [], "other": []}
    try:
        for who in ORDER:
            with _grad_build(libs[who]):
                walls = {}
                vg = dparams.compile_value_and_grad(f)
                for name, call in (("eager", lambda: dparams.value_and_grad(
                        f, params)), ("graphed", lambda: vg(params))):
                    w = []
                    for _ in range(6):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        val, g = call()
                        torch.cuda.synchronize()
                        w.append((time.perf_counter() - t0) * 1e3)
                    walls[name] = float(np.median(w[1:]))
                    got.setdefault(who, g)
                vg.release()
                for graph in (True, False):
                    with chip_smoke.timed_fit({}) as t:
                        dparams.fit(fn, pack._replace(mat_c0=wrong),
                                    fit_target, fields=("mat_c0",), steps=6,
                                    lr=chip_smoke.FIT_LR,
                                    graph=None if graph else False)
                    ms = [(b - a) * 1e3 for a, b in zip(t["marks"],
                                                          t["marks"][1:])]
                    walls["fit graphed" if graph else "fit eager"] = float(
                        np.median(ms[int(graph):]))
                train, _ = chip_smoke.train_steps(
                    scene, mesh, dev, res, (True, True, True, True, False,
                                            False, False))
                walls["train graphed"] = float(np.median(
                    train["graphed"]["ms"][1:]))
                walls["train eager"] = float(np.median(
                    train["eager"]["ms"][1:]))
                steps[who].append(walls)
        worst = _grads_close("bunny value_and_grad", got["this"],
                             got["other"])
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for key in steps["this"][0]:
        print(f"shade_grad A/B bunny {res}^2 1 spp depth 5 {key} ms a step "
              f"(median; order other, this, this, other): other "
              f"{steps['other'][0][key]:.2f} / {steps['other'][1][key]:.2f}, "
              f"this {steps['this'][0][key]:.2f} / "
              f"{steps['this'][1][key]:.2f} [{smi}]", flush=True)
    print(f"shade_grad A/B bunny value_and_grad: the builds' gradients within "
          f"{worst:.2e} of their largest |gradient|", flush=True)


# name: (wrapper module, its cases, per-lane SASS of a build or None,
# the frame that goes through it, (label, scene, res, spp), or None)
LIB_AB = {
    "threefry": (rng, threefry_cases, lambda lib: chip_smoke.sass_line(
        chip_smoke.threefry_sass(lib, 8)),
        lambda dev: ("bunny", bunny_scene().to(dev), 1024, 4)),
    "sweep_prims": (sweep_prims, prims_cases, None, None),
    "brute": (brute_ops, brute_cases, None,
              lambda dev: ("Cornell", cornell_box().to(dev), 512, 16))}


def lib_main(name, path) -> int:
    module, cases, sass, frame = LIB_AB[name]
    dev = _card()
    libs = {"this": module._library(),
            "other": cuda_build.load_library(f"{name}_other", [path],
                                             module._declare)}
    print(f"other kernel: {path}", flush=True)
    for who, built in (("other", f"{name}_other"), ("this", name)):
        for line in cuda_build.BUILD_LOG.get(built, (0, ""))[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"{who} build: {line.strip()}", flush=True)
    for label, call, want, names, reps in cases(dev):
        outs = [want]
        for who in ORDER[:2]:
            with _using(module, libs[who]):
                outs.append(call())
        _held_equal(label, outs)
        if reps:
            print(f"{name} A/B {label} (order other, this, this, other): "
                  + _turns_line(_turns(module, libs, call, names, reps))
                  + "; outputs equal to the plain version bit for bit",
                  flush=True)
        else:
            print(f"{name} A/B {label}: both builds equal the plain version "
                  "bit for bit", flush=True)
    if sass:
        for who, lib in (("other", cuda_build.library_path(
                f"{name}_other", [path])), ("this", name)):
            print(f"{name} A/B {who} SASS per lane (ALU-pipe / "
                  f"FMA-heavy-pipe / all) at S = 8: {sass(lib)}", flush=True)
    if frame:
        _frames(module, libs, dev, *frame(dev))
    return 0


def main(argv) -> int:
    if argv[:2] == ["--lib", "shade_grad"] and len(argv) == 3:
        args, run = argv[2:], shade_grad_main
    elif argv[:1] == ["--lib"] and len(argv) == 3 and argv[1] in LIB_AB:
        name, args = argv[1], argv[2:]
        run = lambda path: lib_main(name, path)
    else:
        wide = argv[:1] == ["--wide"]
        args, run = (argv[1:], wide_main) if wide else (argv, sweep_main)
    if len(args) != 1 or not os.path.isfile(args[0]):
        raise SystemExit(__doc__)
    return run(os.path.abspath(args[0]))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
