#!/usr/bin/env python3
"""Two builds of a kernel on one card, in turns:

    python3 sweep_ab.py OTHER.cu                   # the cull-sweep kernel (K2)
    python3 sweep_ab.py --wide OTHER.cu            # the wide-BVH kernel (K1)
    python3 sweep_ab.py --lib threefry OTHER.cu    # the random streams' kernel
    python3 sweep_ab.py --lib sweep_prims OTHER.cu # the sweep primitives (K3)
    python3 sweep_ab.py --lib brute OTHER.cu       # the brute-force casts
    python3 sweep_ab.py --lib shade_grad OTHER.cu  # the vertex's backward
    python3 sweep_ab.py --lib wave OTHER.cu        # the wave's glue

OTHER.cu is another version of the kernel's source, for example an earlier
commit's, written into a directory that .gitignore lists:

    git show <commit>:jet_pbrt_tpu_torch/csrc/sweep_bvh.cu > _ab/other.cu
    git show 9f3021c:jet_pbrt_tpu_torch/csrc/brute.cu > _ab/brute_old.cu
    git show b0b088d:jet_pbrt_tpu_torch/csrc/wave.cu > _ab/wave_old.cu

A source that includes a header takes the one beside it, so an earlier
commit's shade_grad.cu goes into a directory of its own with that
commit's shade.cuh (and a sweep_bvh.cu or wide_bvh.cu that includes
tri_mt.cuh with that commit's tri_mt.cuh):

    mkdir -p _ab/old
    cd _ab/old
    git show <commit>:jet_pbrt_tpu_torch/csrc/shade_grad.cu > shade_grad.cu
    git show <commit>:jet_pbrt_tpu_torch/csrc/shade.cuh > shade.cuh

OTHER.cu has the C entry points of this checkout's source, and each turn
runs the port's own wrapper with the other build put in its library's
place (ops/kernels.py's substitute), so both builds take the same calls.

Each kernel is timed in the order other, this, this, other (CUDA events).
Prints the card's name and power limit first. Needs one GPU.

Sweep: on chip_smoke's 2^20-ray wave (wave_rays(scene, 1024, 11)) of the
600k-target instanced bunny and of the 150k x4 soup, 5 launches per turn:
closest hit and any hit (tmax 10% short of the closest hit) on each; then
the benchmark cell's own casts, the 16 sweep casts of one eager 1-spp
1024^2 wave of the instanced bunny (seed 3), through each build in turns
(chip_smoke.sweep_split: per class the culls, groups listed, popped and
tested a cull, thread 0's cull / scan cycles, the summed event time); then
the instanced bunny's 1024^2, 4-spp, depth-5 frame through each (host wall
ending in a synchronize). The two kernels' outputs, and the two frames,
must be equal bit for bit; so must each case's counters of culls, groups
tested, rays past the root and ray-group tests (the same work in the same
order). Each build's counters are read at its own width, the STATS_COLS
of its source (8 before the lists' two counters).

Wide: on the default bunny, 10 launches per turn: chip_smoke's 2^20-ray
wave and its 2^20-ray targeted set, closest hit and any hit (tmax 10%
short of the closest hit), then the 16 wide casts of one 1-spp wave as
chip_smoke records them (5 launches of each per turn, summed over the
casts, with the host's enqueue time, its slowest call, and what could
stall the host during the event-timed calls: chip_smoke.host_stalls); then
the 1024^2, 4-spp, depth-5 frame through each. After the turns each
build's device time per call is read by the profiler
(chip_smoke.profiled_ms, 10 calls; each device operation by name: kernels
and memsets). The other build must give outputs and frames equal bit for
bit, and its counters and this kernel's are printed (visits, SIMD
efficiency, lane-0 cycle split).

--lib NAME: the library NAME of ops/kernels.py (LIB_AB). Each case's
output of both builds is held equal to the plain version's bit for bit,
and the timed cases run 20 or 100 calls per turn (chip_smoke.kernel_times:
events, host enqueue, and the profiler's device time, also after an L2
flush by a write and by a read before each call). threefry, at
chip_smoke's 2^20 lanes (rng_phase's keys): a lane_keys call and a
uniforms call at S = 2, 6, 8, 10 and 13 (the camera, 1-3 lights, and a
width of the generic instantiation); each build's SASS per lane at S = 8
(ALU-pipe, FMA-heavy-pipe, all; chip_smoke.threefry_sass) beside the
function's bound; then the default bunny's 1024^2, 4-spp, depth-5 frame
through each build (frames equal bit for bit) and each build's profiled
1-spp wave (chip_smoke.profile_wave, the Threefry share of device time).
sweep_prims: chip_smoke.prims' six inputs held equal, the harness's inputs
timed. brute: the Cornell box's bounce-1 closest cast and its first shadow
cast of a 1024^2 wave (2^20 lanes, as chip_smoke.time_brute records them)
and the many-shapes scene's 256^2 wave rays (more than one tile of each
kind), closest hit and any hit (tmax 10% short of the closest hit), each
against both bounds (chip_smoke.brute_bounds: one issued instruction per
operation, and F32_PEAK); then the Cornell 512^2, 16-spp, depth-5 frame
through each build (frames equal bit for bit) and each build's profiled
1024^2 1-spp Cornell wave. wave: the permute's backward
(permute_state_backward) on the bunny's first sort of a 1024^2 gradient
wave at 2^20 lanes with seeded gL and gbeta, gL alone and gbeta alone,
each output's words equal to the plain version's, beside the bound and the
PyTorch yardsticks (index_copy_ of the gradients packed as [N, 6], and
torch.cat with it); then the bunny's 1024^2, 4-spp frame and each build's
profiled wave, the bunny loss's steps as for shade_grad (gradients equal
bit for bit), and phase 2g's time_grads in turns. Each build's ptxas
registers, shared memory and spills per kernel are printed where this
process built it.

shade_grad: ops/shade.py's vertex_backward and grad_reduce run on each
build in turns. Both builds' ptxas lines per kernel first. On the bunny's
and the Cornell box's 1024^2 1-spp gradient waves
(chip_smoke.grad_wave_calls, every appearance field on the tape), for two
requests, every field and the fit's mat_c0 and light_c
(SHADE_GRAD_REQUESTS): the bounce-1 vertex's backward at 2^20 lanes with
seeded upstream gradients, d loss / d beta equal bit for bit between the
builds and each requested field within chip_smoke.GRAD_FIELD_TOL of its
largest |gradient|; its vertex_backward call timed per turn (events over
20 calls, host enqueue, and the device time by events behind a held
stream, warm and after an L2 flush each: shade_grad_times); every vertex
of the wave's backward (vertex_grads of the six, both kernels) per turn;
and once, the full request's grad_reduce on that build's partials and
torch.sum(partials, 0) on the same. Then the bunny's loss mean((img -
target)^2) over mat_c0 and light_c at 1024^2, 1 spp, depth 5
(chip_smoke.diff_phase's): each build's profiled backward
(chip_smoke.profile_backward: every device operation), and in turns the
eager and the graphed value_and_grad (the graph captured anew under each
build; medians of 5 calls after a warm-up), a 6-step fit graphed and eager
(median ms a step) and the (1, 1) train step of chip_smoke's phase 12
(train_steps over a one-rank NCCL world), graphed and eager; each turn's
gradient against the other build's within GRAD_FIELD_TOL.

Frames replay their waves from CUDA graphs (models/graph.py), and a graph
keeps the kernels it captured: each turn empties the graph cache and
renders the frame once under its build with graph=True (the capture,
untimed) before the timed frame, and each build's profiled wave is
captured under it.
"""
from __future__ import annotations

import contextlib
import os
import re
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke
from jet_pbrt_tpu_torch.diff import params as dparams
from jet_pbrt_tpu_torch.models import graph as graph_mod
from jet_pbrt_tpu_torch.models.render import render, render_fn
from jet_pbrt_tpu_torch.ops import brute as brute_ops
from jet_pbrt_tpu_torch.ops import intersect as isect_ops
from jet_pbrt_tpu_torch.ops import kernels, rng, sweep_bvh, wide_bvh
from jet_pbrt_tpu_torch.ops import shade as shade_ops
from jet_pbrt_tpu_torch.ops import wave as wave_ops
from jet_pbrt_tpu_torch.parallel import mesh as pmesh
from jet_pbrt_tpu_torch.parallel import multihost
from jet_pbrt_tpu_torch.scene import pack as scene_pack
from jet_pbrt_tpu_torch.scene.scenes import bunny_scene, cornell_box
from jet_pbrt_tpu_torch.scripts import sweep_prims
from jet_pbrt_tpu_torch.utils import cuda_build

ORDER = ("other", "this", "this", "other")


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _card():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    print(_smi(), flush=True)
    return torch.device("cuda")


def _stats_cols(path) -> int:
    """The counters a packet that the sweep source at path writes: its
    STATS_COLS."""
    with open(path) as f:
        return int(re.search(r"constexpr int STATS_COLS = (\d+);",
                             f.read()).group(1))


def sweep_main(path) -> int:
    dev = _card()
    library = kernels.LIBRARIES["sweep_bvh"]
    libs = {"this": library.load(),
            "other": sweep_bvh.load_kernel(path, "sweep_bvh_other")}
    cols = {"this": sweep_bvh.STATS_COLS, "other": _stats_cols(path)}
    inst = chip_smoke.build_sweep_scene(
        "bunny 600k instanced", dev,
        bunny_path=chip_smoke.dense_obj(600_000))[0]
    soup = chip_smoke.build_sweep_scene(
        "bunny 150k x4 soup", dev, bunny_path=chip_smoke.dense_obj(150_000),
        instancing=False)[0]
    for label, scene, modes in (("instanced", inst, ("closest", "any")),
                                ("soup", soup, ("closest", "any"))):
        route = chip_smoke.sweep_route(scene)
        tables = (scene.pack.inst_sweep[0] if any(scene.meta.pallas_blas)
                  else scene.pack.bvh_sweep)
        o, d, tmin, tmax = chip_smoke.wave_rays(scene, 1024, 11, dev)
        tmax_sh = chip_smoke._shadow_tmax(route, o, d, tmin, tmax)[0]
        for mode in modes:
            tm = tmax if mode == "closest" else tmax_sh
            times = {"this": [], "other": []}
            outs = {}
            cast = lambda **kw: sweep_bvh.intersect_sweep(
                tables, o, d, tmin, tm, any_hit=mode == "any",
                n_tris=route.n_tris, **kw)
            for who in ORDER:
                with kernels.substitute(library, libs[who]):
                    ms, out = chip_smoke.time_ms(cast, 5)
                times[who].append(ms)
                outs[who] = out
            same = all(torch.equal(a, b) for a, b in zip(outs["this"],
                                                         outs["other"]))
            if not same:
                raise AssertionError(f"{label} {mode}: the two kernels differ")
            counts = {}
            for who in ("other", "this"):
                with kernels.substitute(library, libs[who]):
                    stats = cast(with_stats=True)[1]
                counts[who] = [int(x) for x in chip_smoke.sweep_rows(
                    stats, cols[who]).sum(0)]
            print(f"sweep A/B {label} {mode} counters (culls, groups tested, "
                  "rays past the root, ray-group tests, cull and scan "
                  "cycles, (ray, super) passes, group sphere tests[, groups "
                  f"listed, popped]): other {counts['other']}, this "
                  f"{counts['this']}", flush=True)
            if counts["this"][:4] != counts["other"][:4]:
                raise AssertionError(f"{label} {mode}: the two kernels' "
                                     "work counters differ")
            print(f"sweep A/B {label} {mode} at {o.shape[0]} rays (order "
                  f"other, this, this, other): other "
                  f"{times['other'][0]:.4f} / {times['other'][1]:.4f} ms, "
                  f"this {times['this'][0]:.4f} / {times['this'][1]:.4f} ms; "
                  "outputs equal bit for bit", flush=True)
    del soup

    cell = chip_smoke.recorded_casts(sweep_bvh, "intersect_sweep", inst, dev,
                                     seed=3)
    splits = {}
    for who in ORDER:  # every turn prints; each build's first is kept
        with kernels.substitute(library, libs[who]):
            split = chip_smoke.sweep_split(cell, cols[who], f" ({who})")
        splits.setdefault(who, split)
    for cls, acc in splits["this"].items():
        other = splits["other"][cls]
        if not all(torch.equal(x, y) for a, b in zip(acc["hits"],
                                                     other["hits"])
                   for x, y in zip(a, b)):
            raise AssertionError(f"the wave's {cls} casts: the two kernels "
                                 "differ")
        if not torch.equal(acc["counts"][:4], other["counts"][:4]):
            raise AssertionError(f"the wave's {cls} casts: the two kernels' "
                                 "work counters differ")
    print(f"sweep A/B: the wave's {len(cell)} casts equal between the "
          "builds bit for bit, and their work counters too", flush=True)
    del cell

    imgs, walls = {}, {"this": [], "other": []}
    render(inst, 64, 64, spp=1, max_depth=5, device=dev)  # warm-up
    for who in ORDER:
        with kernels.substitute(library, libs[who]):
            _captured_frame(inst, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(inst, 1024, 1024, spp=4, max_depth=5, seed=0,
                         clamp=False, device=dev)
            torch.cuda.synchronize()
            walls[who].append(time.perf_counter() - t0)
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

WIDE = kernels.LIBRARIES["wide_bvh"]


def wide_call(lib, tables, o, d, tmin, tmax, **kw):
    """One cast through intersect_wide on build lib -> KindHit (and its
    counters where kw has with_stats)."""
    with kernels.substitute(WIDE, lib):
        return wide_bvh.intersect_wide(tables, o, d, tmin, tmax, **kw)


def _wide_stats(lib, tables, rays, kw):
    _, stats = wide_call(lib, tables, *rays, with_stats=True, **kw)
    return wide_bvh.stats_summary(stats, kw["leaf_size"])


def _device(lib, call) -> tuple[float, str]:
    """(device ms per call, its split by operation) of call(lib)."""
    parts = {k: v for k, v in chip_smoke.profiled_ms(
        lambda: call(lib), 10, chip_smoke.WIDE_OPS, each=()).items() if v}
    return sum(parts.values()), ", ".join(f"{k} {v:.4f}"
                                          for k, v in parts.items())


def _held(label, out_this, out_other):
    if not all(torch.equal(a, b) for a, b in zip(out_this, out_other)):
        raise AssertionError(f"{label}: the other build's output differs")


def wide_main(path) -> int:
    dev = _card()
    libs = {"this": WIDE.load(),
            "other": wide_bvh.load_kernel(path, "wide_bvh_other")}
    print(f"other kernel: {path}", flush=True)
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
            _held(f"{label} {mode}", outs["this"], outs["other"])
            dev_ms = {who: _device(libs[who], call) for who in ORDER[:2]}
            print(f"wide A/B {label} {mode} at {o.shape[0]} rays (order other, "
                  f"this, this, other): other {times['other'][0]:.4f} / "
                  f"{times['other'][1]:.4f} ms, this {times['this'][0]:.4f} / "
                  f"{times['this'][1]:.4f} ms by events; device time other "
                  f"{dev_ms['other'][0]:.4f} ms ({dev_ms['other'][1]}), this "
                  f"{dev_ms['this'][0]:.4f} ms ({dev_ms['this'][1]}); "
                  "outputs equal bit for bit", flush=True)
            for who in ("other", "this"):
                st = _wide_stats(libs[who], tables, rays, kw)
                print(f"  {who} counters: node visits {st['node_visits']}, "
                      f"triangle tests {st['tri_tests']}, "
                      + chip_smoke.counters_line(st), flush=True)
        del o, d, tmin, tmax, tmax_sh

    casts = chip_smoke.recorded_casts(wide_bvh, "intersect_wide", bunny, dev)
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
        _held(f"cast {j}", wide_call(libs["this"], tb, o, d, tmin, tmax, **kw),
              wide_call(libs["other"], tb, o, d, tmin, tmax, **kw))
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

    imgs, walls = {}, {"this": [], "other": []}
    render(bunny, 64, 64, spp=1, max_depth=5, device=dev)  # warm-up
    for who in ORDER:
        with kernels.substitute(WIDE, libs[who]):
            _captured_frame(bunny, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(bunny, 1024, 1024, spp=4, max_depth=5, seed=0,
                         clamp=False, device=dev)
            torch.cuda.synchronize()
            walls[who].append(time.perf_counter() - t0)
        imgs.setdefault(who, img)
    diff = (imgs["this"] - imgs["other"]).abs()
    if float(diff.max()) != 0.0:
        raise AssertionError("the other build renders a different frame")
    print(f"wide A/B frame 1024^2 spp 4 depth 5 (order other, this, this, "
          f"other): other {walls['other'][0]:.3f} / {walls['other'][1]:.3f} "
          f"s, this {walls['this'][0]:.3f} / {walls['this'][1]:.3f} s; "
          f"frames: {int((diff.amax(-1) > 0).sum())} pixels differ, largest "
          f"difference {float(diff.max()):.6g}", flush=True)
    return 0


# --------------------------------------------------------------------------
# --lib: a library of ops/kernels.py, its build swapped per turn
# --------------------------------------------------------------------------

def _turns(library, libs, call, names, reps, flush):
    """{who: [kernel_times of each turn]} of call() with library's wrappers
    on each build, in ORDER, each also with the profiler's device time
    after an L2 flush before each call (flush, a tensor larger than L2):
    by a write (flush.fill_(0), which leaves L2 full of dirty lines) and
    by a read (flush.sum(), which leaves it clean). The flush's own
    kernels are not among names."""
    times = {"this": [], "other": []}
    for who in ORDER:
        with kernels.substitute(library, libs[who]):
            t = chip_smoke.kernel_times(call, names, reps)
            for key, fill in (("device_cold_ms", lambda: flush.fill_(0)),
                              ("device_read_cold_ms", flush.sum)):
                t[key] = sum(chip_smoke.profiled_ms(
                    lambda: (fill(), call()), reps, names).values())
            times[who].append(t)
    return times


def _turns_line(times) -> str:
    turn = lambda t: (f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, "
                      f"after an L2 flush {t['device_cold_ms']:.4f}, by a "
                      f"read {t['device_read_cold_ms']:.4f}, enqueue "
                      f"{t['enqueue_ms']:.4f})")
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


def wave_cases(dev):
    """--lib wave: the permute's backward on the bunny's first sort of a
    1024^2 gradient wave (2^20 lanes, chip_smoke.grad_wave_calls), with
    seeded gL and gbeta (chip_smoke.seeded_grads, as time_grads), gL
    alone and gbeta alone; each output as its words (a None gradient's
    output all zeros). Prints the PyTorch yardsticks on the same inputs
    first: index_copy_ of the two gradients packed as [N, 6], and
    torch.cat of autograd's two [N, 3] tensors with that index_copy_."""
    calls = chip_smoke.grad_wave_calls("bunny", bunny_scene().to(dev), 1024,
                                       dev)
    perm = next(a for k, a in calls if k == "permute")
    del calls
    n = perm.shape[0]
    gL, gbeta = chip_smoke.seeded_grads(n, 7, dev, False)
    packed = torch.cat([gL, gbeta], 1)
    into = torch.empty_like(packed)
    for label, fn in (("index_copy_ [N, 6]",
                       lambda: into.index_copy_(0, perm, packed)),
                      ("torch.cat + index_copy_",
                       lambda: into.index_copy_(0, perm,
                                                torch.cat([gL, gbeta], 1)))):
        ms = chip_smoke.time_ms(fn, 20)[0]
        (_, device), = chip_smoke.profiled_ms(fn, 20, ("",)).items()
        print(f"wave A/B yardstick {label} at {n} lanes: {ms:.4f} ms by "
              f"events, {device:.4f} ms device", flush=True)
    zero = torch.zeros((n, 3), device=dev)
    words = lambda out: tuple((zero if x is None else x).view(torch.int32)
                              for x in out)
    cases = []
    for label, a, b in (("gL and gbeta", gL, gbeta), ("gL alone", gL, None),
                        ("gbeta alone", None, gbeta)):
        # perm and the given gradients read once, both outputs written once
        nbytes = sum(x.numel() * x.element_size() for x in (perm, a, b)
                     if x is not None) + 2 * n * 12
        ms, by = chip_smoke.bound(nbytes, 0)
        cases.append((
            f"permute_state_backward, {label}, the bunny's first sort "
            f"({n} lanes; bound {ms:.6f} ms by {by}, {nbytes} B)",
            lambda a=a, b=b: words(wave_ops.permute_state_backward(perm, a,
                                                                   b)),
            words(wave_ops.permute_state_backward_plain(perm, a, b)),
            ("permute_state_backward_kernel",), 20))
    return cases


def _wave_steps(library, libs, dev, res: int = 1024) -> None:
    """The bunny loss's steps through each build (_bunny_steps), their
    gradients equal bit for bit; then phase 2g's timing of the backward
    kernels (chip_smoke.time_grads) on a recorded gradient wave under each
    build in turns."""
    using = lambda lib: kernels.substitute(library, lib)
    scene, got = _bunny_steps("wave", using, libs, dev, res)
    for k in got["this"]:
        if not torch.equal(got["this"][k], got["other"][k]):
            raise AssertionError(f"wave A/B: the builds' d loss / d {k} "
                                 "differ")
    print("wave A/B bunny value_and_grad: the builds' gradients equal bit "
          "for bit", flush=True)
    calls = chip_smoke.grad_wave_calls("bunny", scene, res, dev)
    smi = _smi()
    for who in ORDER:
        with using(libs[who]):
            chip_smoke.time_grads(f"wave A/B {who} bunny", calls, smi)


def _frames(library, libs, dev, label, scene, res, spp):
    """The scene's res^2, spp frame through each build, equal bit for
    bit, then each build's profiled 1024^2 1-spp wave."""
    imgs, walls = {}, {"this": [], "other": []}
    render(scene, 64, 64, spp=1, max_depth=5, device=dev)  # warm-up
    for who in ORDER:
        with kernels.substitute(library, libs[who]):
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
        with kernels.substitute(library, libs[who]):
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

GRAD = kernels.LIBRARIES["shade_grad"]


@contextlib.contextmanager
def _grad_build(lib):
    """While open, ops/shade.py's backward runs on lib and no graph
    captured under another build is replayed."""
    graph_mod.clear()
    try:
        with kernels.substitute(GRAD, lib):
            yield
    finally:
        graph_mod.clear()


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


# name: the fields a request differentiates
SHADE_GRAD_REQUESTS = {"every field": shade_ops.GRAD_FIELDS,
                       "mat_c0, light_c": ("mat_c0", "light_c")}


def shade_grad_main(path) -> int:
    dev = _card()
    # both builds at once: each takes minutes
    cuda_build.build_libraries([("shade_grad", ["shade_grad.cu"]),
                                ("shade_grad_other", [path])])
    libs = {"this": GRAD.load(),
            "other": GRAD.build([path], "shade_grad_other")}
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
        rec, grads = vertices[1], seeded[1]
        meta, pack, hit, state, u, bounce, depth, lights, occ = rec
        for request, fields in SHADE_GRAD_REQUESTS.items():
            run = lambda r, g: shade_ops.vertex_grads(
                *r[:3], chip_smoke.kernel_state(r[3]), *r[4:], *g,
                fields=fields)
            outs = {}
            for who in ORDER[:2]:
                with _grad_build(libs[who]):
                    gl, gb, g, ge = run(rec, grads)
                    outs[who] = (gb, {**g, "le_env": ge})
            if not torch.equal(outs["this"][0], outs["other"][0]):
                raise AssertionError(f"{label} {request}: the builds' d loss "
                                     "/ d beta differ")
            worst = _grads_close(f"{label} {request}", outs["this"][1],
                                 outs["other"][1])
            same = all(torch.equal(outs["this"][1][k], outs["other"][1][k])
                       for k in outs["other"][1])
            kernel = lambda: shade_ops.vertex_backward(
                meta, pack, hit, chip_smoke.kernel_state(state), u, bounce,
                depth, lights, occ, *grads,
                params=shade_ops.requested_params(fields))
            times = {"this": [], "other": []}
            wave_times = {"this": [], "other": []}
            for who in ORDER:
                with _grad_build(libs[who]):
                    times[who].append(shade_grad_times(kernel, flush))
                    wave_times[who].append(chip_smoke.queued_events_ms(
                        lambda: [run(r, g) for r, g in zip(vertices, seeded)],
                        5))
            print(_line(f"{label} bounce-1 vertex_backward "
                        f"({state.L.shape[0]} lanes), {request}", times)
                  + "; d loss / d beta equal bit for bit, fields "
                  + ("equal bit for bit" if same else
                     f"within {worst:.2e} of their largest |gradient|"),
                  flush=True)
            print(f"shade_grad A/B {label} the wave's {len(vertices)} "
                  f"vertices' backward, {request} (vertex_backward and "
                  f"grad_reduce, device ms by events behind a held stream; "
                  f"order other, this, this, other): other "
                  f"{wave_times['other'][0]:.4f} / "
                  f"{wave_times['other'][1]:.4f}, this "
                  f"{wave_times['this'][0]:.4f} / "
                  f"{wave_times['this'][1]:.4f}", flush=True)
        kernel = lambda: shade_ops.vertex_backward(
            meta, pack, hit, chip_smoke.kernel_state(state), u, bounce,
            depth, lights, occ, *grads)
        reduce_times = {"this": [], "other": []}
        for who in ORDER:
            with _grad_build(libs[who]):
                partials = kernel()[1]
                reduce_times[who].append(shade_grad_times(
                    lambda: shade_ops.grad_reduce(partials), flush))
        partials = kernel()[1]
        lib_ms = shade_grad_times(lambda: torch.sum(partials, 0), flush)
        print(_line(f"{label} grad_reduce (each build's partials)",
                    reduce_times) + f"; torch.sum(partials, 0) on this "
              f"build's {list(partials.shape)}: {lib_ms['device_ms']:.4f} "
              "ms device", flush=True)
        del calls, vertices, rec, partials
    _, got = _bunny_steps("shade_grad", _grad_build, libs, dev)
    worst = _grads_close("bunny value_and_grad", got["this"], got["other"])
    print(f"shade_grad A/B bunny value_and_grad: the builds' gradients within "
          f"{worst:.2e} of their largest |gradient|", flush=True)
    return 0


def _bunny_steps(name, using, libs, dev, res: int = 1024):
    """The bunny loss mean((img - target)^2) over mat_c0 and light_c at
    res^2, 1 spp, depth 5, its target the image under light_c x 1.2:
    each build's profiled backward (chip_smoke.profile_backward), then in
    turns eager and graphed value_and_grad, a fit and the (1, 1) train
    step (medians after a warm-up). using(lib) swaps a build in. Returns
    the scene and each build's value_and_grad gradients."""
    scene = bunny_scene().to(dev)
    fn, pack = render_fn(scene, res, res, spp=1, seed=0, max_depth=5,
                         device=dev)
    with torch.no_grad():
        target = fn(dparams.with_params(pack,
                                        {"light_c": pack.light_c * 1.2}))
    loss = lambda img: torch.mean((img - target) ** 2)
    fields = ("mat_c0", "light_c")
    for who in ORDER[:2]:
        with using(libs[who]):
            chip_smoke.profile_backward(fn, pack, fields, loss,
                                        f"{name} A/B {who} bunny")
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
            with using(libs[who]):
                walls = {}
                vg = dparams.compile_value_and_grad(f)
                for mode, call in (("eager", lambda: dparams.value_and_grad(
                        f, params)), ("graphed", lambda: vg(params))):
                    w = []
                    for _ in range(6):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        val, g = call()
                        torch.cuda.synchronize()
                        w.append((time.perf_counter() - t0) * 1e3)
                    walls[mode] = float(np.median(w[1:]))
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
    finally:
        dist.destroy_process_group()
    smi = _smi()
    for key in steps["this"][0]:
        print(f"{name} A/B bunny {res}^2 1 spp depth 5 {key} ms a step "
              f"(median; order other, this, this, other): other "
              f"{steps['other'][0][key]:.2f} / {steps['other'][1][key]:.2f}, "
              f"this {steps['this'][0][key]:.2f} / "
              f"{steps['this'][1][key]:.2f} [{smi}]", flush=True)
    return scene, got


class LibAB(NamedTuple):
    """A --lib entry of a library of ops/kernels.py: cases(dev) ->
    [(label, call, plain output, kernel names, reps)], a build's per-lane
    SASS line or None, frame(dev) -> (label, scene, res, spp) of the frame
    through each build or None, and steps(library, libs, dev) run after it
    or None."""
    cases: Callable
    sass: Callable | None = None
    frame: Callable | None = None
    steps: Callable | None = None


LIB_AB = {
    "threefry": LibAB(threefry_cases, lambda lib: chip_smoke.sass_line(
        chip_smoke.threefry_sass(lib, 8)),
        lambda dev: ("bunny", bunny_scene().to(dev), 1024, 4)),
    "sweep_prims": LibAB(prims_cases),
    "brute": LibAB(brute_cases,
                   frame=lambda dev: ("Cornell", cornell_box().to(dev), 512,
                                      16)),
    "wave": LibAB(wave_cases,
                  frame=lambda dev: ("bunny", bunny_scene().to(dev), 1024, 4),
                  steps=_wave_steps)}


def lib_main(name, path) -> int:
    cases, sass, frame, steps = LIB_AB[name]
    library = kernels.LIBRARIES[name]
    dev = _card()
    if steps:
        # the steps run every library: all built at once with the other
        cuda_build.build_libraries(chip_smoke.LIBRARIES
                                   + (chip_smoke.COUNT_LIBRARY,
                                      (f"{name}_other", [path])))
    libs = {"this": library.load(),
            "other": library.build([path], f"{name}_other")}
    print(f"other kernel: {path}", flush=True)
    for who, built in (("other", f"{name}_other"), ("this", name)):
        _ptxas(name, cuda_build.BUILD_LOG.get(built, (0, ""))[1], who)
    flush = torch.empty((chip_smoke.L2_FLUSH_BYTES // 4,), dtype=torch.int32,
                        device=dev)
    for label, call, want, names, reps in cases(dev):
        outs = [want]
        for who in ORDER[:2]:
            with kernels.substitute(library, libs[who]):
                outs.append(call())
        _held_equal(label, outs)
        if reps:
            print(f"{name} A/B {label} (order other, this, this, other): "
                  + _turns_line(_turns(library, libs, call, names, reps,
                                       flush))
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
        _frames(library, libs, dev, *frame(dev))
    if steps:
        steps(library, libs, dev)
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
