#!/usr/bin/env python3
"""Two builds of a traversal kernel on one card, in turns:

    python3 sweep_ab.py OTHER.cu           # the cull-sweep kernel (K2)
    python3 sweep_ab.py --wide OTHER.cu    # the wide-BVH kernel (K1)

OTHER.cu is another version of the kernel's source, for example an earlier
commit's, written into a directory that .gitignore lists:

    git show <commit>:jet_pbrt_tpu_torch/csrc/sweep_bvh.cu > _ab/other.cu

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
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

import chip_smoke
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import sweep_bvh, wide_bvh
from jet_pbrt_tpu_torch.ops.intersect import KindHit
from jet_pbrt_tpu_torch.scene.scenes import bunny_scene
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
              leaf_size, n_tris, stats=None):
    """One cast through lib on the current stream -> KindHit."""
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
        lambda: call(lib), 10, WIDE_OPS).items() if v}
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


def main(argv) -> int:
    wide = argv[:1] == ["--wide"]
    args = argv[1:] if wide else argv
    if len(args) != 1 or not os.path.isfile(args[0]):
        raise SystemExit(__doc__)
    path = os.path.abspath(args[0])
    return wide_main(path) if wide else sweep_main(path)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
