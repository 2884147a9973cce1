#!/usr/bin/env python3
"""Two builds of the cull-sweep kernel on one card, in turns:

    python3 sweep_ab.py OTHER.cu

OTHER.cu is another version of jet_pbrt_tpu_torch/csrc/sweep_bvh.cu with
the same C entry point (`sweep_bvh_launch`), for example an earlier
commit's, written into a directory that .gitignore lists:

    git show <commit>:jet_pbrt_tpu_torch/csrc/sweep_bvh.cu > _ab/other.cu

On chip_smoke's 2^20-ray wave (wave_rays(scene, 1024, 11)) of the
600k-target instanced bunny and of the 150k x4 soup, it times each kernel
in the order other, this, this, other (CUDA events, 5 launches each):
closest hit and any hit (tmax 10% short of the closest hit) on the
instanced bunny, closest hit on the soup; then the instanced bunny's
1024^2, 4-spp, depth-5 frame through each (host wall ending in a
synchronize). The two kernels' outputs, and the two frames, must be equal
bit for bit. Prints the card's name and power limit first. Needs one GPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

import chip_smoke
from jet_pbrt_tpu_torch.models.render import render
from jet_pbrt_tpu_torch.ops import sweep_bvh

ORDER = ("other", "this", "this", "other")


def main(argv) -> int:
    if len(argv) != 1 or not os.path.isfile(argv[0]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    libs = {"this": sweep_bvh.load_kernel(),
            "other": sweep_bvh.load_kernel(os.path.abspath(argv[0]),
                                           "sweep_bvh_other")}
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
