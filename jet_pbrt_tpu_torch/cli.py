"""Command-line renderer: `python -m jet_pbrt_tpu_torch.cli <sceneid> [spp]`.

The PyTorch counterpart of `python -m jet_pbrt_tpu.cli`, with its flags
(reference: src/main.cc:113-163, `pbrt.exe sceneid spp`). `--device
cuda|cpu` takes the place of `--platform`: it defaults to the card and
fails where there is none. The wall time and the rays/s printed are the
card's (or the CPU's where asked), taken after torch.cuda.synchronize().
"""
from __future__ import annotations

import argparse
import time

import torch

from .models.render import INTEGRATORS, SAMPLERS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="jet_pbrt_tpu_torch renderer")
    p.add_argument("sceneid", type=int, help="0 = cornell box, 1 = bunny")
    p.add_argument("spp", type=int, nargs="?", default=50,
                   help="samples per pixel (reference default 50)")
    p.add_argument("--size", type=int, default=1024,
                   help="square resolution (reference: 1024)")
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--integrator", default="path", choices=INTEGRATORS)
    p.add_argument("--sampler", default="random", choices=SAMPLERS)
    p.add_argument("--mis", action="store_true",
                   help="enable power-heuristic MIS (reference-divergent)")
    p.add_argument("--format", default="bmp", choices=["bmp", "ppm", "hdr"])
    p.add_argument("--no-clamp", action="store_true",
                   help="keep HDR output (the reference clamps to [0,1])")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render (default the card; fails where "
                        "there is none)")
    args = p.parse_args(argv)

    from .models import camera as camera_mod
    from .models import film as film_mod
    from .models import render as render_mod
    from .scene.scenes import SCENES
    from .utils.log import log_print

    if args.sceneid not in SCENES:
        log_print(f"unknown scene id {args.sceneid}")
        return 1
    if args.size <= 0 or args.spp <= 0:
        log_print("size and spp must be positive")
        return 1
    device = camera_mod.resolve_device(args.device)

    scene = SCENES[args.sceneid]()
    log_print(f"current scene: {scene.meta.name}")
    path_stats = args.integrator == "path"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    img = render_mod.render(scene, args.size, args.size, args.spp,
                            seed=args.seed, max_depth=args.max_depth,
                            integrator=args.integrator, mis=args.mis,
                            sampler=args.sampler, clamp=not args.no_clamp,
                            device=device, with_stats=path_stats)
    sync()
    dt = time.perf_counter() - t0
    if path_stats:
        img, st = img
    primary = args.size * args.size * args.spp
    line = (f"render finished on {device.type} in {dt:.3f} s: "
            f"{primary / max(dt, 1e-9):.1f} primary rays/s")
    if path_stats:
        line += (f", {st['rays'] / max(dt, 1e-9):.1f} rays/s "
                 f"({st['rays']} rays: primary {st['rays_primary']}, bounce "
                 f"{st['rays_bounce']}, shadow {st['rays_shadow']})")
    log_print(line + " (kernel builds and first-call set-up included)")
    base = args.out or f"{scene.meta.name}_{args.spp}"
    path = film_mod.save(img, base, args.format)
    log_print(f"saved {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
