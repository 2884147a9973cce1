"""The control that `correct` must fail: the plain reference put in the
program's place and computed in bfloat16, the precision below the float32
that the configurations state, compared with the float32 reference by the
cell's own comparison. Run on the card at the cell's own size:

    python3 pbrt_bench/control.py <cell> <seed> [<seed> ...]

prints one JSON line a seed with the numbers and the cell's limits; for a
fit cell also one line a fault of refcheck.FIT_FAULTS planted in the
float32 reference (a fault's upper reading)."""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pbrt_bench import check, core, refcheck, traffic  # noqa: E402
from pbrt_bench.reference import scene as ref_scene  # noqa: E402


def readings(cell, seed: int, device, sizes: dict | None = None,
             fault: str | None = None) -> dict:
    """The control's numbers for one seed, at the cell's sizes (sizes
    overrides them in CPU tests); for a fit cell with fault (one of
    refcheck.FIT_FAULTS), that fault's numbers instead: the float32
    reference with the fault planted, in the program's place."""
    sz = core._sizes(cell, sizes)
    w, h = sz["width"], sz["height"]
    tr = dict(cell.traffic, **{k: v for k, v in sz.items()
                               if k in ("spp", "target_spp")})
    layout = ref_scene.Layout(cell.config)
    if tr["kind"] == "fit":
        target = refcheck.fit_target(cell.config, layout, tr, seed, w, h,
                                     device)
        want = refcheck.fit_record(cell.config, layout, tr, seed, w, h,
                                   target, device)
        got = refcheck.fit_record(
            cell.config, layout, tr, seed, w, h, target, device,
            **({"fault": fault} if fault else {"dtype": torch.bfloat16}))
        return check.fit_numbers(got, want)
    n = int(sz.get("pixels_per_view", tr["check"]["pixels_per_view"]))
    views = traffic.views(cell.config, int(tr["views"]), tr["yaw_deg"])
    pixels = traffic.sample_pixels(seed, w, h, n)
    args = (cell.config, layout, views, range(len(views)), pixels,
            int(tr["spp"]), seed, w, h, device)
    want = refcheck.frame_pixels(*args)
    got = refcheck.frame_pixels(*args, dtype=torch.bfloat16)
    return {"mismatch_pct": check.mismatch_pct(
        list(got.items()), want, float(tr["check"]["tolerance"]))}


def judge_control(cell, seed: int, device, sizes: dict | None = None):
    """(whether the control passes the cell's limits, its checks)."""
    return check.judge(readings(cell, seed, device, sizes), cell.limits)


def main(argv) -> int:
    cell = core.load(argv[0])
    dev = torch.device("cuda", 0)
    faults = ((None,) + refcheck.FIT_FAULTS if cell.traffic["kind"] == "fit"
              else (None,))
    for seed in argv[1:]:
        for fault in faults:
            nums = readings(cell, int(seed), dev, fault=fault)
            ok, checks = check.judge(nums, cell.limits)
            print(json.dumps({"cell": cell.name, "seed": int(seed),
                              "planted": fault or "bfloat16",
                              "passes": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
