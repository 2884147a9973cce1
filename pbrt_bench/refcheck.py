"""What the plain reference computes for a cell's check: the sampled
pixels of each view a frame cell rendered, and the first steps of a fit;
and the fit's target, an input that the benchmark makes itself and hands
to both sides; each with the estimator that the configuration's render
block states (traffic.estimator: mis, nee). It imports the reference
alone, never the program; `dtype` bfloat16 gives the control that
`correct` must fail."""
from __future__ import annotations

import numpy as np
import torch

from . import traffic as traffic_mod
from .reference import render as ref_render
from .reference import scene as ref_scene


def _camera(layout, lookfrom, front, width, height, device, dtype):
    return ref_render.make_camera(lookfrom, front, layout.vup, layout.vfov,
                                  (width, height), device, dtype)


def frame_pixels(config: dict, layout, views: list, wanted, pixels, spp: int,
                 seed: int, width: int, height: int, device,
                 dtype=torch.float32) -> dict:
    """view -> [P, 3] float32: render()'s value of the pixel ids [P] of each
    wanted view ((lookfrom, front) per view)."""
    rs = ref_scene.RefScene(layout, device, dtype)
    depth = int(config["render"]["max_depth"])
    out = {}
    with torch.no_grad():
        for v in sorted(set(wanted)):
            cam = _camera(layout, *views[v], width, height, device, dtype)
            out[v] = ref_render.pixels(rs, cam, width, seed,
                                       pixels.to(device), spp, depth,
                                       **traffic_mod.estimator(config))
    return out


FIT_FAULTS = ("half_batch", "altered", "unchanged")


def _fit_camera(layout, width, height, device, dtype):
    front = tuple(np.asarray(layout.lookat, np.float64)
                  - np.asarray(layout.lookfrom, np.float64))
    return _camera(layout, layout.lookfrom, front, width, height, device,
                   dtype)


def fit_target(config: dict, layout, traffic: dict, seed: int, width: int,
               height: int, device) -> torch.Tensor:
    """The fit's target [H, W, 3] float32, the photograph that the fit
    matches: the reference's render, with "target_spp" samples and no
    clamp, of the scene with each row and channel of the traffic's fields
    scaled by a factor drawn from the seed. The benchmark hands the same
    tensor to the program and to the reference's steps."""
    rs = ref_scene.RefScene(layout, device)
    fields = tuple(traffic["fields"])
    cam = _fit_camera(layout, width, height, device, torch.float32)
    factors = traffic_mod.target_factors(rs, fields, traffic, seed)
    target_scene = rs.with_params(**{
        f: getattr(rs, f) * factors[f].to(device) for f in fields})
    with torch.no_grad():
        return ref_render.pixels(
            target_scene, cam, width,
            traffic_mod.sub_seed(seed, "target") & 0xFFFFFFFF,
            torch.arange(width * height, device=device),
            int(traffic["target_spp"]), int(config["render"]["max_depth"]),
            clamp=False, **traffic_mod.estimator(config)
        ).view(height, width, 3)


def fit_record(config: dict, layout, traffic: dict, seed: int, width: int,
               height: int, target: torch.Tensor, device,
               dtype=torch.float32, steps: int = 3,
               fault: str | None = None) -> dict:
    """The reference's first steps of the fit against `target` (from
    fit_target): each loss, the first gradients, the parameters before and
    after. fault, one of FIT_FAULTS, plants a fault in the reference put in
    the program's place: the loss over the top half of the rows alone (the
    mean taken there), the last field's gradient 10% high, or a step that
    leaves the parameters as they were."""
    rs = ref_scene.RefScene(layout, device, dtype)
    depth = int(config["render"]["max_depth"])
    fields = tuple(traffic["fields"])
    lr = float(traffic["lr"])
    cam = _fit_camera(layout, width, height, device, dtype)
    target = target.to(device).to(dtype)
    fn = ref_render.image_fn(rs, cam, width, height, int(traffic["spp"]),
                             int(seed), depth, **traffic_mod.estimator(config))
    params = {f: getattr(rs, f).detach().clone() for f in fields}
    rec = {"p0": {k: v.float().clone() for k, v in params.items()},
           "losses": [], "grad1": None, "p3": None}
    for i in range(steps):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        img = fn(rs.with_params(**leaves))
        rows = height // 2 if fault == "half_batch" else height
        loss = torch.mean((img[:rows] - target[:rows]) ** 2)
        grads = torch.autograd.grad(loss, tuple(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        if fault == "altered":
            grads[fields[-1]] = grads[fields[-1]] * 1.1
        rec["losses"].append(loss.detach().float())
        if i == 0:
            rec["grad1"] = {k: g.detach().float() for k, g in grads.items()}
        if fault != "unchanged":
            params = {k: torch.clamp_min(params[k] - lr * grads[k], 0.0)
                      for k in params}
        del img, loss, grads, leaves
    rec["p3"] = {k: v.float() for k, v in params.items()}
    return rec
