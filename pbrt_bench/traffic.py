"""The one general generator of the benchmark's traffic. A traffic mix is a
data file under pbrt_bench/traffic/ whose "kind" picks a loop here and
whose other keys are its parameters:

- "frames": a closed loop with one client. Frame k renders view k mod
  "views" of a turntable (lookfrom rotated about the vertical axis through
  lookat, at yaws spaced evenly over "yaw_deg") with "spp" samples a pixel,
  each frame one render() call that ends in a synchronize.
- "fit": inverse rendering. The target, an input that the benchmark makes
  itself (refcheck.fit_target), is the reference's render with
  "target_spp" samples of the scene with each row and channel of "fields"
  scaled by a factor drawn from the seed in "scale"; each step is the
  graphed value and gradient of the mean squared error of the program's
  "spp"-sample render against it, then the projected update (lr "lr",
  clamped at 0), back to back.

Both draw everything from the run's seed, so the same seed gives the same
work, and a different seed the same amount of work on other views of the
same sizes.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import program_scene


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed of its own for each purpose, from the run's seed."""
    h = np.random.SeedSequence([int(seed) & ((1 << 64) - 1),
                                sum(map(ord, purpose)) * 7919 + len(purpose)])
    return int(h.generate_state(1, np.uint64)[0] >> np.uint64(1))


def views(config: dict, n: int, yaw_deg) -> list:
    """(lookfrom, front) of n turntable views: lookfrom rotated about the
    vertical axis through lookat, at yaws spaced evenly over yaw_deg."""
    cam = config["camera"]
    at = np.asarray(cam["lookat"], np.float64)
    rel = np.asarray(cam["lookfrom"], np.float64) - at
    out = []
    for k in range(n):
        a = math.radians(yaw_deg[0] + (yaw_deg[1] - yaw_deg[0]) * k
                         / max(n - 1, 1))
        c, s = math.cos(a), math.sin(a)
        p = at + np.array([c * rel[0] + s * rel[2], rel[1],
                           -s * rel[0] + c * rel[2]])
        out.append((tuple(p), tuple(at - p)))
    return out


def sample_pixels(seed: int, width: int, height: int, n: int):
    """n distinct pixel ids drawn from the seed: the pixels the check
    reads in every frame."""
    g = torch.Generator().manual_seed(sub_seed(seed, "pixels"))
    return torch.randperm(width * height, generator=g)[:n]


def estimator(config: dict) -> dict:
    """The estimator that a configuration's render block states, as
    render()'s and the reference's keywords mis and nee (core.Cell refuses
    a block that the harness cannot honour)."""
    r = config["render"]
    return {"mis": r["mis"], "nee": r["nee"]}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Frames:
    """The frame loop of one cell: the views, the sampled pixels that the
    check reads, and each frame's result."""

    def __init__(self, scene, config: dict, traffic: dict, seed: int,
                 device, width: int, height: int, pixels: int):
        from jet_pbrt_tpu_torch.models.render import render

        self.render = render
        self.seed = int(seed)
        self.device = device
        self.width, self.height = width, height
        self.spp = int(traffic["spp"])
        self.depth = int(config["render"]["max_depth"])
        self.estimator = estimator(config)
        self.view_list = views(config, int(traffic["views"]),
                               traffic["yaw_deg"])
        self.scenes = [program_scene.with_view(scene, p, f)
                       for p, f in self.view_list]
        self.pixels = sample_pixels(seed, width, height, pixels)
        self.pixels_dev = self.pixels.to(device)
        self.kept = []      # (view, sampled pixels [P, 3]) per window frame
        self.times = []     # seconds per window frame, call to synchronize
        self.alter = None   # a fault planted by a test: fn(k, img) -> img

    def frame(self, k: int):
        with record_function("bench.render"):
            img = self.render(self.scenes[k % len(self.scenes)], self.width,
                              self.height, self.spp, seed=self.seed,
                              max_depth=self.depth, device=self.device,
                              **self.estimator)
        with record_function("bench.sync"):
            sync(self.device)
        return img

    def gather(self, img):
        with record_function("bench.gather"):
            return img.reshape(-1, 3).index_select(0, self.pixels_dev)

    def keep(self, k: int, img):
        if self.alter is not None:
            img = self.alter(k, img)
        self.kept.append((k % len(self.scenes), self.gather(img)))

    def warm_up(self, n: int):
        """n frames and their gathers, none kept: every kernel the window
        runs is loaded before it opens."""
        for k in range(n):
            self.gather(self.frame(k))
        sync(self.device)

    def window(self, seconds: float, start: int = 0) -> dict:
        """Frames back to back until `seconds` have passed; returns the
        window's counts and wall time."""
        t0 = time.perf_counter()
        k = start
        while True:
            a = time.perf_counter()
            img = self.frame(k)
            b = time.perf_counter()
            self.times.append(b - a)
            self.keep(k, img)
            k += 1
            if b - t0 >= seconds:
                break
        return {"frames": k - start, "waves": (k - start) * self.spp,
                "wall_s": b - t0}

    def count(self, n: int, start: int = 0) -> dict:
        """n frames back to back (the traced window)."""
        for k in range(start, start + n):
            a = time.perf_counter()
            img = self.frame(k)
            self.times.append(time.perf_counter() - a)
            self.keep(k, img)
        return {"frames": n, "waves": n * self.spp}


class Fit:
    """The fit loop of one cell: the target, the graphed step, and the
    first steps' record that the check compares."""

    def __init__(self, scene, config: dict, traffic: dict, seed: int,
                 device, width: int, height: int, target):
        from jet_pbrt_tpu_torch.diff import params as P
        from jet_pbrt_tpu_torch.models.render import render_fn

        self.device = device
        self.fields = tuple(traffic["fields"])
        self.lr = float(traffic["lr"])
        self.seed = int(seed)
        depth = int(config["render"]["max_depth"])
        # the program gets its own copy of the benchmark's target
        self.target = target.to(device).clone()
        # render_fn has no nee: core.Cell refuses a fit without NEE
        fn, pack_d = render_fn(scene, width, height, int(traffic["spp"]),
                               seed=self.seed, max_depth=depth, device=device,
                               mis=estimator(config)["mis"])
        self._fn, self._pack = fn, pack_d
        loss = P.loss_fn(fn, pack_d, self.target)
        if device.type == "cuda":
            self.vg = P.compile_value_and_grad(loss)
        else:
            self.vg = lambda p: P.value_and_grad(loss, p)
            self.vg.release = lambda: None
        self.params = {f: getattr(pack_d, f).detach().clone()
                       for f in self.fields}
        self.record = {"p0": {k: v.clone() for k, v in self.params.items()},
                       "losses": [], "grad1": None, "p3": None}
        self.alter = None   # a fault planted by a test: fn(i, val, g, new)
        self._events = []
        self.steps = 0

    def step(self):
        with record_function("bench.step"):
            val, g = self.vg(self.params)
        with record_function("bench.update"):
            new = {k: torch.clamp_min(self.params[k] - self.lr * g[k], 0.0)
                   for k in self.params}
        if self.alter is not None:
            val, g, new = self.alter(self.steps, val, g, new, self.params)
        self.params = new
        self.steps += 1
        return val, g

    def first_steps(self, n: int = 3):
        """The first n steps, recorded: each loss, the first step's
        gradients, the parameters after the n."""
        for i in range(n):
            val, g = self.step()
            self.record["losses"].append(val.detach().clone())
            if i == 0:
                self.record["grad1"] = {k: v.detach().clone()
                                        for k, v in g.items()}
        self.record["p3"] = {k: v.clone() for k, v in self.params.items()}

    def _paced_step(self):
        # the host stays at most two steps ahead of the card, so the host
        # clock follows the card's progress
        self.step()
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._events.append(ev)
            if len(self._events) > 2:
                self._events.pop(0).synchronize()

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._paced_step()
            n += 1
        sync(self.device)
        self._events.clear()
        return {"steps": n, "waves": n, "wall_s": time.perf_counter() - t0}

    def count(self, n: int) -> dict:
        for _ in range(n):
            self._paced_step()
        sync(self.device)
        self._events.clear()
        return {"steps": n, "waves": n}

    def release(self):
        self.vg.release()


def target_factors(pack, fields, traffic: dict, seed: int) -> dict:
    """A factor in traffic["scale"] per row and channel of each field,
    drawn from the seed on the host (float32)."""
    g = torch.Generator().manual_seed(sub_seed(seed, "factors"))
    lo, hi = traffic["scale"]
    out = {}
    for f in fields:
        shape = tuple(getattr(pack, f).shape)
        out[f] = (lo + (hi - lo) * torch.rand(shape, generator=g,
                                              dtype=torch.float64)
                  ).to(torch.float32)
    return out
