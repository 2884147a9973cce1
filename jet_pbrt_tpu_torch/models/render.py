"""Render orchestration: drive waves of (sample, pixel) lanes through an
integrator and accumulate the film on the device.

PyTorch counterpart of jet_pbrt_tpu/models/render.py::render. A wave holds
whole samples of the frame (or, for frames larger than a wave, a pixel
range of one sample); every uniform is keyed by (seed, sample, pixel) alone
and the film adds each sample in float64 in sample order (models/film.py),
so the image does not depend on the wave size and equals the reference
package's for the same seed up to the rounding of libm functions. On the
card a wave shape that recurs is replayed from a CUDA graph
(models/graph.py, the counterpart of the reference's `jax.jit(wave)`);
graph=False runs it op by op, as `jax.disable_jit()` does the
reference's. Under torch.profiler a frame is a "render.frame" span
(utils/log.py::span) around "render.setup", "render.film" (the film's
zeros and each wave's adds), one "render.wave" a wave and
"render.finalize".
"""
from __future__ import annotations

import torch

from ..ops import rng
from ..ops import wave as wave_ops
from ..utils.log import span
from . import camera as camera_mod
from . import film as film_mod
from . import graph as graph_mod
from . import integrators

DEFAULT_CHUNK = 1 << 20
INTEGRATORS = ("path", "whitted", "debug")
SAMPLERS = ("random", "stratified", "debug")


def _waves(n_pixels: int, spp: int, chunk: int):
    """(first sample, n samples, first pixel, n pixels) per wave."""
    if chunk >= n_pixels:
        per = max(1, chunk // n_pixels)
        for s0 in range(0, spp, per):
            yield s0, min(per, spp - s0), 0, n_pixels
    else:
        for s in range(spp):
            for p0 in range(0, n_pixels, chunk):
                yield s, 1, p0, min(chunk, n_pixels - p0)


def n_waves(width: int, height: int, spp: int, chunk: int = DEFAULT_CHUNK):
    """How many integrator waves `render` runs for this frame (the path
    and Whitted integrators; the debug one takes one sample)."""
    return sum(1 for _ in _waves(width * height, spp, chunk))


def wave_fn(meta, width: int, max_depth: int, integrator: str = "path",
            mis: bool = False, nee: bool = True, sampler: str = "random",
            spp: int | None = None, seed: int = 0,
            sort_rays: bool | None = None, with_stats: bool = False):
    """The one-wave function for a fixed scene meta (the counterpart of the
    reference package's `_wave_fn`): wave(pack, cam, sample, pixel) with
    [N] int64 global sample indices and pixel ids returns the colours
    [N, 3] (and, with_stats, li_path's counts)."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    if with_stats and integrator != "path":
        raise ValueError("with_stats counts the path integrator's rays only")

    def wave(pack, cam, sample, pixel):
        keys = rng.lane_keys(seed, sample, pixel)
        jitter = rng.camera_jitter(keys, sampler=sampler, spp=spp)
        # the camera rays through pixel + in-pixel jitter (reference:
        # src/sampler.h:148-155) and li_path's initial state, one kernel
        # launch on the card (ops/wave.py)
        init = wave_ops.camera_rays(cam, pixel, width, jitter, pack.ray_eps)
        o, d = init.ray_o, init.ray_d
        if integrator == "debug":
            return integrators.li_debug_normal(meta, pack, o, d)
        u = keys
        if sampler == "debug":
            u = rng.debug_path_uniforms(o.shape[0], max_depth, meta.n_lights,
                                        device=o.device)
        if integrator == "whitted":
            return integrators.li_whitted(meta, pack, o, d, u, max_depth)
        return integrators.li_path(meta, pack, o, d, u, max_depth, mis=mis,
                                   nee=nee, with_stats=with_stats,
                                   sort_rays=sort_rays, init=init)

    return wave


def compiled_wave_fn(meta, width: int, max_depth: int,
                     integrator: str = "path", mis: bool = False,
                     nee: bool = True, sampler: str = "random",
                     spp: int | None = None, seed: int = 0,
                     sort_rays: bool | None = None, with_stats: bool = False,
                     capture_after: int = 0):
    """wave_fn's wave, replayed from one CUDA graph per input shape (the
    counterpart of the reference's `jax.jit(wave)`, models/graph.py): the
    same arguments and outputs, on the card only, sample and pixel [N]
    tensors; the outputs are overwritten by the next call of the same
    shape. Each shape's first capture_after calls run op by op and the
    next captures it. spp, which only the stratified sampler reads, keys
    no other sampler's graph."""
    if sampler != "stratified":
        spp = None
    static = (meta, width, max_depth, integrator, mis, nee, sampler, spp,
              int(seed), sort_rays, with_stats)
    return graph_mod.compile_wave(wave_fn(*static), static, capture_after)


def frame_wave_fn(device: torch.device, graph: bool | None, *args, **kw):
    """The wave a frame on `device` runs: on the card, where graph is None,
    compiled_wave_fn(*args, **kw) capturing a shape once it has run
    graph.CAPTURE_AFTER times op by op (a frame of a few waves pays no
    capture it would not repay); where graph is True, compiled_wave_fn
    capturing at a shape's first call; where graph is False (the
    counterpart of `jax.disable_jit()`), or None on the CPU, wave_fn(*args,
    **kw). graph=True off the card raises."""
    after = graph_mod.capture_after(graph, device)
    if after is None:
        return wave_fn(*args, **kw)
    return compiled_wave_fn(*args, **kw, capture_after=after)


def setup(scene, width: int, height: int, device=None):
    """(device, pack, camera) of a frame: `device`, or the card when it is
    None (raising where there is none)."""
    device = camera_mod.resolve_device(device)
    cam = camera_mod.make_camera(scene.camera.lookfrom, scene.camera.front,
                                 scene.camera.vup, scene.camera.vfov,
                                 (width, height), device=device)
    return device, scene.pack.to(device), cam


def render(scene, width: int, height: int, spp: int, seed: int = 0,
           max_depth: int = 5, integrator: str = "path", mis: bool = False,
           nee: bool = True, sampler: str = "random",
           chunk: int = DEFAULT_CHUNK, clamp: bool = True, device=None,
           with_stats: bool = False, sort_rays: bool | None = None,
           graph: bool | None = None):
    """Full-frame render -> linear [H,W,3] float32 tensor on `device`
    (averaged over spp, optionally clamped like the reference's film write,
    reference: src/integrator.cc:108). integrator "path" | "whitted" |
    "debug" (normals, one sample), mis, nee and sampler "random" |
    "stratified" | "debug" are the reference package's. with_stats also
    returns the counts of `li_path` (rays by class, the sweep kernel's
    counters), summed over the frame, as Python ints. sort_rays is
    li_path's (default: on for kernel-routed scenes). device defaults to
    the card and raises where there is none; the CPU runs only when asked
    (device="cpu"). On the card each wave shape is replayed from a CUDA
    graph (compiled_wave_fn) once it has run graph.CAPTURE_AFTER times op
    by op, or from its first wave with graph=True; graph=False runs the
    eager wave, with the same image bit for bit; graph=True off the card
    raises."""
    with span("render.frame"):
        with span("render.setup"):
            device, pack, cam = setup(scene, width, height, device)
        wave = frame_wave_fn(device, graph, scene.meta, width, max_depth,
                             integrator, mis, nee, sampler, spp, seed,
                             sort_rays, with_stats)
        n_pixels = width * height
        samples = 1 if integrator == "debug" else spp
        with span("render.film"):
            film = film_mod.new_film(width, height, device)
        stats = {}
        for s0, ns, p0, npx in _waves(n_pixels, samples, chunk):
            sample = torch.arange(s0, s0 + ns,
                                  device=device).repeat_interleave(npx)
            pixel = torch.arange(p0, p0 + npx, device=device).repeat(ns)
            # the wave's range in a profile (scripts/wave_nodes.py)
            with span("render.wave"):
                out = wave(pack, cam, sample, pixel)
            if with_stats:
                out, st = out
                for k, v in st.items():
                    stats[k] = stats.get(k, 0) + v
            out = out.view(ns, npx, 3)
            with span("render.film"):
                for k in range(ns):  # sample by sample, as the reference adds
                    film_mod.add_samples(film, out[k], p0)
        with span("render.finalize"):
            img = film_mod.finalize(film, samples, clamp)
        if with_stats:
            return img, {k: int(v) for k, v in stats.items()}
        return img


def render_fn(scene, width: int, height: int, spp: int, seed: int = 0,
              max_depth: int = 5, mis: bool = False, device=None):
    """The whole frame as one differentiable function of the scene pack
    (reference package render.py:90-121): returns (fn, pack), pack on
    `device` (default: the card), and fn(pack) -> [H,W,3] float32 runs one
    path-integrator wave of the whole frame per sample, sums the waves in
    float32 in sample order and divides by spp, with no clamp. Gradients
    flow into every floating field of the pack that requires grad."""
    device, pack, cam = setup(scene, width, height, device)
    wave = wave_fn(scene.meta, width, max_depth, mis=mis, seed=seed)
    pixel = torch.arange(width * height, device=device)

    def fn(pack):
        film = torch.zeros((width * height, 3), dtype=torch.float32,
                           device=device)
        for s in range(spp):
            film = film + wave(pack, cam, s, pixel)
        return (film / spp).view(height, width, 3)

    return fn, pack
