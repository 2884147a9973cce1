"""Checkpoint and resume for long renders.

PyTorch counterpart of jet_pbrt_tpu/utils/checkpoint.py. The whole state of
a render is (film accumulator, samples done, seed): the streams are keyed
by (seed, sample, pixel), so the remaining samples draw what they would
have drawn without the stop. One .npz with the reference package's keys
(film, waves_done, seed, param__<name>), so each package loads the other's
file. The port stores its float64 film as float64, which makes a resumed
render equal the uninterrupted one bit for bit; a file written by the
reference holds a float32 film.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def save_render_state(path: str, film, waves_done: int, seed: int,
                      params: dict | None = None) -> None:
    """film: an accumulator tensor (any device) or array, saved with its
    dtype."""
    if isinstance(film, torch.Tensor):
        film = film.detach().cpu().numpy()
    blob = {"film": np.asarray(film), "waves_done": np.int64(waves_done),
            "seed": np.int64(seed)}
    for k, v in (params or {}).items():
        blob[f"param__{k}"] = np.asarray(v)
    np.savez(path, **blob)


def load_render_state(path: str):
    """Returns (film, waves_done, seed, params dict or None) as numpy."""
    z = np.load(path)
    params = {k[len("param__"):]: z[k] for k in z.files
              if k.startswith("param__")}
    return z["film"], int(z["waves_done"]), int(z["seed"]), params or None


def render_resumable(scene, width: int, height: int, spp: int,
                     checkpoint_path: str, checkpoint_every: int = 16,
                     seed: int = 0, max_depth: int = 5, clamp: bool = True,
                     device=None, graph: bool | None = None) -> torch.Tensor:
    """Render spp samples of the path integrator, saving the float64 film
    and the count of samples done every checkpoint_every samples and at
    the end; an existing checkpoint at checkpoint_path is resumed (its
    seed must match). Returns the [H, W, 3] float32 image on `device`
    (default the card), as `render` would; its waves take `render`'s
    route by `graph`: CUDA graphs on the card, the eager wave with
    graph=False."""
    from ..models import film as film_mod
    from ..models.render import DEFAULT_CHUNK, frame_wave_fn, setup

    device, pack, cam = setup(scene, width, height, device)
    wave = frame_wave_fn(device, graph, scene.meta, width, max_depth,
                         seed=seed)
    n_pixels = width * height
    film = film_mod.new_film(width, height, device)
    start = 0
    if os.path.exists(checkpoint_path):
        saved, start, seed_saved, _ = load_render_state(checkpoint_path)
        if seed_saved != seed:
            raise ValueError(f"checkpoint {checkpoint_path} was made with seed "
                             f"{seed_saved}, not {seed}")
        if saved.size == film.numel():
            film.copy_(torch.from_numpy(saved.astype(np.float64))
                       .view(film.shape))
        else:
            start = 0
    for s in range(start, spp):
        for p0 in range(0, n_pixels, DEFAULT_CHUNK):
            pixel = torch.arange(p0, min(p0 + DEFAULT_CHUNK, n_pixels),
                                 device=device)
            film_mod.add_samples(
                film, wave(pack, cam, torch.full_like(pixel, s), pixel), p0)
        if (s + 1) % checkpoint_every == 0 or s + 1 == spp:
            save_render_state(checkpoint_path, film.view(n_pixels, 3), s + 1,
                              seed)
    return film_mod.finalize(film, spp, clamp)
