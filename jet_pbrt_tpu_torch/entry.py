"""Entry points of the port: the counterparts of the repo's
`__graft_entry__.py` (entry() :14-42, dryrun_multichip(n) :45-88).

entry()             -> (fn, example_args): one path-tracing wave over the
                       Cornell box, replayed from a CUDA graph on the card.
dryrun_multichip(n) -> spawns n ranks, builds the reference's (px, spp)
                       mesh and runs ONE sharded train step (forward
                       partial films, "spp" film sum, backward, all-reduced
                       gradients, projected update) on tiny shapes, graphed
                       on the card.
"""
from __future__ import annotations

import math

import torch

from .models import camera as camera_mod
from .models.render import compiled_wave_fn, setup, wave_fn
from .parallel import multihost
from .parallel.mesh import rank_device
from .parallel.train import build_train_step
from .scene.scenes import cornell_box

ENTRY_RES, ENTRY_DEPTH = 64, 5
DRYRUN_RES, DRYRUN_DEPTH = 16, 3


def entry(device=None):
    """(fn, example_args): fn(pack, sample_index) -> the [64*64, 3] colours
    of one path-integrator wave (depth 5, NEE, seed 0) of sample
    `sample_index` over every pixel of the Cornell box at 64^2, as the
    reference's entry(). On the card (the default; raises where there is
    none) fn is compiled_wave_fn's: captured as a CUDA graph at its first
    call and replayed after, its output the graph's own tensor, overwritten
    by the next call. device="cpu" runs wave_fn op by op, the same colours
    as the card's eager wave up to libm rounding. example_args: (the
    scene's pack on the device, 0)."""
    device = camera_mod.resolve_device(device)
    scene = cornell_box(lambert_only=False, use_bvh=False)
    device, pack, cam = setup(scene, ENTRY_RES, ENTRY_RES, device)
    make = compiled_wave_fn if device.type == "cuda" else wave_fn
    wave = make(scene.meta, ENTRY_RES, ENTRY_DEPTH)
    ids = torch.arange(ENTRY_RES * ENTRY_RES, device=device)

    def fn(pack, sample_index):
        return wave(pack, cam, torch.full_like(ids, sample_index), ids)

    return fn, (pack, 0)


def _dryrun_rank(rank, n_devices: int, dev_type: str):
    """One rank of dryrun_multichip: (mesh shape by axis name, loss)."""
    dev = rank_device(dev_type)
    spp_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = multihost.make_multihost_mesh(spp=spp_axis, device=dev)
    scene = cornell_box(lambert_only=False, use_bvh=False).to(dev)
    step, init, render, cam = build_train_step(
        scene, mesh, DRYRUN_RES, DRYRUN_RES, 2 * spp_axis,
        fields=("mat_c0", "light_c"), lr=0.5, max_depth=DRYRUN_DEPTH,
        device=dev, graph=dev.type == "cuda")
    target = render.frame(scene.pack, cam)
    params = init()
    # perturbed, so that the step computes a real gradient, not a zero at
    # the optimum
    params["mat_c0"] = params["mat_c0"] * 0.5 + 0.1
    params, loss = step(params, target)
    loss = float(loss)
    if not (math.isfinite(loss) and loss > 0.0):
        raise AssertionError(f"rank {rank}: loss {loss}")
    return dict(zip(mesh.mesh_dim_names, mesh.shape)), loss


def dryrun_multichip(n_devices: int, device=None) -> float:
    """n_devices spawned ranks (multihost.spawn) run one train step of the
    Cornell box at 16^2, spp 2 * spp_axis, depth 3, fields mat_c0 and
    light_c, lr 0.5, from mat_c0 * 0.5 + 0.1, on the mesh (n / spp_axis,
    spp_axis) with spp_axis 2 where n is even, as the reference's
    dryrun_multichip: over NCCL with one card per rank where there are n
    cards, else over gloo, the ranks sharing the one card, or the CPU with
    device="cpu". On the card the step is graphed (graph=True). Every
    rank checks its loss finite and above 0; prints one line and returns
    the loss."""
    dev_type = camera_mod.resolve_device(device).type
    backend = ("nccl" if dev_type == "cuda"
               and torch.cuda.device_count() >= n_devices else "gloo")
    ranks = multihost.spawn(_dryrun_rank, n_devices, n_devices, dev_type,
                            backend=backend)
    shape, loss = ranks[0]
    if any(r != ranks[0] for r in ranks):
        raise AssertionError(f"the ranks disagree: {ranks}")
    print(f"dryrun_multichip ok: mesh={shape} loss={loss:.6f} "
          f"({backend}, {dev_type})", flush=True)
    return loss
