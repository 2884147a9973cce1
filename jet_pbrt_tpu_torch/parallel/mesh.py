"""Rank meshes for sharded rendering.

PyTorch counterpart of jet_pbrt_tpu/parallel/mesh.py. The reference runs
one controller over a 2-D mesh of devices; here each rank is a process
(launched by torchrun or torch.multiprocessing.spawn, inside a process
group that multihost.initialize or the caller set up), and the mesh is a
DeviceMesh over ranks:

  * axis "px"  - pixel blocks: rank (ip, ·) renders pixels
    ip*local_pixels .. (ip+1)*local_pixels - 1;
  * axis "spp" - sample indices: the ranks of one "spp" group render
    disjoint samples of the same pixels and sum their films.

Every random stream is keyed by (seed, global sample, global pixel), so
any (pixel, sample) lane is recomputable on any rank.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import camera as camera_mod


def rank_device(device=None) -> torch.device:
    """`device`, or this rank's card when it is None or "cuda":
    cuda:(LOCAL_RANK % device count), so ranks that share one card all
    land on cuda:0. Raises where there is no card (no fallback)."""
    device = camera_mod.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def make_mesh(px: int | None = None, spp: int = 1, ranks=None,
              device=None) -> DeviceMesh:
    """A (px, spp) DeviceMesh with mesh_dim_names ("px", "spp") over
    `ranks` (default: the whole world) in the order given. px defaults to
    len(ranks) // spp. Every rank of the world must call it with the same
    arguments (creating the mesh's groups is collective), also those left
    out of `ranks`. On the card it first makes this rank's card
    (rank_device) current, so DeviceMesh keeps that choice."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if px is None:
        if spp < 1 or n % spp:
            raise ValueError(f"{n} ranks do not split into spp = {spp}")
        px = n // spp
    if px * spp != n:
        raise ValueError(f"mesh {px}x{spp} != {n} ranks")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
    return DeviceMesh(device.type, torch.tensor(ranks).view(px, spp),
                      mesh_dim_names=("px", "spp"))
