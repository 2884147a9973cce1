"""Sharded rendering over a (px, spp) rank mesh.

PyTorch counterpart of jet_pbrt_tpu/parallel/render.py. Where the
reference runs one shard_map program, each rank here runs the single-card
path's one-wave function (models/render.py::wave_fn) on its own pixel
block for its own slice of sample indices, sums its samples' colours in
float32 in sample order, and the "spp" group sums those partial films
with all_reduce (the reference's psum over "spp"); the film is then
divided by spp. The scene pack and camera are replicated: every rank
holds them on its device.

On the card the forward frame (`__call__`, `frame`) takes render()'s
route: each wave shape that recurs is replayed from the rank's own CUDA
graph (models/render.py::compiled_wave_fn, the counterpart of the
reference's jitted shard_map), from its first wave with graph=True; the
collectives stay outside the graph, and `partial`, which backs the train
step's tape, runs the eager wave.

Streams are keyed by (seed, global sample, global pixel) alone, never by
the layout, so a px-only mesh gives the single-card render_fn's frame bit
for bit, and a mesh with an spp axis gives it up to the reassociation of
the per-pixel sum.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.render import frame_wave_fn, setup, wave_fn
from .mesh import rank_device


class ShardedRender:
    """This rank's share of a frame: `fn(pack, cam)` returns its film
    block [H*W/px, 3] (rows `block` of the flat frame), averaged over spp
    and equal on every rank of its "spp" group; `partial` is its own
    samples' float32 sum, differentiable in the pack (parallel/train.py);
    `frame` gathers the blocks over "px" into the flat [H*W, 3] film."""

    def __init__(self, meta, mesh, width: int, height: int, spp: int,
                 seed: int = 0, max_depth: int = 5, mis: bool = False,
                 sampler: str = "random", sort_rays: bool | None = None,
                 device=None, graph: bool | None = None):
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        n_px, n_spp = mesh.shape
        n_pixels = width * height
        if n_pixels % n_px:
            raise ValueError(f"{n_pixels} pixels do not split into "
                             f"px = {n_px} blocks")
        if spp % n_spp:
            raise ValueError(f"spp = {spp} does not split over {n_spp} ranks "
                             "(pad spp up at the call site)")
        self.ip, self.isp = coord
        self.local_pixels = n_pixels // n_px
        self.local_spp = spp // n_spp
        self.spp = spp
        self.device = rank_device(device)
        self.block = slice(self.ip * self.local_pixels,
                           (self.ip + 1) * self.local_pixels)
        self.mesh = mesh
        self.px_group = mesh.get_group("px")
        self.spp_group = mesh.get_group("spp")
        self._ids = torch.arange(self.block.start, self.block.stop,
                                 device=self.device)
        args = (meta, width, max_depth)
        kw = dict(mis=mis, sampler=sampler, spp=spp, seed=seed,
                  sort_rays=sort_rays)
        self._wave = wave_fn(*args, **kw)
        self._forward = frame_wave_fn(self.device, graph, *args, **kw)

    def _sum(self, wave, pack, cam) -> torch.Tensor:
        film = torch.zeros((self.local_pixels, 3), dtype=torch.float32,
                           device=self.device)
        for s in range(self.local_spp):
            sample = torch.full_like(self._ids, self.isp * self.local_spp + s)
            film = film + wave(pack, cam, sample, self._ids)
        return film

    def partial(self, pack, cam) -> torch.Tensor:
        """Sum of this rank's samples' colours [local_pixels, 3], float32,
        sample by sample in order (global sample isp * local_spp + s), by
        the eager wave: differentiable in the pack."""
        return self._sum(self._wave, pack, cam)

    def __call__(self, pack, cam) -> torch.Tensor:
        """This rank's film block, averaged over the frame's spp, its waves
        taking render()'s route by `graph` (CUDA graphs on the card); it
        carries no gradient (the collective has no backward)."""
        with torch.no_grad():
            film = self._sum(self._forward, pack, cam)
        dist.all_reduce(film, group=self.spp_group)
        return film / self.spp

    def frame(self, pack, cam) -> torch.Tensor:
        """The flat film [H*W, 3] on every rank: the blocks gathered over
        "px" (the list form of all_gather, which gloo also runs on CUDA
        tensors), put in pixel order by each rank's mesh coordinate."""
        block = self(pack, cam)
        got = [torch.empty_like(block) for _ in range(self.mesh.shape[0])]
        dist.all_gather(got, block, group=self.px_group)
        column = self.mesh.mesh[:, self.isp].tolist()
        order = [column.index(dist.get_global_rank(self.px_group, i))
                 for i in range(len(got))]
        return torch.cat([got[order.index(ip)] for ip in range(len(got))])


def build_sharded_render(meta, mesh, width: int, height: int, spp: int,
                         seed: int = 0, max_depth: int = 5, mis: bool = False,
                         sampler: str = "random",
                         sort_rays: bool | None = None,
                         device=None, graph: bool | None = None
                         ) -> ShardedRender:
    """fn(pack, cam) -> this rank's film block [H*W/px, 3] (reference
    package render.py:32-95). H*W must divide by the mesh's px and spp by
    its spp. pack and cam live on `device` (default: this rank's card,
    mesh.rank_device); this rank must be in the mesh. The forward's waves
    take render()'s route by `graph`."""
    return ShardedRender(meta, mesh, width, height, spp, seed, max_depth, mis,
                         sampler, sort_rays, device, graph)


def render_sharded(scene, width: int, height: int, spp: int, mesh,
                   seed: int = 0, max_depth: int = 5, mis: bool = False,
                   clamp: bool = True, sampler: str = "random",
                   device=None, graph: bool | None = None) -> torch.Tensor:
    """The full frame [H, W, 3] float32 on every rank of the mesh, on its
    device (default: this rank's card; device="cpu" on the CPU), clamped
    to [0, 1] unless clamp=False (reference package render.py:98-115);
    its waves take render()'s route by `graph`."""
    device, pack, cam = setup(scene, width, height, rank_device(device))
    fn = build_sharded_render(scene.meta, mesh, width, height, spp, seed=seed,
                              max_depth=max_depth, mis=mis, sampler=sampler,
                              device=device, graph=graph)
    img = fn.frame(pack, cam).view(height, width, 3)
    return img.clamp(0.0, 1.0) if clamp else img
