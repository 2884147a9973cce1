"""Distributed gradient-descent fitting of scene parameters (inverse
rendering) over the rank mesh.

PyTorch counterpart of jet_pbrt_tpu/parallel/train.py. The forward is
parallel/render.py's sharded frame. The loss is mean((img - target)^2)
over the whole frame, where a pixel block's img is the "spp" group's sum
of its ranks' partial films over spp. Its gradient in the replicated
parameters is the sum over every rank of the vector-Jacobian product of
that rank's partial film with its share of d loss / d img, 2 (img -
target) / (n * spp); each rank backs its own partial film with that share
(no collective sits on the tape), and the gradients are summed over the
mesh, "spp" then "px": the all-reduce XLA inserts in the reference. A
block's loss is counted once, by summing the block sums over "px" only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..diff import params as P
from ..models.render import setup
from .mesh import rank_device
from .render import ShardedRender, build_sharded_render


def value_and_grad(render: ShardedRender, pack, cam, params: dict,
                   target_flat: torch.Tensor):
    """(loss as a float, {field: d loss / d field}) of the frame rendered
    from pack with `params`, against target_flat [H*W, 3]; the same on
    every rank of the mesh. The partial film's backward launches no
    kernel: the integrators keep every traversal input off the tape."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    partial = render.partial(P.with_params(pack, leaves), cam)
    img = partial.detach().clone()
    dist.all_reduce(img, group=render.spp_group)
    diff = img / render.spp - target_flat[render.block]
    n = target_flat.numel()
    loss = (diff.double() ** 2).sum()
    dist.all_reduce(loss, group=render.px_group)
    grads = torch.autograd.grad(partial, list(leaves.values()),
                                grad_outputs=diff * (2.0 / (n * render.spp)),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves.values(), grads)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=render.spp_group)
    dist.all_reduce(flat, group=render.px_group)
    out, at = {}, 0
    for k, v in leaves.items():
        out[k] = flat[at:at + v.numel()].view_as(v)
        at += v.numel()
    return float(loss) / n, out


def build_train_step(scene, mesh, width: int, height: int, spp: int,
                     fields=("mat_c0",), lr: float = 1.0, seed: int = 0,
                     max_depth: int = 2, device=None):
    """Returns (step, init, render, cam) (reference package
    train.py:20-46): step(params, target_flat) -> (params', loss), one
    gradient step on the whole frame's loss, projected onto [0, inf);
    init() the pack's current values of `fields`; render the sharded
    render (render.frame(pack, cam) gives the flat [H*W, 3] film to take
    as a target); cam the camera. Every rank of the mesh calls step with
    the same params and target; pack and cam live on `device` (default:
    this rank's card)."""
    device, pack, cam = setup(scene, width, height, rank_device(device))
    render = build_sharded_render(scene.meta, mesh, width, height, spp,
                                  seed=seed, max_depth=max_depth,
                                  device=device)

    def step(params, target_flat):
        loss, g = value_and_grad(render, pack, cam, params, target_flat)
        return {k: torch.clamp_min(params[k] - lr * g[k], 0.0)
                for k in params}, loss

    def init():
        return P.get_params(pack, fields)

    return step, init, render, cam
