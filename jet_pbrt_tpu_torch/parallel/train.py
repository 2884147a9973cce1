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

On the card the step is the counterpart of the reference's `@jax.jit`
step: each rank replays its partial film and that film's backward from
two CUDA graphs sharing one pool (models/graph.py
CapturedForwardBackward), and the collectives between and after them run
eagerly (a gloo rank's cannot be captured).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..diff import params as P
from ..models import graph as graph_mod
from ..models.render import setup
from .mesh import rank_device
from .render import ShardedRender, build_sharded_render


def _loss(render: ShardedRender, partial: torch.Tensor,
          target_flat: torch.Tensor):
    """(the frame's loss as a 0-d float64 tensor, d loss / d partial) from
    this rank's partial film: the film summed over "spp", the block's
    squared error summed over "px"."""
    img = partial.detach().clone()
    dist.all_reduce(img, group=render.spp_group)
    diff = img / render.spp - target_flat[render.block]
    n = target_flat.numel()
    loss = (diff.double() ** 2).sum()
    dist.all_reduce(loss, group=render.px_group)
    return loss / n, diff * (2.0 / (n * render.spp))


def _summed(render: ShardedRender, params: dict, grads) -> dict:
    """This rank's gradients summed over the mesh, "spp" then "px", as
    {field: tensor} shaped as params."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=render.spp_group)
    dist.all_reduce(flat, group=render.px_group)
    out, at = {}, 0
    for k, v in params.items():
        out[k] = flat[at:at + v.numel()].view_as(v)
        at += v.numel()
    return out


def value_and_grad(render: ShardedRender, pack, cam, params: dict,
                   target_flat: torch.Tensor):
    """(loss as a 0-d tensor, {field: d loss / d field}) of the frame
    rendered from pack with `params`, against target_flat [H*W, 3]; the
    same on every rank of the mesh. The partial film's backward launches no
    kernel: the integrators keep every traversal input off the tape."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    partial = render.partial(P.with_params(pack, leaves), cam)
    loss, grad_img = _loss(render, partial, target_flat)
    grads = torch.autograd.grad(partial, list(leaves.values()),
                                grad_outputs=grad_img, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves.values(), grads)]
    return loss, _summed(render, params, grads)


class GraphedValueAndGrad:
    """value_and_grad with the partial film and its backward replayed from
    two CUDA graphs of one pool, captured at construction on static leaves
    of params' shapes (CapturedForwardBackward; pool_bytes, launches,
    warmup_s and capture_s are its). A call copies the params into the
    leaves, replays the forward, runs the loss and its collectives
    eagerly, replays the backward (the two replays alternate, as they
    must) and sums the gradients over the mesh. `warmup_outputs` are the
    first call's, made through the graphs."""

    def __init__(self, render: ShardedRender, pack, cam, params: dict,
                 target_flat: torch.Tensor):
        self.render = render
        fields = tuple(params)
        self.graphs = graph_mod.CapturedForwardBackward(
            lambda *xs: render.partial(P.with_params(
                pack, dict(zip(fields, xs))), cam),
            tuple(v.detach().requires_grad_(True) for v in params.values()))
        self.warmup_outputs = self((params, target_flat))

    def __call__(self, inputs):
        params, target_flat = inputs
        partial = self.graphs.forward(tuple(params.values()))
        loss, grad_img = _loss(self.render, partial, target_flat)
        return loss, _summed(self.render, params,
                             self.graphs.backward(grad_img))

    def release(self) -> None:
        self.graphs.release()


def build_train_step(scene, mesh, width: int, height: int, spp: int,
                     fields=("mat_c0",), lr: float = 1.0, seed: int = 0,
                     max_depth: int = 2, device=None,
                     graph: bool | None = None):
    """Returns (step, init, render, cam) (reference package
    train.py:20-46): step(params, target_flat) -> (params', loss), one
    gradient step on the whole frame's loss (a 0-d tensor), projected onto
    [0, inf); init() the pack's current values of `fields`; render the
    sharded render (render.frame(pack, cam) gives the flat [H*W, 3] film to
    take as a target); cam the camera. Every rank of the mesh calls step
    with the same params and target; pack and cam live on `device`
    (default: this rank's card).

    graph: the route of the value and gradient, and of render's forward
    frame, as render()'s. On the card, where graph is None, a step runs
    them eagerly for its first graph.CAPTURE_AFTER calls of a params
    signature (a step does not know how many calls will repay a capture)
    and captures at the next (GraphedValueAndGrad, kept in
    graph.GRAD_CACHE); graph=True captures at the first call, graph=False
    stays eager; graph=True off the card raises. Every rank takes the same
    route at the same call, so their collectives match."""
    device, pack, cam = setup(scene, width, height, rank_device(device))
    capture_after = graph_mod.capture_after(graph, device)
    render = build_sharded_render(scene.meta, mesh, width, height, spp,
                                  seed=seed, max_depth=max_depth,
                                  device=device, graph=graph)
    owner = object()    # the keys' first element

    def eager(params, target_flat):
        return value_and_grad(render, pack, cam, params, target_flat)

    def capture(fn, inputs):
        return GraphedValueAndGrad(render, pack, cam, *inputs)

    def step(params, target_flat):
        if capture_after is not None:
            loss, g = graph_mod.GRAD_CACHE.run(
                graph_mod.grad_key(owner, params), eager,
                (params, target_flat), capture_after, capture)
        else:
            loss, g = eager(params, target_flat)
        return {k: torch.clamp_min(params[k] - lr * g[k], 0.0)
                for k in params}, loss

    def init():
        return P.get_params(pack, fields)

    return step, init, render, cam
