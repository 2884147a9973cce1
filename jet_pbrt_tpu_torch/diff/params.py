"""Differentiable scene parameters.

PyTorch counterpart of jet_pbrt_tpu/diff/params.py. The radiance estimate
is differentiable with respect to the continuous appearance fields of the
pack (material colours and roughness, light emission, texels); sampling is
detached inside the integrators (models/integrators.py), so gradients flow
through the f, Li and emission weights alone. `Params` is a dict of tensors
split out of the ScenePack; the geometry stays fixed.
"""
from __future__ import annotations

import torch

# ScenePack fields that are optimisation targets
DIFFERENTIABLE_FIELDS = (
    "mat_c0", "mat_c1", "mat_s0", "mat_s1", "light_c", "tex_image",
)


def get_params(pack, fields=DIFFERENTIABLE_FIELDS) -> dict:
    return {f: getattr(pack, f) for f in fields}


def with_params(pack, params: dict):
    return pack._replace(**params)


def loss_fn(render_fn, pack, target):
    """loss(params): the mean squared error of render_fn(pack with params)
    against target. render_fn: pack -> [H,W,3] (models.render.render_fn's
    fn)."""

    def loss(params):
        img = render_fn(with_params(pack, params))
        return torch.mean((img - target) ** 2)

    return loss


def value_and_grad(f, params: dict):
    """(f(params) as a float, {field: df/dfield}) by autograd on detached
    copies of the params; a field f does not depend on gets zeros."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    val = f(leaves)
    grads = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
    return float(val.detach()), {k: torch.zeros_like(v) if g is None else g
                        for (k, v), g in zip(leaves.items(), grads)}


def fit(render_fn, pack, target, fields=("mat_c0",), steps: int = 50,
        lr: float = 0.05):
    """Plain gradient descent of the fields towards target, each step
    projected onto [0, inf) to keep colours physical. Returns (params,
    losses)."""
    params = get_params(pack, fields)
    loss = loss_fn(render_fn, pack, target)
    losses = []
    for _ in range(steps):
        val, g = value_and_grad(loss, params)
        losses.append(val)
        params = {k: torch.clamp_min(params[k] - lr * g[k], 0.0)
                  for k in params}
    return params, losses
