"""Differentiable scene parameters.

PyTorch counterpart of jet_pbrt_tpu/diff/params.py. The radiance estimate
is differentiable with respect to the continuous appearance fields of the
pack (material colours and roughness, light emission, texels); sampling is
detached inside the integrators (models/integrators.py), so gradients flow
through the f, Li and emission weights alone. `Params` is a dict of tensors
split out of the ScenePack; the geometry stays fixed.

On the card `compile_value_and_grad` is the counterpart of the reference's
`jax.jit(jax.value_and_grad(loss))` (params.py:55): the forward and its
`torch.autograd.grad` replayed from one CUDA graph (models/graph.py), which
`fit` takes where its steps repay the capture.
"""
from __future__ import annotations

import torch

from ..models import graph as graph_mod

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


def _value_and_grad(f, fields: tuple):
    """vg(*leaves) -> (f's value detached, its gradient in each leaf, zeros
    where f does not depend on one), f taking {field: leaf}."""

    def vg(*leaves):
        val = f(dict(zip(fields, leaves)))
        grads = torch.autograd.grad(val, leaves, allow_unused=True)
        return val.detach(), tuple(torch.zeros_like(v) if g is None else g
                                   for v, g in zip(leaves, grads))

    return vg


def value_and_grad(f, params: dict):
    """(f(params) as a 0-d tensor on its device, {field: df/dfield}) by
    autograd on detached copies of the params; a field f does not depend
    on gets zeros."""
    leaves = tuple(v.detach().clone().requires_grad_(True)
                   for v in params.values())
    val, grads = _value_and_grad(f, tuple(params))(*leaves)
    return val, dict(zip(params, grads))


def compile_value_and_grad(f):
    """vg(params) -> value_and_grad(f, params), with f's forward and its
    torch.autograd.grad recorded into one CUDA graph per key and replayed
    (the counterpart of `jax.jit(jax.value_and_grad(f))`): the key is this
    compiled function, the params' fields, signature and device, and whether
    deterministic algorithms are on (graph.grad_key). A key's first call
    captures it, as jax.jit compiles at the first: static leaves of the
    params' shapes and dtypes that require grad, GRAD_WARMUPS warm-up
    calls, the capture (models/graph.py CapturedCall), the last warm-up's
    outputs returned; every later call copies the caller's params into the
    leaves and replays. Whatever f
    reads besides the params (the pack, the target, the camera) is baked
    into the graph as it was at capture, as jax.jit bakes a closure's
    arrays; so are render_fn's sample indices, Python ints, as the
    reference's scan bakes its length.

    The value and gradients are the graph's own tensors, overwritten by the
    next call of the same key: use or clone them first. Memory: the
    capture's pool holds f's tape at its peak, for render_fn's fn about
    5.4 GB per 2^20-lane depth-5 wave, once per sample (spp samples keep
    spp tapes until the backward), plus the backward's transients; it stays
    in graph.GRAD_CACHE (MAX_GRAD_GRAPHS entries) until vg.release(),
    eviction or graph.clear(). Runs on the card only; a failed capture
    raises."""

    owner = object()    # the keys' first element: holds nothing of f

    def vg(params: dict):
        graph_mod.capture_after(True, next(iter(params.values())).device)
        fields = tuple(params)
        leaves = tuple(v.detach().requires_grad_(True)
                       for v in params.values())
        val, grads = graph_mod.GRAD_CACHE.run(
            graph_mod.grad_key(owner, params), _value_and_grad(f, fields),
            leaves, 0)
        return val, dict(zip(fields, grads))

    vg.release = lambda: graph_mod.GRAD_CACHE.drop(owner)
    return vg


def fit(render_fn, pack, target, fields=("mat_c0",), steps: int = 50,
        lr: float = 0.05, graph: bool | None = None):
    """Plain gradient descent of the fields towards target, each step
    projected onto [0, inf) to keep colours physical. Returns (params,
    losses). The value and gradient of each step: on the card, where graph
    is None, a fit of more than graph.CAPTURE_AFTER steps replays them from
    a CUDA graph captured at its first step (compile_value_and_grad,
    released when the fit returns) and a shorter fit, which would not repay
    the capture, runs them eagerly; graph=True captures, graph=False runs
    eagerly; graph=True off the card raises. The projected update runs
    outside the graph, as the reference jits only value_and_grad. The
    losses stay on the device until the fit ends."""
    params = get_params(pack, fields)
    graph = graph_mod.capture_after(graph, target.device, steps) is not None
    loss = loss_fn(render_fn, pack, target)
    vg = compile_value_and_grad(loss) if graph else (
        lambda p: value_and_grad(loss, p))
    losses = []
    try:
        for _ in range(steps):
            val, g = vg(params)
            losses.append(val.clone())
            params = {k: torch.clamp_min(params[k] - lr * g[k], 0.0)
                      for k in params}
    finally:
        if graph:
            vg.release()
    return params, torch.stack(losses).tolist() if losses else []
