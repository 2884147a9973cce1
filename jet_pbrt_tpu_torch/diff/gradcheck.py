"""Finite-difference check of the renderer's gradients.

PyTorch counterpart of jet_pbrt_tpu/diff/gradcheck.py. With counter-based
random streams the render is a deterministic function of the parameters,
so central differences are well defined. Parameters that gate decisions
(Russian roulette reads f, the plastic lobe pick reads Kd and Ks) make it
only piecewise smooth: check at max_depth < 3 (no roulette) on matte
materials, or on emission, which enters linearly.
"""
from __future__ import annotations

import numpy as np
import torch

from .params import value_and_grad


def finite_diff_grad(f, params: dict, eps: float = 1e-3) -> dict:
    """Central differences of the scalar f over every element of every
    field: 2 evaluations per element, so keep the fields small. Each
    bumped field is rounded to float32 from float64, as the reference
    package's is. Returns {field: float64 numpy array}."""
    out = {}
    with torch.no_grad():
        for k, v in params.items():
            base = v.detach().cpu().numpy().astype(np.float64)
            g = np.zeros_like(base)
            gflat = g.reshape(-1)
            for i in range(base.size):
                plus = {**params, k: _bump(base, i, +eps, v.device)}
                minus = {**params, k: _bump(base, i, -eps, v.device)}
                gflat[i] = (float(f(plus)) - float(f(minus))) / (2 * eps)
            out[k] = g
    return out


def _bump(v: np.ndarray, i: int, eps: float, device):
    b = v.copy().reshape(-1)
    b[i] += eps
    return torch.as_tensor(b.reshape(v.shape).astype(np.float32),
                           device=device)


def check_grads(f, params: dict, rtol: float = 5e-2, atol: float = 1e-4,
                eps: float = 1e-3):
    """Autograd of f against central differences; raises AssertionError
    where an element above atol on either side differs by more than rtol
    of max(|fd|, atol / rtol). Returns (autograd grads as tensors, finite
    differences as float64 numpy arrays)."""
    _, g_auto = value_and_grad(f, params)
    g_fd = finite_diff_grad(f, params, eps)
    for k in params:
        a = g_auto[k].detach().cpu().numpy().astype(np.float64)
        b = g_fd[k]
        denom = np.maximum(np.abs(b), atol / rtol)
        rel = np.abs(a - b) / denom
        mask = (np.abs(a) > atol) | (np.abs(b) > atol)
        assert np.all(rel[mask] < rtol), (
            f"grad mismatch for {k}: auto={a}, fd={b}")
    return g_auto, g_fd
