"""The comparisons that decide `correct`: the numbers compared with the
plain reference (reference/), each held to its limit from the cell's
limits file (pbrt_bench/limits/<cell>.json).

Frames: each window frame's sampled pixels against the reference's values
of the same pixels of the same view (the same seed's samples, through the
same film arithmetic). `mismatch_pct` is the share of sampled pixel
channels that differ by more than `tolerance` or are not finite.

Fit: the first three steps' losses, the first step's gradients and the
parameters' change after the three, against the reference's same steps
from the same parameters against the same target. Each gap is taken by the
worst leaf: the gap between the program's norm and the reference's,
against the reference's norm of that leaf or of the median leaf,
whichever is larger. Leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change.
"""
from __future__ import annotations

import statistics

import torch


def mismatch_pct(kept, ref: dict, tolerance: float) -> float:
    """kept: (view, [P, 3]) per frame; ref: view -> [P, 3]."""
    bad, total = 0, 0
    for view, got in kept:
        want = ref[view].to(got.device)
        ok = (got - want).abs() <= tolerance
        bad += int((~ok).sum())
        total += ok.numel()
    return 100.0 * bad / max(total, 1)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref),
    median leaf norm of ref)."""
    pn, rn = _norms(prog), _norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    if not keys:
        return 0.0
    med = statistics.median(rn[k] for k in rn)
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def fit_numbers(prog: dict, ref: dict) -> dict:
    """loss_gap, grad_gap and change_gap of two records (losses, grad1,
    p0, p3)."""
    loss_gap = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap = leaf_gap(prog["grad1"], ref["grad1"])
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    moved = {k for k, v in gn.items() if v >= 1e-3 * med}
    change = lambda r: {k: (r["p3"][k].double() - r["p0"][k].double())
                        for k in r["p3"]}
    change_gap = leaf_gap(change(prog), change(ref), keep=moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit (a number that is not finite fails)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
