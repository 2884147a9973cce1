"""The reference's own triangle BVH: a binary median-split tree built in
numpy and descended in torch a level at a time, one lane per (ray,
instance) pair.

It shares nothing with the program's traversal tables. The closest hit it
returns is the minimum over the mesh's triangles of the program's own
per-triangle test (the Moller-Trumbore arithmetic of
jet_pbrt_tpu_torch/ops/wide_bvh.py::intersect_wide_plain at commit 77f45ea,
in the instance's space: origin (o - offset) / scale, t in the world = t x
scale), so it does not depend on the order in which triangles are visited.
Boxes are padded, so the descent may test more leaves than it needs but
never skips a triangle the test accepts.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LEAF = 8
# triangle tests a batch of the leaf stage
TESTS = 1 << 23


class Tree(NamedTuple):
    lo: torch.Tensor      # [B, 3] padded box corners
    hi: torch.Tensor
    left: torch.Tensor    # [B] int64 child rows, -1 for a leaf
    right: torch.Tensor
    first: torch.Tensor   # [B] int64 first slot of a leaf
    tris: torch.Tensor    # [S, 9] (p0, e1, e2) per slot, leaves padded
    slot_tri: torch.Tensor  # [S] int64 the mesh triangle of each slot
    depth: int


def build(tris: np.ndarray, leaf: int = LEAF) -> dict:
    """The tree of a [T, 3, 3] float32 mesh as numpy arrays. Each slot's
    row is (p0, p1 - p0, p2 - p0) in float32, as the program's tables hold
    it."""
    tris = np.asarray(tris, np.float32)
    t = len(tris)
    lo_t = tris.min(1).astype(np.float64)
    hi_t = tris.max(1).astype(np.float64)
    cen = 0.5 * (lo_t + hi_t)
    extent = float(np.max(hi_t.max(0) - lo_t.min(0))) if t else 1.0
    pad = 1e-5 * extent + 1e-30
    rows = []          # [lo, hi, left, right, first]
    slots = []
    stack = [(np.arange(t), -1, 0, 0)]
    depth = 0
    while stack:
        idx, parent, side, level = stack.pop()
        me = len(rows)
        depth = max(depth, level)
        rows.append([lo_t[idx].min(0) - pad, hi_t[idx].max(0) + pad, -1, -1,
                     -1])
        if parent >= 0:
            rows[parent][2 + side] = me
        if len(idx) <= leaf:
            rows[me][4] = len(slots)
            slots.extend(list(idx) + [idx[-1]] * (leaf - len(idx)))
            continue
        c = cen[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        half = len(order) // 2
        stack.append((order[half:], me, 1, level + 1))
        stack.append((order[:half], me, 0, level + 1))
    slots = np.asarray(slots, np.int64)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    rows_9 = np.concatenate([p0, p1 - p0, p2 - p0], axis=1).astype(np.float32)
    return dict(lo=np.stack([r[0] for r in rows]).astype(np.float32),
                hi=np.stack([r[1] for r in rows]).astype(np.float32),
                left=np.array([r[2] for r in rows], np.int64),
                right=np.array([r[3] for r in rows], np.int64),
                first=np.array([r[4] for r in rows], np.int64),
                tris=rows_9[slots], slot_tri=slots, depth=depth)


def to_tree(arrays: dict, device, dtype=torch.float32) -> Tree:
    f = lambda k: torch.as_tensor(arrays[k], device=device)
    return Tree(lo=f("lo").to(dtype), hi=f("hi").to(dtype), left=f("left"),
                right=f("right"), first=f("first"),
                tris=f("tris").to(dtype), slot_tri=f("slot_tri"),
                depth=int(arrays["depth"]))


def _inv_dir(c):
    eps = 1e-12
    small = torch.abs(c) < eps
    guard = torch.where(c < 0, torch.full_like(c, -eps),
                        torch.full_like(c, eps))
    return 1.0 / torch.where(small, guard, c)


def _slab(lo, hi, o, inv):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_en = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_ex = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_en, t_ex


def _leaf_tests(tree: Tree, o_l, d, tmin_l, tmax, scl, pair, leaf):
    """The program's triangle test (the Moller-Trumbore arithmetic of its
    plain walk, one rounding an operation) of every slot of leaves `leaf`
    [K] for lanes `pair` [K]: (t in the world [K, LEAF], inf where not
    accepted, and the slots [K, LEAF])."""
    slot = tree.first[leaf][:, None] + torch.arange(LEAF, device=leaf.device)
    rows = tree.tris[slot]                                   # [K, L, 9]
    ox, oy, oz = (o_l[pair, k, None] for k in range(3))
    ddx, ddy, ddz = (d[pair, k, None] for k in range(3))
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    px = ddy * e2z - ddz * e2y
    py = ddz * e2x - ddx * e2z
    pz = ddx * e2y - ddy * e2x
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
    tx = ox - rows[..., 0]
    ty = oy - rows[..., 1]
    tz = oz - rows[..., 2]
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (ddx * qx + ddy * qy + ddz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    t_w = tt * scl[pair, None]
    ok = ((uu >= 0.0) & (vv >= 0.0) & (1.0 - uu - vv >= 0.0)
          & (tt > tmin_l[pair, None]) & (t_w < tmax[pair, None]))
    return torch.where(ok, t_w, torch.full_like(t_w, math.inf)), slot


def walk(tree: Tree, o_l, d, tmin_l, tmax, scl, any_hit: bool):
    """Per lane: the closest accepted triangle's world t (inf where none)
    and its mesh triangle, or, with any_hit, whether any is accepted. o_l
    and tmin_l are in the instance's space, tmax in the world's, scl [P]
    the instance's scale (ones for a mesh in world space). The tree is
    descended a level at a time for every (lane, node) pair whose box the
    lane's segment enters, and every leaf reached is tested: the closest
    accepted t is the minimum over the mesh's triangles, whatever the
    order."""
    p = o_l.shape[0]
    dev = o_l.device
    best = torch.full((p,), math.inf, dtype=o_l.dtype, device=dev)
    best_slot = torch.full((p,), tree.tris.shape[0], dtype=torch.int64,
                           device=dev)
    if p == 0:
        return best, best_slot, best < 0
    inv = _inv_dir(d)
    capl = tmax / scl
    pair = torch.arange(p, device=dev)
    node = torch.zeros((p,), dtype=torch.int64, device=dev)
    t_en, t_ex = _slab(tree.lo[node], tree.hi[node], o_l, inv)
    keep = torch.maximum(t_en, tmin_l) <= torch.minimum(t_ex, capl)
    pair, node = pair[keep], node[keep]
    leaf_pairs, leaf_nodes = [], []
    while pair.numel():
        is_leaf = tree.left[node] < 0
        leaf_pairs.append(pair[is_leaf])
        leaf_nodes.append(node[is_leaf])
        pair, node = pair[~is_leaf], node[~is_leaf]
        pair = pair.repeat_interleave(2)
        node = torch.stack([tree.left[node], tree.right[node]], 1).view(-1)
        t_en, t_ex = _slab(tree.lo[node], tree.hi[node], o_l[pair],
                           inv[pair])
        keep = (torch.maximum(t_en, tmin_l[pair])
                <= torch.minimum(t_ex, capl[pair]))
        pair, node = pair[keep], node[keep]
    pair = torch.cat(leaf_pairs) if leaf_pairs else node
    leaf = torch.cat(leaf_nodes) if leaf_nodes else node
    step = TESTS // LEAF
    for k in range(0, pair.numel(), step):
        pk, lk = pair[k:k + step], leaf[k:k + step]
        t_w, slot = _leaf_tests(tree, o_l, d, tmin_l, tmax, scl, pk, lk)
        m = t_w.amin(1)
        # the lowest slot among a leaf's equal minima, then the lowest
        # slot among the lane's leaves at its minimum
        first = torch.argmax((t_w == m[:, None]).to(torch.uint8), dim=1)
        s = slot.gather(1, first[:, None]).squeeze(1)
        before = best
        best = best.scatter_reduce(0, pk, m, reduce="amin")
        win = (m == best[pk]) & torch.isfinite(m)
        none = tree.tris.shape[0]
        cand = torch.where(win, s, torch.full_like(s, none))
        low = torch.full((p,), none, dtype=torch.int64,
                         device=dev).scatter_reduce(0, pk, cand, reduce="amin")
        best_slot = torch.where(best < before, low,
                                torch.minimum(best_slot, low))
    found = torch.isfinite(best)
    slot = torch.clamp(best_slot, max=tree.tris.shape[0] - 1)
    return best, tree.slot_tri[slot], found


def closest(tree: Tree, n_tris: int, o, d, tmin, tmax, off, scl,
            any_hit: bool):
    """The mesh's closest hit (t [N], index [N] = instance x n_tris +
    triangle, valid [N]) or any-hit flags [N] over its instances (off
    [I, 3], scl [I]; one instance at (0, 0, 0) and 1 for a mesh in world
    space) for rays o, d [N, 3] in (tmin, tmax)."""
    n = o.shape[0]
    ni = off.shape[0]
    dev = o.device
    ray = torch.arange(n, device=dev).repeat(ni)
    inst = torch.arange(ni, device=dev).repeat_interleave(n)
    inv = 1.0 / scl[inst]
    o_l = (o[ray] - off[inst]) * inv[:, None]
    live = (tmax[ray] >= 0) & ~torch.isinf(tmin[ray]) & ~torch.isnan(
        tmin[ray])
    keep = live.nonzero().squeeze(1)
    ray, inst, o_l, inv = ray[keep], inst[keep], o_l[keep], inv[keep]
    t_w, tri, found = walk(tree, o_l, d[ray], tmin[ray] * inv, tmax[ray],
                           scl[inst], any_hit)
    if any_hit:
        hits = torch.zeros((n,), dtype=torch.int64, device=dev)
        return hits.index_add_(0, ray, found.to(torch.int64)) > 0
    t = torch.full((n,), math.inf, dtype=o.dtype, device=dev)
    t = t.scatter_reduce(0, ray, t_w, reduce="amin")
    # the lowest instance among those at the minimum
    win = (t_w == t[ray]) & torch.isfinite(t_w)
    code = torch.where(win, inst * n_tris + tri,
                       torch.full_like(tri, ni * n_tris))
    index = torch.full((n,), ni * n_tris, dtype=torch.int64, device=dev)
    index = index.scatter_reduce(0, ray, code, reduce="amin")
    valid = torch.isfinite(t)
    return t, torch.where(valid, index, torch.zeros_like(index)), valid
