"""Bounding-volume hierarchy: host-side build and flattened skip-link layout.

Numpy counterpart of the host half of jet_pbrt_tpu/ops/bvh.py (whose module
imports JAX). Nodes are flattened in DFS preorder with a miss (skip) link;
leaves hold exactly `leaf_size` triangle slots, padded by duplicating the
leaf's last triangle. Traversal lives in ops/wide_bvh.py, over 8-wide
nodes collapsed from this layout.
"""
from __future__ import annotations

import sys

import numpy as np

from ..utils.native import try_build_bvh_native

LEAF_SIZE = 4


def build_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
              leaf_size: int = LEAF_SIZE):
    """Build a BVH over triangles and flatten it: the native binned-SAH
    builder (native/bvh_build.cc through ctypes) when it is built, else the
    numpy median split. Both emit ((bmin, bmax, miss, leaf_first,
    leaf_count), order)."""
    out = try_build_bvh_native(p0, p1, p2, leaf_size, use_sah=True)
    if out is not None:
        return out
    return _build_bvh_median(p0, p1, p2, leaf_size)


def build_box_bvh(bmin_in: np.ndarray, bmax_in: np.ndarray,
                  leaf_size: int = LEAF_SIZE):
    """Median-split BVH over boxes. Returns ((bmin, bmax, miss, leaf_first,
    leaf_count), order) where `order` makes every leaf's boxes contiguous
    and exactly leaf_size long; leaf_first = -1 marks inner nodes."""
    box_min = np.asarray(bmin_in, np.float32)
    box_max = np.asarray(bmax_in, np.float32)
    centers = 0.5 * (box_min + box_max)

    # pass 1: the tree as rows [bmin, bmax, left, right, indices, n_nodes]
    tree = []

    def rec(idx: np.ndarray) -> int:
        row = len(tree)
        tree.append([box_min[idx].min(0), box_max[idx].max(0), -1, -1, None, 1])
        if len(idx) <= leaf_size:
            tree[row][4] = idx
            return row
        bb = tree[row]
        axis = int(np.argmax(bb[1] - bb[0]))
        ordered = idx[np.argsort(centers[idx, axis], kind="stable")]
        half = len(ordered) // 2
        left = rec(ordered[:half])
        right = rec(ordered[half:])
        tree[row][2] = left
        tree[row][3] = right
        tree[row][5] = 1 + tree[left][5] + tree[right][5]
        return row

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(np.arange(len(box_min)))
    finally:
        sys.setrecursionlimit(old_limit)

    # pass 2: DFS-preorder flatten with skip (miss) links
    n_nodes = tree[0][5]
    bmin = np.zeros((n_nodes, 3), np.float32)
    bmax = np.zeros((n_nodes, 3), np.float32)
    miss = np.zeros((n_nodes,), np.int32)
    leaf_first = np.full((n_nodes,), -1, np.int32)
    leaf_count = np.zeros((n_nodes,), np.int32)
    order: list[int] = []
    stack = [(0, n_nodes)]
    i = 0
    while stack:
        row, skip = stack.pop()
        bmin[i], bmax[i] = tree[row][0], tree[row][1]
        miss[i] = skip
        idx = tree[row][4]
        if idx is not None:
            leaf_first[i] = len(order)
            leaf_count[i] = len(idx)
            order.extend(list(idx) + [idx[-1]] * (leaf_size - len(idx)))
        else:
            left, right = tree[row][2], tree[row][3]
            # LIFO: push right first so left is emitted at i+1
            stack.append((right, skip))
            stack.append((left, i + 1 + tree[left][5]))
        i += 1
    return (bmin, bmax, miss, leaf_first, leaf_count), np.asarray(order, np.int64)


def _build_bvh_median(p0, p1, p2, leaf_size: int = LEAF_SIZE):
    """Median-split BVH over triangle boxes, thin boxes padded like
    CheckThinness (reference: src/geometry.h:299-304)."""
    tri_bmin = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tri_bmax = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    thin = (tri_bmax - tri_bmin) < 1e-4
    tri_bmin = np.where(thin, tri_bmin - 1e-4, tri_bmin)
    tri_bmax = np.where(thin, tri_bmax + 1e-4, tri_bmax)
    return build_box_bvh(tri_bmin, tri_bmax, leaf_size)


def pack_node_table(bvh, order_len: int, leaf_size: int = LEAF_SIZE):
    """[B,8] node rows: bmin.xyz, bmax.xyz, miss link, leaf code
    (leaf_first / leaf_size * 32 + count; -1 for inner nodes)."""
    bmin, bmax, miss, leaf_first, leaf_count = bvh
    if leaf_size > 31:
        raise ValueError("leaf count field is 5 bits")
    n_leaves = order_len // leaf_size
    if 32 * n_leaves + 32 >= 2 ** 24:
        raise ValueError(f"{n_leaves} leaves overflow the f32 leaf-code "
                         "encoding")
    leaf_code = np.where(leaf_first >= 0,
                         (leaf_first // leaf_size) * 32 + leaf_count,
                         -1).astype(np.float32)
    return np.concatenate(
        [bmin, bmax, miss[:, None].astype(np.float32), leaf_code[:, None]],
        axis=1).astype(np.float32)


def unpack_node_table(nodes: np.ndarray, leaf_size: int):
    """Inverse of pack_node_table: [B,8] rows -> the (bmin, bmax, miss,
    leaf_first, leaf_count) tuple."""
    nodes = np.asarray(nodes, np.float32)
    code = nodes[:, 7].astype(np.int64)
    leaf = code >= 0
    leaf_first = np.where(leaf, (code // 32) * leaf_size, -1).astype(np.int32)
    leaf_count = np.where(leaf, code % 32, 0).astype(np.int32)
    return (np.ascontiguousarray(nodes[:, 0:3]),
            np.ascontiguousarray(nodes[:, 3:6]),
            nodes[:, 6].astype(np.int32), leaf_first, leaf_count)
