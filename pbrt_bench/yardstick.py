"""The benchmark's fixed measures: the card's published peaks, the bytes a
kernel's function must move, and the profiler's discarded warm-up.

Frozen copies, so that a later change to the program cannot move them:

- `vertex_bytes`: chip_smoke.py::vertex_bytes at commit 77f45ea (the path
  vertex's inputs read once and outputs written once), with the scene's
  table sizes passed as numbers. For the bunny's 2^20-lane bounce-1 vertex
  with 2 NEE lights it gives 250,610,270 B; without the next cast's bounds
  (8 B a lane) and the ray counters' 4 B, which the vertex writes since
  commit e37a076, 242,221,658 B, the count chip_smoke made before them.
- `vertex_backward_bytes`: chip_smoke.py::grad_bytes("vertex_backward")
  at commit 77f45ea: 135,499,776 B for the bunny's bounce-1 vertex (129 B a
  lane and the 1,024 x 57 partial sums), plus grad_reduce's read of the
  partials and write of the slots (`grad_reduce_bytes`).
- `PROFILER_WARMUP_S`: chip_smoke.py at commit 77f45ea. The profiler drops
  the records of the first launches after its trace starts, so a traced
  run first traces a warm-up step of at least this long, which the
  profiler's schedule discards.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
PROFILER_WARMUP_S = 0.02

# csrc/shade.cuh's light table row widths (ops/shade.py TABLE_W, STATIC_W)
TABLE_W = 32
STATIC_W = 5
# csrc/shade_grad.cu: lanes a block lists, the grid's cap, and the slots
# beyond which the partial sums move to device-memory warp rows
SPAN = 1024
MAX_GRID = 1024
SMEM_SLOTS = 2560
WARPS = 4


def table_bytes(n_mats: int, n_light_rows: int, em_rows: int,
                nee_lights: int) -> int:
    """The material table (kind, c0, c1, s0, s1, remap, texture, microfacet
    kind: 45 B a row), light_c (12 B a row), the emissive instances' raw
    triangles and normals (48 B a row), and the light table's rows and
    static part per NEE light, and the summed environment radiance."""
    return (n_mats * 45 + n_light_rows * 12 + em_rows * 48
            + nee_lights * (TABLE_W + STATIC_W) * 4 + 12)


def vertex_bytes(n: int, n_lights: int, nee_lights: int, tables: int,
                 last: bool, textured: bool = False,
                 bounds: bool = True) -> int:
    """Bytes one shade_vertex call over n lanes must move. n_lights: the
    scene's lights (its uniforms are 4 + 2 x n_lights a lane); nee_lights:
    those NEE samples (not black); tables: table_bytes(...)."""
    hit = 1 + 12 + 12 + 12 + 4 + 4 + (8 if textured else 0)
    state = 12 + 12 + 1 + 1 + 12 + 12
    if last:
        return n * (hit + 12 + 1 + 1 + 12 + 12) + tables
    u = 4 * (4 + 2 * n_lights)
    # the state, the next cast's bounds, per light its mask, contribution
    # and endpoint
    outs = (12 + 12 + 1 + 1 + 4 + 12 + 12 + (4 + 4 if bounds else 0)
            + nee_lights * (1 + 12 + 12))
    return n * (hit + state + u + outs) + tables + (4 if bounds else 0)


def partial_rows(n: int, slots: int) -> int:
    """Rows of vertex_backward's partial sums for n lanes and slots."""
    grid = min(math.ceil(n / SPAN), MAX_GRID)
    return grid * (WARPS if slots > SMEM_SLOTS else 1)


def vertex_backward_bytes(n: int, n_lights: int, nee_lights: int,
                          slots: int, last: bool,
                          textured: bool = False) -> int:
    """Bytes the transpose of one vertex must move: the hit, beta, active,
    prev_specular, the vertex's uniforms and shadow flags (not on the last
    bounce), gL and gbeta in, gbeta and the partial sums out."""
    hit = 1 + 12 + 12 + 12 + 4 + 4 + (8 if textured else 0)
    lane = hit + 12 + 1 + 1 + 12 + 12 + 12
    if not last:
        lane += 4 * (4 + 2 * n_lights) + nee_lights
    return n * lane + partial_rows(n, slots) * slots * 4


def grad_reduce_bytes(n: int, slots: int) -> int:
    """grad_reduce: the partial sums read, the slots written."""
    return partial_rows(n, slots) * slots * 4 + slots * 4


def bytes_ms(nbytes: float) -> float:
    """The least time, in ms, that moving nbytes takes at the HBM peak."""
    return nbytes / HBM_BYTES_PER_S * 1e3
