"""Micro-benchmarks of the wide kernel's primitives on the card:
`python -m jet_pbrt_tpu_torch.scripts.prim_micro [probe ...]`.

Counterpart of the reference harness scripts/prim_micro.py. Each probe is a
scalar recurrence `acc` over REPS dependent iterations, written to all of
out [8, 8, 128] f32 by a grid of 8 blocks (csrc/prim_micro.cu). With no
arguments the default probes m1 m4 b1 r1 x8 f1 f3 mt run on the card, each
timed with CUDA events over RUNS = 10 launches after a warm-up, and one line
`name: X ns/iter` is printed per probe. X is ns per dependent iteration,
event time / runs / REPS: the 8 blocks run at the same time on 8 SMs, so
it is not divided by 8 as the reference divides its sequential TPU grid.

  m1   acc += t[0, 37i % 1100]                        (bf16 table)
  m4   the same for 4 indices (37i + 263j) % 1100, added one by one
  b1   the 4 fetched values summed first, then added
  r1   s = sum_k min(k + acc) over a 128-lane tile; acc += s * 1e-9
  x8   s = sum_{k<8} t[k, blk]; acc += s * 1e-9
  x32  s = sum_{k<8, l<4} t[k, blk + l]; acc += s * 1e-9
  r2   s = sum_k min(t[6k:6k+8, blk:blk+128] + acc); acc += s * 1e-9
  srt  the bit patterns of t[:8, blk], sorted by a 19-comparator network,
       stored to smem[8 (i % 4) + k] and summed in int32 (wrapping)
  f1   acc += t[0, 37i % 4200]                        (f32 table)
  f3   acc += t[0, idx] + t[144, idx] + t[288, idx]   (bf16 planes)
  mt   16 Moller-Trumbore tests on rows all equal to 0.5 + acc;
       acc += min t * 1e-9 (every determinant is 0, so acc = inf)
with blk = ((37i % 1100) // 128) * 128. The tables are drawn as the
reference draws them: tb_bf16 [48, 1152] bf16, tf32 [144, 4224] f32 and
tb3 [432, 4224] bf16, in that order from default_rng(0). The CPU runs only
when asked (`main(device="cpu")`), and there the plain versions run.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import INT, PTR
from ..ops.linalg import fma32

REPS = 2048
RUNS = 10            # timed launches per probe, after one warm-up
GRID, ROWS, LANES = 8, 8, 128
PROBES = ("m1", "m4", "b1", "r1", "x8", "x32", "r2", "srt", "f1", "f3", "mt")
DEFAULT = ("m1", "m4", "b1", "r1", "x8", "f1", "f3", "mt")
# the table each probe is given (the reference's registry, prim_micro.py:236-241)
TABLE_OF = dict(m1="tb_bf16", m4="tb_bf16", b1="tb_bf16", r1="tb_bf16",
                x8="tb_bf16", x32="tb_bf16", r2="tb_bf16", srt="tb_bf16",
                f1="tf32", f3="tb3", mt="tf32")
TABLES = {"tb_bf16": ((48, 1152), torch.bfloat16),
          "tf32": ((144, 4224), torch.float32),
          "tb3": ((3 * 144, 4224), torch.bfloat16)}
# reps above this would overflow the int32 index arithmetic (37i + 263j)
MAX_REPS = 1 << 24
SORT8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
         (2, 4), (3, 5), (3, 4))


_LIB = kernels.Library("prim_micro", ["prim_micro.cu"], {
    "prim_micro_launch": [INT, PTR, INT, PTR, PTR]})


def tables(device) -> dict[str, torch.Tensor]:
    """The reference's three tables, drawn in its order from default_rng(0)
    (float32 rounded to nearest even for the bf16 ones), on `device`."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (shape, dtype) in TABLES.items():
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        out[name] = x.to(dtype).to(device)
    return out


@kernels.wrapper("prim_micro_kernel")
def prim_micro(probe: str, table: torch.Tensor, reps: int) -> torch.Tensor:
    """One probe's out [8, 8, 128] f32 over `reps` iterations: the kernel of
    csrc/prim_micro.cu for a CUDA table, `prim_micro_plain` for a CPU one."""
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; probes are {PROBES}")
    shape, dtype = TABLES[TABLE_OF[probe]]
    if table.dtype != dtype or tuple(table.shape) != shape \
            or not table.is_contiguous():
        raise ValueError(f"{probe}: expected a contiguous {dtype} {shape} "
                         f"table, got {table.dtype} {tuple(table.shape)}")
    if not 0 <= reps <= MAX_REPS:
        raise ValueError(f"reps must lie in [0, {MAX_REPS}], got {reps}")
    if not kernels.route("prim_micro", table.device):
        return prim_micro_plain(probe, table, reps)
    if table.data_ptr() % 16:
        raise ValueError(f"{probe}: the kernel stages the table in 16-byte "
                         "words; it must be 16-byte aligned")
    out = torch.empty((GRID, ROWS, LANES), dtype=torch.float32,
                      device=table.device)
    kernels.launch(prim_micro, table.device, _LIB.load().prim_micro_launch,
                   PROBES.index(probe), table.data_ptr(), reps,
                   out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# plain versions: float32 tensor ops in the reference's order
# ---------------------------------------------------------------------------

def _update(acc, s, c9):
    """acc + s * 1e-9 as one fused multiply-add: XLA contracts it in the
    reference's loop body (its interpret mode on the CPU rounds it once;
    rounded twice, x8, x32 and srt drift from it by an ulp)."""
    return fma32(s, c9, acc)


def _blk(i: int) -> int:
    return ((i * 37) % 1100 // 128) * 128


def _lane_min_sum(tiles, acc, zero, c9):
    """sum_k min over tile k + acc, in k order; then acc + s * 1e-9."""
    s = zero
    for x in tiles:
        s = s + (x + acc).amin()
    return _update(acc, s, c9)


def _mt_step(acc, zero, c9, d0, half, eps, one, inf):
    """16 Moller-Trumbore tests on rows all equal to 0.5 + acc (one lane:
    the reference's 128 lanes are equal), acc + min t * 1e-9."""
    r = half + acc
    t_min = None
    for _ in range(16):
        row = [r] * 9
        px = d0 * row[8] - d0 * row[7]
        py = d0 * row[6] - d0 * row[8]
        pz = d0 * row[7] - d0 * row[6]
        det = row[3] * px + row[4] * py + row[5] * pz
        invd = torch.where(det.abs() > eps, one / det, zero)
        tx, ty, tz = d0 - row[0], d0 - row[1], d0 - row[2]
        uu = (tx * px + ty * py + tz * pz) * invd
        qx = ty * row[5] - tz * row[4]
        qy = tz * row[3] - tx * row[5]
        qz = tx * row[4] - ty * row[3]
        vv = (d0 * qx + d0 * qy + d0 * qz) * invd
        tt = (row[6] * qx + row[7] * qy + row[8] * qz) * invd
        ok = (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 0)
        tw = torch.where(ok, tt, inf)
        t_min = tw if t_min is None else torch.minimum(t_min, tw)
    return _update(acc, t_min, c9)


def prim_micro_plain(probe: str, table: torch.Tensor,
                     reps: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: the probe's recurrence as a
    Python loop of float32 tensor ops in the reference's order, on the
    table's device."""
    dev = table.device
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    zero, c9 = f(0.0), f(1e-9)
    t = table.float()
    acc = zero
    if probe in ("m1", "f1"):
        n = 1100 if probe == "m1" else 4200
        for i in range(reps):
            acc = acc + t[0, (i * 37) % n]
    elif probe == "m4":
        for i in range(reps):
            for j in range(4):
                acc = acc + t[0, (i * 37 + j * 263) % 1100]
    elif probe == "b1":
        for i in range(reps):
            s = zero
            for j in range(4):
                s = s + t[0, (i * 37 + j * 263) % 1100]
            acc = acc + s
    elif probe == "r1":
        ks = [torch.full((ROWS, LANES), float(k), dtype=torch.float32,
                         device=dev) for k in range(8)]
        for _ in range(reps):
            acc = _lane_min_sum(ks, acc, zero, c9)
    elif probe in ("x8", "x32"):
        cols = 1 if probe == "x8" else 4
        for i in range(reps):
            b = _blk(i)
            s = zero
            for k in range(8):
                for col in range(cols):
                    s = s + t[k, b + col]
            acc = _update(acc, s, c9)
    elif probe == "r2":
        for i in range(reps):
            base = t[:, _blk(i):_blk(i) + LANES]
            # rows 6k..6k+7, cut at the table's 48 rows for k = 7
            acc = _lane_min_sum([base[6 * k:6 * k + 8] for k in range(8)],
                                acc, zero, c9)
    elif probe == "srt":
        smem = torch.zeros(64, dtype=torch.int32, device=dev)
        bits = t.view(torch.int32)
        for i in range(reps):
            kv = [bits[k, _blk(i)] for k in range(8)]
            for a, b in SORT8:
                kv[a], kv[b] = torch.minimum(kv[a], kv[b]), \
                    torch.maximum(kv[a], kv[b])
            for k in range(8):
                smem[8 * (i % 4) + k] = kv[k]
            # int32 wraparound, made explicit in int64
            s = sum(x.long() for x in kv)
            s = ((s + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
            acc = _update(acc, s.float(), c9)
    elif probe == "f3":
        for i in range(reps):
            idx = (i * 37) % 4200
            tr = zero
            for p in range(3):
                tr = tr + t[144 * p, idx]
            acc = acc + tr
    elif probe == "mt":
        consts = (f(0.3), f(0.5), f(1e-12), f(1.0), f(float("inf")))
        for _ in range(reps):
            acc = _mt_step(acc, zero, c9, *consts)
    else:
        raise ValueError(f"unknown probe {probe!r}")
    return acc.expand(GRID, ROWS, LANES).contiguous()


def main(probes=None, device: str = "cuda"):
    """Time each probe (default: DEFAULT) at REPS iterations on `device`
    and print `name: X ns/iter`; returns ({probe: ns per iteration},
    {probe: out of its last timed run}). On the card the kernel is timed
    with CUDA events over RUNS launches after one warm-up launch; on the
    CPU the plain version is timed by the host clock and nothing is
    launched."""
    names = list(probes or DEFAULT)
    bad = [p for p in names if p not in PROBES]
    if bad:
        raise ValueError(f"unknown probes {bad}; probes are {PROBES}")
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    where = torch.cuda.get_device_name(device) if cuda else "CPU, plain"
    tabs = tables(device)
    print(f"# {where}: ns per dependent iteration = time / {RUNS} runs / "
          f"REPS {REPS} (the {GRID} blocks run at once: not divided by "
          f"{GRID})", flush=True)
    result, outs = {}, {}
    for name in names:
        table = tabs[TABLE_OF[name]]
        run = lambda: prim_micro(name, table, REPS)
        run()
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(RUNS):
                outs[name] = run()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(RUNS):
                outs[name] = run()
            secs = time.perf_counter() - t0
        result[name] = secs / RUNS / REPS * 1e9
        print(f"{name}: {result[name]:8.1f} ns/iter", flush=True)
    return result, outs


if __name__ == "__main__":
    main(sys.argv[1:] or None)
