"""Check the cull-sweep's primitives on the card:
`python -m jet_pbrt_tpu_torch.scripts.sweep_prims`.

Counterpart of the reference harness scripts/sweep_prims.py: one small
kernel (csrc/sweep_prims.cu) computes what the reference's kernel `kern`
computes, out = a^T b + s for a, b [4, 128], with a^T b a chain of fused
multiply-adds over k = 0..3 (XLA's CPU contraction) and
s = w[0] + w[8] + w[120], where w[j] = min(k[(j-7 .. j) mod 128]) is the
trailing-window minimum of row 0 of a^T b that the kernel's three lane
rolls leave in lane j (`pltpu.roll` follows `jnp.roll`). The reference
harness's own numpy oracle takes aligned 8-lane blocks instead and
disagrees with its kernel; the port follows the kernel. The result is held
against a numpy evaluation of that function. Prints "all primitives OK".
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import PTR
from ..ops.linalg import fma32

K, L = 4, 128
_LIB = kernels.Library("sweep_prims", ["sweep_prims.cu"],
                       {"sweep_prims_launch": [PTR, PTR, PTR, PTR]})


@kernels.wrapper("sweep_prims_kernel")
def sweep_prims(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b + s ([128, 128] f32) of a, b [4, 128] f32: the kernel for CUDA
    tensors, `sweep_prims_plain` for CPU tensors."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32 or tuple(x.shape) != (K, L) \
                or not x.is_contiguous() or x.device != a.device:
            raise ValueError(f"{name}: expected contiguous float32 [{K}, {L}] "
                             f"on {a.device}")
    if not kernels.route("sweep_prims", a.device):
        return sweep_prims_plain(a, b)
    out = torch.empty((L, L), dtype=torch.float32, device=a.device)
    kernels.launch(sweep_prims, a.device, _LIB.load().sweep_prims_launch,
                   a.data_ptr(), b.data_ptr(), out.data_ptr())
    return out


def sweep_prims_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the fused multiply-add chain,
    then the trailing-window minima of row 0 at lanes 0, 8 and 120."""
    o = a[0, :, None] * b[0, None, :]
    for k in range(1, K):
        o = fma32(a[k, :, None], b[k, None, :], o)
    win = torch.stack([torch.roll(o[0], sh) for sh in range(8)]).amin(0)
    return o + (win[0] + win[8] + win[120])


def oracle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The same function in numpy, float64 products rounded once to
    float32 per multiply-add."""
    o = (a[0, :, None] * b[0, None, :]).astype(np.float32)
    for k in range(1, K):
        o = (a[k, :, None].astype(np.float64) * b[k, None, :]
             + o).astype(np.float32)
    win = np.stack([np.roll(o[0], sh) for sh in range(8)]).min(axis=0)
    return o + (win[0] + win[8] + win[120])


# lanes on both sides of the windows' edges at lanes 0, 8 and 120 (the
# windows are 121..0, 1..8 and 113..120)
TIE_LANES = (127, 1, 121, 120, 113, 112, 8, 9)


def inputs(seed: int, ties: bool = False):
    """a, b [4, 128] float32 normals from `seed`; with `ties`, the key of
    lane 0 (row 0 of a^T b) is made the row's minimum and copied exactly to
    TIE_LANES, so every window's minimum is tied across its edges."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(K, L)).astype(np.float32)
    b = rng.normal(size=(K, L)).astype(np.float32)
    if ties:
        b[:, 0] = -3.0 * np.sign(a[:, 0])
        b[:, TIE_LANES] = b[:, :1]
    return a, b


def main(device: str = "cuda") -> float:
    """Run the primitives once on `device` against the oracle, which they
    must equal bit for bit; returns the max |error|."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    a, b = inputs(0)
    r = sweep_prims(torch.from_numpy(a).to(device),
                    torch.from_numpy(b).to(device)).cpu().numpy()
    want = oracle(a, b)
    np.testing.assert_array_equal(r, want)
    print("all primitives OK", flush=True)
    return float(np.abs(r - want).max())


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
