"""jet_pbrt_tpu_torch — the path tracer of jet_pbrt_tpu on PyTorch and CUDA.

The same renderer as the JAX package beside it, which stays the reference:
scene building, per-lane shading math and the integrators are plain
PyTorch; BVH traversal and the random streams' Threefry hash are CUDA
kernels written for Hopper (csrc/), built with nvcc at first use, each
with a plain PyTorch version as its CPU route and oracle. Entry points
(render, render_resumable, render_sharded, `python -m
jet_pbrt_tpu_torch.cli`, entry.entry, entry.dryrun_multichip) run on the
card unless the caller asks for the CPU (device="cpu", --device cpu).

Layout mirrors the reference package:
  ops/      linalg, rng (jax.random's streams), sampling, fresnel,
            microfacet, bsdf, intersect, lights, bvh (host build),
            wide_bvh (8-wide traversal), sweep_bvh (cull-sweep
            traversal), sort (the ray sort)
  scene/    pack, builder, scenes, convert (reference scene -> port),
            objio (OBJ I/O), assets (the bunny generator)
  models/   camera, integrators (path, Whitted, debug normals), film,
            render, graph (CUDA graphs of waves and gradients)
  diff/     params (value_and_grad, compile_value_and_grad, fit),
            gradcheck
  parallel/ mesh (a (px, spp) DeviceMesh over ranks), render (sharded
            frames), train (the distributed fit), multihost
            (torch.distributed init, host-aware meshes, scaling report,
            spawn): one process per device over torch.distributed
  scripts/  the harnesses: sweep_prims (the sweep's primitives),
            prim_micro (the wide kernel's primitive probes)
  utils/    cuda_build (nvcc + ctypes), native (ctypes bridge to the C++ host
            library), image (BMP / PPM / HDR), log, checkpoint
  csrc/     CUDA sources: wide_bvh, sweep_bvh, sweep_prims, prim_micro,
            threefry
  cli.py    the command-line renderer
  entry.py  entry points: one wave; one sharded train step
"""
import torch

__version__ = "0.1.0"

# Geometry is float32 end to end and ray/triangle decisions hinge on the
# last bits: TF32 (about three decimal digits) must never stand in for a
# float32 product, whatever a caller set before importing this package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
