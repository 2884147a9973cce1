#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing its result; any failure raises and exits non-zero:
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: one nvcc per kernel library of jet_pbrt_tpu_torch/csrc, all
     started together (wide_bvh, sweep_bvh, sweep_prims, prim_micro,
     threefry, shade, brute, rays, wave, shade_grad, and shade.cu's
     operation-counting variant, COUNT_LIBRARY), with ptxas registers and
     spills;
  2b. the random streams' Threefry kernel (csrc/threefry.cu) against its
     plain version, bit for bit, at 2^20 lanes: the key words of
     lane_keys, and the [2^20, S] uniforms of vertex_uniforms and
     camera_jitter at the default bunny's S, on lanes in pixel order and
     permuted as the ray sort permutes them; both versions timed: the
     kernel by events, host enqueue and the profiler's device time, with
     its bound from the function's integer work (threefry_work) and, as a
     diagnostic, its SASS per lane (ALU-pipe, FMA-heavy-pipe and all
     instructions, and the opcode mix);
  2c. the fused path vertex (ops/shade.py, csrc/shade.cu): one eager
     1-spp wave of the default bunny and the Cornell box at 1024^2 (2^20
     lanes) and of a scene of every material, texture, light and shape
     kind (every_kind_scene) at 256^2 on the wide route and forced onto
     the sweep, and of a scene of 46 lights (many_lights_scene) at 256^2,
     each recording its depth + 1 shade_vertex and depth
     nee_accumulate calls (vertex_calls), each call held against its
     plain version on the same inputs, every output of every lane bit for
     bit (NaN equal to NaN; before them torch_rules prints how torch's
     CUDA sum over 3 and cross round), then each frame on the kernel
     route against the plain route's (plain_vertex), image and stats bit
     for bit; phase 7 does the same on the 600k bunny. The bunny's
     bounce-1 vertex and
     nee_accumulate timed: events, host enqueue, the profiler's device
     time (warm, and after an L2 flush each), the plain version, and the
     bound from the call's bytes and its float operations, counted on its
     inputs by the counting build (counted_ops);
  2d. the brute-force casts (ops/brute.py, csrc/brute.cu): the same five
     eager 1-spp waves, each recording its brute_hits calls (one per
     cast), each call held against brute_hits_plain on the same inputs,
     closest hit (every kind's t, index and valid) and any hit, bit for
     bit, the count of differing lanes printed; then edge sets built here
     (brute_edges): coincident duplicate triangles and spheres, rays aimed
     at the Cornell quads' shared diagonals and corners and the bunny's
     rects', dead lanes with NaN and inf directions, finite tmax, the
     lane compaction's cases (all-dead blocks, one live lane in a block,
     live lanes at a block's last slots, 257^2 lanes, NaN and inf
     directions on live lanes), an any-hit whose only hit is in the last
     tile, the triangle division's edges, a scene of more shapes than one
     shared-memory tile of each kind (many_shapes_scene) and its first 256
     and 257 shapes of each kind; the Cornell bounce-1 closest cast and
     its first shadow cast timed (events, host enqueue, the profiler's
     device time warm and after an L2 flush, the plain version), each
     against its bound: BRUTE_OPS per (lane, shape) test the function
     needs on these inputs (brute_work: every shape of a live lane in
     closest mode, each live lane's shapes up to its first hit in any-hit
     mode), one issued instruction each at the card's issue rate (none
     can be contracted into an FMA), against its bytes at HBM_BW, printed
     beside the same operations at F32_PEAK; and the Cornell 512^2
     16-spp and bunny 1024^2 4-spp frames on the kernel route against the
     plain route's (plain_brute), image and stats bit for bit;
  2e. the casts' set-up and the hit reconstruction (ops/rays.py,
     csrc/rays.cu): the same five eager 1-spp waves (and in phase 7 the
     600k bunny's), each recording its shadow_key, shadow_segments,
     occlusion_merge and hit_reconstruct calls (rays_wave: as many as
     rays_launches counts), each call held against its plain version on
     the same inputs, every output bit for bit, the count of differing
     lanes printed; edge sets (rays_edges) on the Cornell box (no BVH
     root), the bunny (instances scaled by 500), the every-kind scene
     (0.8, 0.3) and a scene of 16 instanced families (19 kinds a closest
     cast) at 65,536 and 2^20 + 1 lanes: masked lanes, zero-length
     segments, NaN and inf endpoints, inactive lanes of the bounce key,
     one, three and 17 flags merged sorted and not, seeded hits of every kind
     with misses, NaN t, ties across kinds, indices past either end of
     their tables and NaN directions; the bunny wave's calls at 2^20
     lanes timed (time_rays: the first sorted shadow cast's key,
     segments and merge, the first bounce sort's key, the bounce-1
     closest cast's reconstruction; events, host enqueue, the profiler's
     device time warm and after an L2 flush, the plain version), each
     against its bytes at HBM_BW (rays_bytes) and beside the PyTorch
     calls that compute the same function, as yardsticks (rays_library:
     out[perm] = occ and argsort-then-gather for the merge, an
     index_select of the packed [N, 8] segments for the segments); and
     the Cornell 512^2 16-spp, bunny 1024^2 4-spp and 16-family 256^2
     2-spp frames against the plain versions' (plain_rays), image and
     stats bit for bit;
  2f. the wave's glue (ops/wave.py, csrc/wave.cu): the same five eager
     1-spp waves (and in phase 7 the 600k bunny's), each recording its
     camera_rays, permute_state and unsort_guard calls (wave_glue_calls:
     as many as wave_launches counts), each held against its plain
     version on the same inputs, every row bit for bit; edge sets
     (wave_edges) at 1, 1,000 and 2^20 + 1 lanes: pixel ids from 0 and
     past 2^24 on a film of odd width under the random, stratified and
     debug samplers' jitter, states with NaN and inf colours and dead
     lanes permuted by the identity, a reversal and a seeded perm with
     their LaneKeys and with the debug sampler's uniforms, the un-sort by
     those perms and without a sort; the bunny wave's calls at 2^20 lanes
     timed (time_wave: events, host enqueue, the profiler's device time
     warm and after an L2 flush, the plain version, the bytes bound, and
     the yardsticks of wave_library: the permute's eleven gathers and one
     index_select of the packed state, the un-sort's index_put_ and
     L[argsort(lane)]); the Cornell 512^2 16-spp and bunny 1024^2 4-spp
     frames and the bunny's debug- and stratified-sampler frames against
     the plain versions' (plain_wave) and the plain glue's (plain_glue),
     image and stats bit for bit;
  2g. the gradient's kernels (ops/shade.py, csrc/shade_grad.cu:
     vertex_backward and grad_reduce; csrc/wave.cu: permute_state_backward
     and unsort_guard_backward): the kernel's tangent table against
     ops/shade.py's (check_tangents); the forward of one differentiated
     1-spp wave of the five 2c scenes, the 16-family scene, the textured
     floor (image and checker) and the many-slots scene (more parameter
     slots than a block's shared memory holds), every appearance field on
     the tape
     (grad_wave_calls: as many vertex, permute and un-sort calls as
     grad_launches counts), each call's backward on the kernels against
     its plain version for seeded upstream gradients (check_grad_calls:
     d loss / d beta per lane within rtol 1e-5 or explained by a float64
     recomputation of the lane, each field within 1e-4 of its largest
     |gradient| (where the whole wave's plain backward is NaN, over the
     lanes where own_branch_plain's is a number, the others printed with
     the kernel's finite values), the permute's and un-sort's bit for bit,
     grad_reduce bit for bit); edge sets (grad_edges) at 1, 1,000 and 2^20
     + 1 lanes; the bunny's timed at 2^20 lanes (time_grads: events, host
     enqueue, the profiler's device time warm and after an L2 flush, the
     plain version, the bytes bound against the forward vertex's float
     operations, and the PyTorch yardsticks torch.sum and index_add_ for the
     reduction, index_copy_ for the permute's backward); the many-slots
     scene's value_and_grad on the kernels against the plain route
     (many_slots_grads);
  3. wide kernel vs its plain PyTorch version on the default bunny's
     tables (66k-row BLAS, 4 instances), on about 65k rays (half primary,
     half bounce) and a targeted incoherent set, closest hit and any hit
     with finite tmax: t, index and valid must agree bit for bit on every
     lane (the count of disagreeing lanes is printed, each one put through
     the float64 forensic before the run fails); then both timed at the
     main path's wave size (2^20 rays: a wave and a targeted set), their
     outputs held against each other the same way, the kernel's event time
     beside the profiler's device time of the same calls, and the kernel's
     counted node and leaf visits held equal to the plain walk's, which
     give each timed closest-hit call its bound; the counters' SIMD
     efficiency and lane-0 cycle split are printed, and the walk's resident
     blocks per SM;
  4. main path: render(bunny_scene(), 1024, 1024, spp=4, max_depth=5,
     device="cuda"), its waves replayed from the CUDA graph a 1-spp
     frame of the same key captured with graph=True (models/graph.py),
     under a profiler trace: the launch counters (a replay counts its
     graph's kernel nodes) exact for the wide kernel and the Threefry
     kernel, and equal to the launches the trace recorded by kernel
     name, which the kernels line reports; rays/s by class (the wall
     under the trace), peak memory, and a profiled 1-spp eager wave with
     the streams drawn by the plain version (the wave before the Threefry
     kernel; phase 13 profiles the replayed and eager waves); then the 16
     wide casts of one eager 1-spp wave, recorded (o, d, tmin, tmax) by wrapping
     wide_bvh.intersect_wide here, each replayed alone: live lanes,
     survivors of the cull, kernel event time, host enqueue time and
     profiler device time, the plain version's output held bit for bit,
     and the sums, with what could stall the host (collector passes,
     cudaMalloc and cudaFree calls) during the timed calls;
  5. converged goldens (bunny 64^2 and Cornell 48^2) under the reference
     tests' statistical gates, and the exact-seed Cornell 16^2 golden
     (tests/golden/cornell_smoke_16.npz): the pixels outside rtol 1e-4 /
     atol 1e-5 are printed and counted against EXACT_SEED_MAX_OFF, the mean
     held within 1e-3 relative;
  6. sweep kernel vs its plain version, as phase 3, on the meshes too big
     for the reference's wide-kernel budget: the instanced bunny of the
     600k-target OBJ and the soup of four copies of the 150k-target OBJ
     (generated under assets/ at first use); then both timed and held
     against each other on a 2^20-ray wave, whose needed culls and
     ray-group tests `sweep_work_plain` counts from the inputs (its bound),
     printed beside the kernel's counters and its cull / scan cycle split;
     the kernel's resident blocks per SM at 4,096 and 8,192 groups;
  7. main path on the sweep route: render(bunny_scene(bunny_path=<600k
     OBJ>), 1024, 1024, spp=4, max_depth=5, device="cuda") with the exact
     sweep launch count and no wide launch, rays/s, peak memory, build
     time (the counted frame traced as in phase 4), and the sweep's group
     tests per packet on one
     1-spp wave with sort_rays on and off (each captured first), whose
     images must be bit-identical;
  8. the sweep primitives harness (scripts/sweep_prims.py) through its
     entry point, and its kernel against its plain version and the oracle
     bit for bit on six inputs (two with keys tied across the window
     edges); its events, enqueue and device time;
  9. the wide kernel's primitive probes (scripts/prim_micro.py): its entry
     point times all 11 probes at REPS = 2048 (ns per dependent
     iteration), with the exact launch count; the output of every probe's
     timed launches is held against its plain version at REPS bit for bit
     (mt equal to inf), the plain version timed there;
 10. the command line: `python -m jet_pbrt_tpu_torch.cli 1 4 --size 1024`
     in a subprocess, whose BMP must equal utils.image.write_bmp of
     render(bunny_scene(), 1024, 1024, 4, seed=0) here byte for byte; then
     Cornell 256^2 through cli.main under --integrator whitted, debug,
     --sampler stratified, --mis and --format ppm / hdr, each file read
     back finite with its wall time; and a render_resumable stopped after 2
     of 4 samples and resumed, equal bit for bit to the uninterrupted one;
 11. the differentiable path (diff_phase): render_fn on the default bunny
     at 1024^2, 1 spp, depth 5, equal to render(clamp=False) bit for bit,
     the fused wave's launches forward (expected_launches: 16 wide, 16
     brute_hits, 7 Threefry, 6 shade_vertex, 5 nee_accumulate, the rays'
     and the glue's) and exactly the backward kernels' backward
     (grad_launches: 11 vertex_backward, two tangent sets a vertex below
     depth 5 and one on the last, 6 grad_reduce, 3
     permute_state_backward, 1 unsort_guard_backward), each run's
     gradient bit for bit with the first's, forward and
     backward times, their ratio and the tape's peak memory, the profiled
     backward with every device operation listed, and forward, backward
     and peak memory in turns with the plain route (plain_grad), each
     plain gradient within 1e-4 of the kernels'; check_grads on the
     emission (depth 5) and the red bunny's albedo (depth 2); the graphed
     value_and_grad (compile_value_and_grad, one CUDA graph of forward and
     backward): its kernel nodes one forward's and one backward's
     launches, its loss and gradient bit for bit with eager's (under
     deterministic algorithms too), wall in turns, device time and busy
     share, capture seconds and pool bytes; fits graphed and eager in
     turns, ms per step with the capture step apart, bit for bit under
     deterministic algorithms; texel and checker-colour gradients against
     finite differences with their launches exact (texture_grads); one
     {"diff": ...} JSON line.
 12. sharded render and train (sharded_phase, parallel/): (a) a world of
     one rank over NCCL (multihost.initialize), mesh (1, 1): render_sharded
     of the default bunny at 1024^2, 4 spp, depth 5 equal to render_fn's
     frame bit for bit, 64 wide and 28 Threefry launches, its wall time and
     rays/s in turns with render()'s frame (medians of 3), peak memory; (c)
     build_train_step at (1, 1), 1 spp, graphed (its partial film and that
     film's backward replayed from two CUDA graphs of one pool) and eager
     in turns, ms per step with the capture step apart: the partial film's
     forward launches (sharded_launches) and its backward's (sharded_grad:
     the backward kernels), the graphs' kernel nodes the same, the first
     losses equal
     bit for bit and each route's loss falling; under deterministic
     algorithms the graphed step's loss and gradient equal the eager
     step's bit for bit, and the gradient lies within rtol 1e-6 of
     diff.params.value_and_grad's; (b) 4
     gloo ranks spawned to share the card (card_rank), scene and kernels
     built here: meshes (2, 1) and (4, 1) equal to (a)'s frame bit for bit,
     (2, 2) and (1, 4) within atol 2e-4, exact launches per rank, every
     rank's partial film equal bit for bit to its samples' single-card
     waves on its block, the first wave's Threefry draws and brute-force
     casts (and on (4, 1) its 16 wide casts) equal to the plain versions'; (2, 1) graphed train
     losses within 1e-5 relative of (1, 1)'s; (d) scaling_report at 1, 2
     and 4 ranks (ranks sharing one card: a check of the machinery, not of
     scaling); each rank's cached graphs (lanes, pool bytes) and gradient
     graphs' pool bytes; (e) entry.dryrun_multichip(4) on gloo ranks
     sharing the card, one graphed train step; one
     {"sharded": ...} JSON line, and the kernels line's
     wide_bvh and threefry entries carry the launches per rank of each
     layout ("sharded_launches": the (1, 1) world's counted frame traced
     as in phase 4, the gloo ranks' by the counters, where a replay counts
     its graph's kernel nodes). The sharded forward replays each rank's own
     CUDA graphs, captured by a graph=True frame before each counted one;
     the recorded partial films run the eager wave.
 13. the compiled wave (compiled_phase): on the default bunny and the
     600k-target bunny at 1024^2, 4 spp, and the Cornell box at 512^2, 16
     spp, depth 5: render(graph=True) against render(graph=False), images
     and stats bit for bit, exact launches per frame in both modes; the
     first frame on the default (fresh cache: each wave shape runs op by
     op for its first graph.CAPTURE_AFTER calls) and the first graph=True
     frame, with each captured wave's warm-up and capture times, graph
     pool bytes and its kernel nodes' launches; three frames of each in
     turns after a warm-up each,
     medians and rays/s, each mode's peak memory in a frame; the 1-spp
     wave replayed and eager, profiled (wall, device time and its source,
     busy share; the replayed wave's top operations by device time); the
     1-spp wave at 1024^2 split by li_path's record_function ranges
     (module_split: intersect, rng, vertex, occluded, nee_accumulate,
     sort, camera/init, between, end, render()'s frame), replayed and
     eager, with the kernels, the plain glue, the plain vertex, the plain
     brute-force casts and the plain casts' set-up and hit reconstruction
     in turns, each range's replayed operations and device ms by class
     (scripts/wave_nodes.py: port kernel, argsort, memset, copy, other)
     and the names of the others, and the host's ms per replay in
     graph._copy_in and graph.wave_key (host_replay_ms); the graphed frame
     and the profiled replayed 1-spp wave in turns with the plain glue
     (glue_turns); whether `import triton` works; one {"graph": ...}
     JSON line.
Phases 4, 7, 11, 12 and 13 count each frame's or gradient forward's
shade_vertex and nee_accumulate launches beside the others
(expected_launches, sharded_launches), and phases 11 and 12 their
backwards' kernels (grad_launches, sharded_grad). Every cast of a scene with a brute-force shape launches one
brute_hits, on every path, the gradients' forwards included (none in a
backward); so do ops/rays.py's kernels (rays_launches): one
hit_reconstruct per closest cast, one shadow_segments and one
occlusion_merge per shadow cast, and in a kernel-routed scene one
shadow_key per sorted shadow cast and per sort between bounces; and
ops/wave.py's (wave_launches): one camera_rays a wave on every path, and
on the fused vertex's route (gradients in the appearance fields
included) one permute_state per sort between bounces and one
unsort_guard a wave. Phase 13's module_split adds turns with
their plain versions (plain_rays) and with the plain glue (plain_glue).
Phases 4, 5, 7, 10, 11 and 12 run render() (and the sharded forward) on
graphed waves: graph=True, or the default once a graph=True frame has
captured the key; the recorders of kernel calls (phase 4's wide casts,
phase 12's partial films) and the plain-streams profile run the eager
wave, which is what they wrap, and phase 10's CLI frame of four waves
runs op by op, as the default does for a shape's first
graph.CAPTURE_AFTER waves.
The line before the last is the per-kernel JSON summary, each kernel with
its bound: the largest of its bytes (inputs read once, outputs written
once) at HBM_BW, its float operations at F32_PEAK, counted on the timed
call's inputs, and, for integer kernels, their instructions at the
card's pipe and issue rates (int_rates): Threefry's counted from the
function (threefry_work), K4 srt's from its SASS (sass_work); the Threefry and K3
entries also carry the profiler's device time and the host's enqueue time
per call. The last line is {"ok": true,
"device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import datetime
import functools
import gc
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from jet_pbrt_tpu_torch import cli
from jet_pbrt_tpu_torch.entry import dryrun_multichip
from jet_pbrt_tpu_torch.diff import params as dparams
from jet_pbrt_tpu_torch.diff.gradcheck import check_grads
from jet_pbrt_tpu_torch.models import camera as camera_mod
from jet_pbrt_tpu_torch.models import graph as graph_mod
from jet_pbrt_tpu_torch.models import integrators
from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves, render, \
    render_fn, setup, wave_fn
from jet_pbrt_tpu_torch.ops import brute as brute_ops
from jet_pbrt_tpu_torch.ops import bsdf as bsdf_ops
from jet_pbrt_tpu_torch.ops import intersect as isect_ops
from jet_pbrt_tpu_torch.ops import launches as launch_registry
from jet_pbrt_tpu_torch.ops import linalg, rng, sweep_bvh, wide_bvh
from jet_pbrt_tpu_torch.ops import rays as rays_ops
from jet_pbrt_tpu_torch.ops import shade as shade_ops
from jet_pbrt_tpu_torch.ops import wave as wave_ops
from jet_pbrt_tpu_torch.ops.linalg import frame_from_z, to_world
from jet_pbrt_tpu_torch.ops.sampling import sample_cosine_hemisphere
from jet_pbrt_tpu_torch.parallel import mesh as pmesh
from jet_pbrt_tpu_torch.parallel import multihost
from jet_pbrt_tpu_torch.parallel import render as prender
from jet_pbrt_tpu_torch.parallel import train as ptrain
from jet_pbrt_tpu_torch.scene import pack as scene_pack
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder
from jet_pbrt_tpu_torch.scene.scenes import bunny_obj, bunny_scene, cornell_box
from jet_pbrt_tpu_torch.scripts import prim_micro, sweep_prims, wave_nodes
from jet_pbrt_tpu_torch.utils import checkpoint, cuda_build
from jet_pbrt_tpu_torch.utils import image as image_io

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# kernel vs plain: t on agreeing lanes, and the forensic's f64 margins
T_RTOL = 1e-5
# floors of the forensic's margins; each candidate adds its own float32
# rounding bound (_mt64_all)
GRAZE = 1e-4        # |min(u, v, 1-u-v)| below this is an edge graze
TIE_RTOL = 1e-4     # f64 distances this close are a near-tie
U32 = float(np.finfo(np.float32).eps) / 2   # float32 unit roundoff
MAX_EXPLAINED = 1e-3
# the plain sweep is timed at 2^20 rays when its 2^18 call took less
PLAIN_2_18_LIMIT_S = 5.0
LIBRARIES = (("wide_bvh", ["wide_bvh.cu"]), ("sweep_bvh", ["sweep_bvh.cu"]),
             ("sweep_prims", ["sweep_prims.cu"]),
             ("prim_micro", ["prim_micro.cu"]),
             ("threefry", ["threefry.cu"]), ("shade", ["shade.cu"]),
             ("brute", ["brute.cu"]), ("rays", ["rays.cu"]),
             ("wave", ["wave.cu"]), ("shade_grad", ["shade_grad.cu"]))
# the fused vertex built to count its float operations per lane (the
# bound's operations on the timed call's own inputs; its flag is in
# cuda_build.FLAGS); built beside the rest
COUNT_LIBRARY = ("shade_count", ["shade.cu"])
# one H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores, and
# HBM3; every float operation below counts as one against F32_PEAK
F32_PEAK = 67e12     # FLOP/s
HBM_BW = 3.35e12     # bytes/s
# o, d, tmin, tmax in; t, index out
RAY_BYTES = 4 * (3 + 3 + 1 + 1) + 4 + 4
# a dead lane of the wide kernel: tmin, tmax in; t, index out
DEAD_RAY_BYTES = 4 + 4 + 4 + 4
# float operations per unit of work that the function needs: a node visit's
# 8 slab tests of 26 (wide_bvh.cu visit_node), the 19 comparators of an
# optimal 8-key sorting network where a node visit hits two or more
# children and so orders them, and one Moller-Trumbore test with its accept
# rule (tri_test)
WIDE_SLAB_OPS = 8 * 26
WIDE_RANK_OPS = 19
WIDE_TRI_OPS = 55
# the wide kernel's two passes, as the profiler names them; a timed cast
# also counts the memset that zeroes its counter
WIDE_KERNELS = ("wide_cull_kernel", "wide_walk_kernel")
WIDE_OPS = WIDE_KERNELS + ("Memset",)
# sweep_bvh.cu:133-145 and 259, one ray against one group sphere, and
# :343-356, one ray against one triangle (a fused multiply-add counts as
# its product and its sum)
SWEEP_CULL_OPS = 33
SWEEP_TRI_OPS = 51
# one Moller-Trumbore test of prim_micro.cu's mt: 44 products and sums,
# the division, |det| > eps, u + v, 4 comparisons and the running minimum
MT_TEST_OPS = 44 + 1 + 1 + 1 + 4 + 1
# Integer work is bounded by Hopper's issue rates, not by F32_PEAK (whose
# 67e12 is 128 float lanes per SM with each FMA counted twice). NVIDIA's
# Nsight Compute Kernel Profiling Guide ("Pipelines"): the ALU pipe runs
# the bit manipulation and logic instructions and every integer
# instruction except IMAD and IMUL; those run on the FMA-heavy pipe (with
# the integer dot products). Each pipe has 64 lanes per SM (16 per SM
# sub-partition), and an SM issues at most 4 warp instructions, 128 thread
# instructions, per clock. Each class goes at its rate over the card's SMs
# at its largest SM clock (nvidia-smi clocks.max.sm); the bound is the
# largest of the three and the bytes. Threefry's instructions are those
# the function needs (threefry_work), K4 srt's are counted from its SASS
# (`sass_work`).
INSTR_PER_SM_CLOCK = 128
ALU_PER_SM_CLOCK = 64
FMA_HEAVY_PER_SM_CLOCK = 64
ALU_PIPE_OPS = ("IADD3", "IADD", "VIADD", "IABS", "ISETP", "ISCADD", "LEA",
                "LOP", "LOP3", "PLOP3", "SHF", "SHL", "SHR", "IMNMX",
                "VIMNMX", "VIADDMNMX", "SEL", "PRMT", "SGXT", "BMSK")
FMA_HEAVY_OPS = ("IMAD", "IMUL", "IDP")
# Threefry-2x32-20 as jax.random computes it: per hash, 20 rotations (SHF)
# and 20 xors (LOP3), which only the ALU pipe runs, and 31 adds (20 rounds,
# 10 key injections, the counter word), which either pipe runs; per key,
# its schedule word k0 ^ k1 ^ parity (one LOP3); per uniform, ((x0 ^ x1) >>
# 9) | 0x3F800000 (3 ALU-pipe instructions) and the float subtract of 1.
THREEFRY_ALU_PER_HASH = 40
THREEFRY_ADDS_PER_HASH = 31
THREEFRY_ALU_PER_SLOT = 3
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-9T]\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
# the Cornell 16^2 exact-seed golden was rendered by the reference under
# jit, where XLA contracts a * b + c into fused multiply-adds; its own
# op-by-op render on the CPU misses the golden's tolerance on 24 of 256
# pixels (tests/test_torch_render.py), and the card's libm rounds
# differently again: the share of pixels outside that may pass
EXACT_SEED_MAX_OFF = 0.2
# the step of phase 11's fit of the bunny's albedos (the loss falls at it
# on the CPU at 32^2, 64^2 and 160^2)
FIT_LR = 1.0
# phase 11's fits: steps (more than graph.CAPTURE_AFTER, so that fit's
# default captures at its first), routes in turns (graph=False eager,
# None graphed) and the steps of the graphed and eager fits held bit for bit
# under deterministic algorithms
FIT_STEPS = graph_mod.CAPTURE_AFTER + 2
FIT_TURNS = (False, None, None, False)
DETERMINISTIC_FIT_STEPS = 3
# a prim_micro float probe's operations per iteration, counted on the
# values the function needs: the 8 blocks compute one acc, and r1's and
# mt's lanes are all equal, so each is one scalar chain; r2 reduces 8 tiles
# of distinct table values (rows 6k..6k+7 of 128 columns, 6 rows for k =
# 7). The update acc + s * 1e-9 is 2. srt is integer work (sass_work).
PROBE_OPS = dict(m1=1, m4=4, b1=4, r1=8 + 7 + 2, x8=7 + 2, x32=31 + 2,
                 r2=2 * (7 * 8 * 128 + 6 * 128) - 8 + 7 + 2, f1=1, f3=2 + 1,
                 mt=1 + 16 * MT_TEST_OPS + 2)


_START = time.perf_counter()


def phase(name):
    """A phase's header, with the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def bound(nbytes: int, flops: int, int_work=None):
    """The least time of the work on one H100, in ms, and what binds it:
    its bytes at HBM_BW, its float operations at F32_PEAK, or int_work =
    (ALU-pipe, FMA-heavy-pipe, all instructions) at their issue rates
    (int_rates)."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / F32_PEAK
    if int_work is not None:
        t_ops = max(t_ops, *(w / r for w, r in zip(int_work, int_rates())))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


@functools.lru_cache(maxsize=None)
def int_rates():
    """(ALU-pipe, FMA-heavy-pipe, issue) thread instructions per second of
    the card: 64, 64 and 128 per SM per clock at its largest SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    per_clock = torch.cuda.get_device_properties(0).multi_processor_count \
        * mhz * 1e6
    return (ALU_PER_SM_CLOCK * per_clock, FMA_HEAVY_PER_SM_CLOCK * per_clock,
            INSTR_PER_SM_CLOCK * per_clock)


@functools.lru_cache(maxsize=None)
def sass_functions(lib: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} of every kernel in the
    built library `lib` (a path, or the name under which cuda_build builds
    one of LIBRARIES), from cuobjdump -sass, each up to its final EXIT (the
    branch to itself and the NOPs after it are padding)."""
    if not os.path.isabs(lib):
        lib = cuda_build.library_path(lib, dict(LIBRARIES)[lib])
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        code = [(int(m[1], 16), m[3], m[4]) for m in SASS_LINE.finditer(part)]
        last = max(i for i, (_, op, _) in enumerate(code) if op == "EXIT")
        out[part.split(None, 1)[0]] = code[:last + 1]
    return out


def sass_function(lib: str, name: str):
    """The SASS (sass_functions) of the one kernel of `lib` whose mangled
    name contains `name`."""
    found = [c for nm, c in sass_functions(lib).items() if name in nm]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} kernels named {name} in {lib}")
    return found[0]


def pipe_counts(code):
    """(ALU-pipe, FMA-heavy-pipe, all) instructions of `code`, by opcode
    (ALU_PIPE_OPS, FMA_HEAVY_OPS; uniform-datapath U* opcodes are on
    neither)."""
    base = [op.split(".")[0] for _, op, _ in code]
    return (sum(op in ALU_PIPE_OPS for op in base),
            sum(op in FMA_HEAVY_OPS for op in base), len(code))


def sass_work(code, slots: int = 0):
    """(ALU-pipe, FMA-heavy-pipe, all) instructions one thread executes in
    `code` (sass_function). Straight-line code counts once. Given a loop
    (the longest backward branch): where its body stores k of the thread's
    output slots (k STG), the body runs slots // k times, and the code
    after it runs for the slots % k left (in proportion to its stores) or
    else its first instruction, the exit guard; where the body stores
    nothing, the body alone is returned, once (the caller scales it)."""
    index = {addr: i for i, (addr, _, _) in enumerate(code)}
    loops = [(index[int(arg, 16)], i) for i, (addr, op, arg) in enumerate(code)
             if op == "BRA" and int(arg, 16) < addr]
    stores = lambda part: sum(op.startswith("STG") for _, op, _ in part)
    if not loops:
        return tuple(float(c) for c in pipe_counts(code))
    first, last = max(loops, key=lambda lp: lp[1] - lp[0])
    pre, body, post = code[:first], code[first:last + 1], code[last + 1:]
    if not stores(body):
        return tuple(float(c) for c in pipe_counts(body))
    trips, rest = divmod(slots, stores(body))
    if rest:
        tail, share = post, rest / max(stores(post), 1)
    else:   # the exit guard alone
        tail, share = post[:1], 1.0
    pre, body, tail = (pipe_counts(x) for x in (pre, body, tail))
    return tuple(a + trips * b + share * c for a, b, c in zip(pre, body, tail))


class Route(NamedTuple):
    """One traversal kernel on one mesh, with what the comparison needs."""
    name: str
    kernel: Callable     # (o, d, tmin, tmax, any_hit) -> KindHit
    plain: Callable
    rows: np.ndarray     # [T, 9] triangle rows the hit indices select
    inst: np.ndarray     # [I+1, 4] instance rows, row 0 the identity
    n_tris: int
    work: Callable | None  # (o, d, tmin, tmax) -> (bytes, flops, counts)
                           # of a closest-hit call; None for the wide
                           # kernel, whose timed walk counts its own work
    exact: bool          # kernel and plain must agree bit for bit


def wide_work(tables, o, d, tmin, tmax, st):
    """(bytes, float operations) of one wide cast of these rays whose walk
    made st's node visits, ranked node visits and triangle tests
    (intersect_wide_plain(with_stats=True)): a live lane moves RAY_BYTES, a
    dead one DEAD_RAY_BYTES, and the tables are read once."""
    live = int(wide_bvh.live_lanes(o, d, tmin, tmax).sum())
    nbytes = live * RAY_BYTES + (o.shape[0] - live) * DEAD_RAY_BYTES + sum(
        x.nbytes for x in (tables.planar, tables.child, tables.tris,
                           tables.inst))
    return nbytes, (st["node_visits"] * WIDE_SLAB_OPS
                    + st["ranked_visits"] * WIDE_RANK_OPS
                    + st["tri_tests"] * WIDE_TRI_OPS)


def wide_route(scene) -> Route:
    """The wide kernel on the scene's first instanced family."""
    tables = scene.pack.inst_wide[0]
    kw = dict(has_inst=True, leaf_size=scene.meta.blas_leaf_size[0],
              n_tris=scene.meta.n_blas_tris[0])
    return Route("wide_bvh",
                 lambda *r, any_hit: wide_bvh.intersect_wide(
                     tables, *r, any_hit=any_hit, **kw),
                 lambda *r, any_hit: wide_bvh.intersect_wide_plain(
                     tables, *r, any_hit=any_hit, **kw),
                 tables.tris.cpu().numpy(), tables.inst.cpu().numpy(),
                 kw["n_tris"], None, True)


def sweep_route(scene) -> Route:
    """The sweep kernel on the scene's sweep-routed mesh (the first family,
    else the soup)."""
    meta, pack = scene.meta, scene.pack
    if any(meta.pallas_blas):
        mi = meta.pallas_blas.index(True)
        tables, rows = pack.inst_sweep[mi], pack.blas_tris[mi]
        n_tris = meta.n_blas_tris[mi]
        inst = tables.inst.view(-1, 4).cpu().numpy()
    elif meta.pallas_bvh:
        tables, rows, n_tris = pack.bvh_sweep, pack.bvh_tris, meta.n_bvh_tris
        inst = np.array([[0, 0, 0, 1], [0, 0, 0, 1]], np.float32)
    else:
        raise AssertionError(f"{meta.name}: no mesh is routed to the sweep")

    def work(o, d, tmin, tmax):
        """From the inputs (`sweep_work_plain` on the plain version's
        closest hits): the rays past each root test x the mesh's groups
        (sphere tests), and the needed (ray, group) pairs x 128 triangles.
        Prints the kernel's own counters beside them, and how its cycles
        split between cull and scan."""
        t_final = sweep_bvh.intersect_sweep_plain(
            tables, o, d, tmin, tmax, any_hit=False, n_tris=n_tris).t
        n_root, n_pairs = sweep_bvh.sweep_work_plain(tables, o, d, tmin, tmax,
                                                     t_final)
        st = [int(x) for x in sweep_bvh.intersect_sweep(
            tables, o, d, tmin, tmax, any_hit=False, n_tris=n_tris,
            with_stats=True)[1].sum(0)]
        cyc = st[4] + st[5]
        print(f"sweep_bvh counts at {o.shape[0]} rays, inputs / kernel: "
              f"rays past a root test {n_root} / {st[2]}; ray-group tests "
              f"{n_pairs} (needed) / {st[3]} ({st[3] / max(n_pairs, 1):.3f}x)"
              f"; groups tested by the kernel {st[1]}; kernel cycles (thread "
              f"0 of each block) cull {st[4]} ({100 * st[4] / max(cyc, 1):.1f}"
              f"%), scan {st[5]} ({100 * st[5] / max(cyc, 1):.1f}%)",
              flush=True)
        culls = n_root * tables.n_groups
        tests = n_pairs * sweep_bvh.GROUP
        nbytes = o.shape[0] * RAY_BYTES + sum(
            x.nbytes for x in (tables.sph, tables.bw, tables.inst,
                               tables.root))
        return (nbytes, culls * SWEEP_CULL_OPS + tests * SWEEP_TRI_OPS,
                {"ray_group_culls": culls, "ray_tri_tests": tests,
                 "kernel_ray_group_tests": st[3],
                 "kernel_cull_cycles": st[4], "kernel_scan_cycles": st[5]})

    return Route("sweep_bvh",
                 lambda *r, any_hit: sweep_bvh.intersect_sweep(
                     tables, *r, any_hit=any_hit, n_tris=n_tris),
                 lambda *r, any_hit: sweep_bvh.intersect_sweep_plain(
                     tables, *r, any_hit=any_hit, n_tris=n_tris),
                 rows.cpu().numpy(), inst, n_tris, work, False)


# --------------------------------------------------------------------------
# 2b. the random streams' kernel
# --------------------------------------------------------------------------

# ops/rays.py's wrappers, each counting its csrc/rays.cu kernel's launches
RAYS = ("shadow_key", "shadow_segments", "occlusion_merge", "hit_reconstruct")
# ops/wave.py's wrappers, each counting its csrc/wave.cu kernel's launches
WAVE = ("camera_rays", "permute_state", "unsort_guard")


def rng_launches() -> int:
    return rng.lane_keys.launches + rng.uniforms.launches


def reset_rng_launches():
    rng.lane_keys.launches = 0
    rng.uniforms.launches = 0


def launch_counts() -> dict:
    return {"wide_bvh": wide_bvh.intersect_wide.launches,
            "sweep_bvh": sweep_bvh.intersect_sweep.launches,
            "threefry": rng_launches(),
            "shade_vertex": shade_ops.shade_vertex.launches,
            "nee_accumulate": shade_ops.nee_accumulate.launches,
            "brute_hits": brute_ops.brute_hits.launches,
            **{name: getattr(rays_ops, name).launches for name in RAYS},
            **{name: getattr(wave_ops, name).launches for name in WAVE},
            **{name: getattr(shade_ops, name).launches
               for name in GRAD_SHADE},
            **{name: getattr(wave_ops, name).launches for name in GRAD_WAVE}}


def reset_launches():
    brute_ops.brute_hits.launches = 0
    for name in RAYS:
        getattr(rays_ops, name).launches = 0
    for name in WAVE + GRAD_WAVE:
        getattr(wave_ops, name).launches = 0
    for name in GRAD_SHADE:
        getattr(shade_ops, name).launches = 0
    wide_bvh.intersect_wide.launches = 0
    sweep_bvh.intersect_sweep.launches = 0
    shade_ops.shade_vertex.launches = 0
    shade_ops.nee_accumulate.launches = 0
    reset_rng_launches()


def rng_bits(label, k, p):
    """Number of entries whose bits differ; raises if any does."""
    bad = int((k.view(torch.int32) != p.view(torch.int32)).sum()) \
        if k.dtype == torch.float32 else int((k != p).sum())
    if bad:
        raise AssertionError(f"threefry {label}: {bad} entries differ from "
                             "the plain version")
    return bad


def rng_inputs(dev, n: int):
    """(seed, sample, pixel, perm) of rng_phase: pixels 0..n-1, samples
    0-3 per lane and a permutation of the lanes, from a seeded generator."""
    gen = torch.Generator().manual_seed(0)
    sample = torch.randint(0, 4, (n,), generator=gen).to(dev)
    perm = torch.randperm(n, generator=gen).to(dev)
    return 2 ** 31 - 1, sample, torch.arange(n, device=dev), perm


# chip_smoke's inputs of K3 (sweep_prims.inputs): (seed, keys tied)
PRIMS_INPUTS = ((0, False), (1, False), (2, False), (3, False), (0, True),
                (1, True))


def rng_phase(dev, n_lights: int, n: int = 1 << 20):
    """The Threefry kernel against its plain version at 2^20 lanes (pixels
    0..2^20-1, samples 0-3 per lane): lane key words, the uniforms of every
    vertex purpose and the camera's, in pixel order and permuted as the ray
    sort permutes lanes (and equal to the permuted unsorted draw); times of
    both versions (kernel_times: events, host enqueue and the profiler's
    device time), and the bounds of one vertex_uniforms and one lane_keys
    call from the function's integer work (threefry_bounds; the kernel's
    SASS is printed beside them as a diagnostic). Returns vertex_uniforms' kernel_times
    with its plain ms, bound and the largest |kernel - plain| of the
    uniforms compared (`err`), and the camera's and lane_keys' times under
    "camera" and "lane_keys"."""
    s = 4 + 2 * n_lights
    seed, sample, pixel, perm = rng_inputs(dev, n)
    keys = rng.lane_keys(seed, sample, pixel)
    plain = rng.lane_keys_plain(seed, sample, pixel)
    rng_bits("lane_keys k0", keys.k0, plain.k0)
    rng_bits("lane_keys k1", keys.k1, plain.k1)
    moved = integrators._permute(keys, perm)
    err = 0.0
    for label, purpose, width in (
            [("camera", rng.PURPOSE_CAMERA, 2)]
            + [(f"vertex {b}", rng.PURPOSE_PATH_BASE + b, s)
               for b in range(5)]):
        k = rng.uniforms(keys, purpose, width)
        p = rng.uniforms_plain(keys, purpose, width)
        rng_bits(label, k, p)
        err = max(err, float((k - p).abs().max()))
        ks = rng.uniforms(moved, purpose, width)
        rng_bits(label + " sorted", ks, rng.uniforms_plain(moved, purpose,
                                                           width))
        rng_bits(label + " sorted vs unsorted", ks, k[perm])
    for sampler in ("random", "stratified"):
        rng_bits(f"camera_jitter {sampler}",
                 rng.camera_jitter(moved, sampler, spp=4),
                 rng.camera_jitter(keys, sampler, spp=4)[perm])
    purpose = rng.PURPOSE_PATH_BASE + 2
    uni = kernel_times(lambda: rng.vertex_uniforms(keys, 2, n_lights),
                       ("uniforms_kernel",))
    cam = kernel_times(lambda: rng.uniforms(keys, rng.PURPOSE_CAMERA, 2),
                       ("uniforms_kernel",))
    key = kernel_times(lambda: rng.lane_keys(seed, sample, pixel),
                       ("lane_keys_kernel",))
    uni["plain_ms"] = time_ms(lambda: rng.uniforms_plain(keys, purpose, s),
                              2)[0]
    key["plain_ms"] = time_ms(
        lambda: rng.lane_keys_plain(seed, sample, pixel), 2)[0]
    uni["bound"], key["bound"] = threefry_bounds(n, s)
    work = threefry_work(s)
    print(f"threefry per lane (ALU-pipe / FMA-heavy-pipe / all "
          f"instructions), the function's: uniforms at S = {s} "
          + " / ".join(f"{x:.0f}" for x in work["uniforms"]) + ", lane_keys "
          + " / ".join(f"{x:.0f}" for x in work["lane_keys"])
          + "; the kernel's SASS (a diagnostic): "
          + sass_line(threefry_sass("threefry", s))
          + "; rates " + " / ".join(f"{r:.4g}" for r in int_rates())
          + " thread instructions/s", flush=True)
    print(f"threefry at {n} lanes, S = {s}: lane key words and the uniforms "
          "of the camera and 5 vertices equal the plain version bit for bit, "
          "sorted and unsorted", flush=True)
    for label, t in (("vertex_uniforms", uni), ("camera uniforms", cam),
                     ("lane_keys", key)):
        print(f"threefry {label}: " + times_line(t), flush=True)
    uni.update(err=err, lane_keys=key, camera=cam)
    return uni


def kernel_times(fn, names, reps: int = 20) -> dict:
    """Times of one kernel wrapper's call, in ms: `ms` by CUDA events over
    reps back-to-back calls (the wrapper's host work included where it
    outlasts the kernel), `enqueue_ms` the host's mean time per call to
    enqueue them, `device_ms` the profiler's device time per call of the
    kernels named `names`."""
    ms, host_ms = time_enqueue_ms(fn, reps)[:2]
    return {"ms": ms, "enqueue_ms": host_ms,
            "device_ms": sum(profiled_ms(fn, reps, names).values())}


def times_line(t: dict) -> str:
    line = (f"kernel {t['ms']:.4f} ms by events, {t['device_ms']:.4f} ms of "
            f"device time by the profiler, host enqueue {t['enqueue_ms']:.4f} "
            "ms per call")
    if "plain_ms" in t:
        line += f"; plain {t['plain_ms']:.3f} ms"
    if "bound" in t:
        ms, by = t["bound"]
        line += (f"; bound {ms:.6f} ms ({by}), device time "
                 f"{t['device_ms'] / ms:.2f}x the bound")
    return line


def threefry_work(s: int) -> dict:
    """Per lane, the integer instructions (ALU-pipe, FMA-heavy-pipe, all)
    that the function needs (THREEFRY_*): a uniforms call at width s is
    1 + s hashes under 2 keys (the lane's fold_in, then s slots), and s
    conversions; a lane_keys call is 2 hashes, one key per lane (the
    first, (0, seed), is the launch's). The adds go to the FMA-heavy pipe
    up to the ALU pipe's load, the rest split evenly."""
    def work(hashes, keys, slots):
        alu = (THREEFRY_ALU_PER_HASH * hashes + keys
               + THREEFRY_ALU_PER_SLOT * slots)
        adds = THREEFRY_ADDS_PER_HASH * hashes
        on_alu = max(0.0, (adds - alu) / 2)
        return (alu + on_alu, adds - on_alu, alu + adds + slots)
    return {"uniforms": work(1 + s, 2, s), "lane_keys": work(2, 1, 0)}


def threefry_sass(lib: str, s: int) -> dict:
    """Per lane, the SASS instructions (ALU-pipe, FMA-heavy-pipe, all) of
    the built Threefry library `lib` (sass_function), a diagnostic beside
    threefry_work: a uniforms call at width s (its instantiation for s,
    else the generic one; a kernel with no template, an older source's,
    counted by its slot loop) and a lane_keys call, each beside its opcode
    mix."""
    names = list(sass_functions(lib))
    out = {}
    for entry, wanted in (
            ("uniforms", (f"uniforms_kernelILi{s}E", "uniforms_kernelILi0E",
                          "uniforms_kernel")),
            ("lane_keys", ("lane_keys_kernel",))):
        frag = next(w for w in wanted if sum(w in nm for nm in names) == 1)
        code = sass_function(lib, frag)
        mix = collections.Counter(op.split(".")[0] for _, op, _ in code)
        out[entry] = (sass_work(code, s), ", ".join(
            f"{op} {c}" for op, c in mix.most_common(8)))
    return out


def sass_line(sass: dict) -> str:
    """threefry_sass's counts and the uniforms' opcode mix, one line."""
    return ("uniforms " + " / ".join(f"{x:.0f}" for x in sass["uniforms"][0])
            + ", lane_keys " + " / ".join(
                f"{x:.0f}" for x in sass["lane_keys"][0])
            + "; opcodes of uniforms " + sass["uniforms"][1])


def threefry_bounds(n: int, s: int):
    """Bounds (ms, binds) of a uniforms call at width s and of a lane_keys
    call on n lanes, from threefry_work: the uniforms read two key words
    and write s floats per lane, lane_keys reads two int64 and writes two
    int32 per lane."""
    work = threefry_work(s)
    return (bound(n * 8 + n * s * 4, 0,
                  tuple(n * x for x in work["uniforms"])),
            bound(n * 16 + n * 8, 0,
                  tuple(n * x for x in work["lane_keys"])))


@contextlib.contextmanager
def plain_streams():
    """While open, the streams are drawn by the plain version on the card
    (the wave as it was before the Threefry kernel): a measurement of this
    script only; the port never takes it."""
    keys, uni = rng.lane_keys, rng.uniforms

    def plain_keys(seed, sample, pixel_ids):
        pixel = pixel_ids.to(torch.int64)
        sample = torch.as_tensor(sample, dtype=torch.int64,
                                 device=pixel.device).expand(pixel.shape)
        return rng.lane_keys_plain(seed, sample, pixel)

    rng.lane_keys, rng.uniforms = plain_keys, rng.uniforms_plain
    try:
        yield
    finally:
        rng.lane_keys, rng.uniforms = keys, uni


# --------------------------------------------------------------------------
# 2c. the fused path vertex (ops/shade.py)
# --------------------------------------------------------------------------

VERTEX_DEPTH = 5
# written between timed calls to evict their inputs from the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
# the state, then per non-black light j: its output, and the dimension of
# the lane in it
VERTEX_OUTPUTS = (tuple((f, 0) for f in shade_ops.VertexState._fields)
                  + (("useful", 1), ("contrib", 1), ("shadow_to", 1)))


def every_kind_scene(sweep: bool = False, builder=SceneBuilder):
    """A scene of every kind the fused vertex tells apart: every material
    (matte, mirror, glass, plastic, metal, rough glass, phong) under GGX
    and Beckmann, the solid, checker, nearest and bilinear image textures,
    every light (point, directional, env, and area lights on a rect, a
    triangle, a disk, a sphere and an emissive instance) and every shape
    kind (rect, sphere, disk, triangle soup, instanced mesh); the
    instanced mesh on the wide route, or on the sweep with the wide budget
    set low while it is built. `builder` is a SceneBuilder class (the
    reference package's makes the same scene)."""
    budget = wide_bvh._VMEM_BUDGET
    if sweep:
        wide_bvh._VMEM_BUDGET = 1024
    try:
        g = np.random.default_rng(5)
        b = builder("every-kind")
        b.set_camera(lookfrom=(0, 1.5, 9), lookat=(0, 0, 0), vfov=55)
        image = g.uniform(0, 1, (6, 8, 3)).astype(np.float32)
        checker = b.add_checker_texture((0.8, 0.2, 0.2), (0.2, 0.2, 0.8), 3.0)
        b.add_rect_xz(-6, 6, -6, 6, -2, b.add_matte((0.7, 0.7, 0.7),
                                                   tex=checker))
        b.add_sphere((2.5, -0.8, 0.5), 1.0, b.add_glass(1.5))
        b.add_sphere((-2.5, -0.8, 0.5), 0.8, b.add_roughglass(1.4, 0.3))
        b.add_sphere((-1.2, -1.4, 2.6), 0.5, b.add_roughglass(
            1.3, 0.2, distribution="beckmann"))
        b.add_sphere((1.2, -1.4, 2.6), 0.5, b.add_metal(
            (0.2, 0.9, 1.1), (3.9, 2.4, 2.1), 0.3, 0.1,
            distribution="beckmann"))
        b.add_disk((0, -1.9, 2.5), (0, 1, 0), 0.8,
                   b.add_mirror((0.9, 0.9, 0.9)))
        b.add_mesh(g.uniform(-0.4, 0.4, (6, 3, 3)) + (0.0, 2.0, -1.0),
                   b.add_phong((0.6, 0.6, 0.6), 20.0))
        uvs = g.uniform(0, 1, (4, 3, 2)).astype(np.float32)
        for k, bilinear in enumerate((False, True)):
            b.add_mesh(g.uniform(-0.5, 0.5, (4, 3, 3))
                       + (-3.0 + 6.0 * k, 1.0, -1.5),
                       b.add_matte((1, 1, 1), tex=b.add_image_texture(
                           image, bilinear=bilinear)), uvs=uvs)
        metal = b.add_metal((0.2, 0.9, 1.1), (3.9, 2.4, 2.1), 0.25, 0.25)
        plastic = b.add_plastic((0.5, 0.3, 0.2), (0.4, 0.4, 0.4), 0.3,
                                tex=b.add_solid_texture((0.3, 0.6, 0.2)))
        rough = b.add_plastic((0.2, 0.3, 0.5), (0.5, 0.5, 0.5), 0.4,
                              remap=True, distribution="beckmann")
        base = g.uniform(-1, 1, (200, 1, 3))
        b.add_instanced_mesh(base + g.uniform(-0.3, 0.3, (200, 3, 3)),
                             [((0, 0, 0), 1.0, plastic),
                              ((0, 0, -2.5), 0.8, metal),
                              ((3.5, 2.5, -3.0), 0.3, rough, (2, 2, 1.5))])
        b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, 4, b.add_matte(
            (0.6, 0.6, 0.6)), flip_normal=True), (8.0, 8.0, 8.0))
        b.add_area_light(b.add_triangle((-4, 3, -2), (-2, 3, -2), (-3, 4, -2),
                                        b.add_matte((0.5, 0.5, 0.5))),
                         (3.0, 2.0, 2.0))
        b.add_area_light(b.add_disk((3, 3, 0), (-1, -0.5, 0), 0.6,
                                    b.add_matte((0.5, 0.5, 0.5))),
                         (1.0, 2.0, 3.0))
        b.add_area_light(b.add_sphere((0, 3.2, 1.5), 0.3, b.add_matte(
            (0.5, 0.5, 0.5))), (4.0, 4.0, 3.0))
        b.add_point_light((1, 3, 2), (5.0, 5.0, 5.0))
        b.add_directional_light((0.3, -1, 0.2), (0.5, 0.5, 0.5))
        b.add_env_light((0.1, 0.15, 0.2))
        scene = b.build()
    finally:
        wide_bvh._VMEM_BUDGET = budget
    if builder is SceneBuilder and scene.meta.pallas_blas != (sweep,):
        raise AssertionError("the every-kind scene is not on the route asked")
    return scene


def many_families_scene(n_families: int = 16, builder=SceneBuilder):
    """More instanced mesh families than a cast has kinds in most scenes:
    n_families meshes of 24 triangles with uvs in a 4-wide grid, two
    instances each (scales 1 and 0.5), over a checker-textured floor rect
    beside a sphere and a disk, lit by an area rect and a point light. A
    closest cast has n_families + 3 kinds and a shadow cast n_families +
    1 flags, each cast's merge one launch. `builder` is a SceneBuilder
    class."""
    g = np.random.default_rng(11)
    b = builder("many-families")
    b.set_camera(lookfrom=(0, 4, 11), lookat=(0, 0, 0), vfov=55)
    checker = b.add_checker_texture((0.8, 0.8, 0.8), (0.3, 0.3, 0.3), 4.0)
    b.add_rect_xz(-9, 9, -9, 9, -1, b.add_matte((0.7, 0.7, 0.7),
                                                tex=checker))
    b.add_sphere((0.0, -0.3, 4.0), 0.7, b.add_plastic(
        (0.5, 0.3, 0.2), (0.4, 0.4, 0.4), 0.3))
    b.add_disk((2.0, -0.95, 4.0), (0, 1, 0), 0.6,
               b.add_mirror((0.9, 0.9, 0.9)))
    for f in range(n_families):
        x, z = -4.5 + 3.0 * (f % 4), -4.5 + 3.0 * (f // 4)
        tris = (g.uniform(-0.6, 0.6, (24, 1, 3))
                + g.uniform(-0.25, 0.25, (24, 3, 3)))
        mat = b.add_matte(tuple(g.uniform(0.2, 0.9, 3)), tex=checker)
        b.add_instanced_mesh(tris, [((x, 0.0, z), 1.0, mat),
                                    ((x, 1.3, z), 0.5, mat)],
                             uvs=g.uniform(0, 1, (24, 3, 2)))
    b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, 5, b.add_matte(
        (0.6, 0.6, 0.6)), flip_normal=True), (10.0, 10.0, 10.0))
    b.add_point_light((3, 4, 3), (6.0, 6.0, 6.0))
    return b.build()


def many_lights_scene(builder=SceneBuilder):
    """A scene of 46 lights, more than one of each kind, one of them
    black: 24 point lights on a ring, a directional and an env light,
    area lights on 8 rects, 4 spheres, 2 disks and 2 triangles, and 4
    emissive instances of two instanced mesh families (their triangles
    at two offsets of the light table's emissive buffer), over a floor,
    spheres of plastic, metal and glass and those families' other
    instances. `builder` is a SceneBuilder class."""
    g = np.random.default_rng(7)
    b = builder("many-lights")
    b.set_camera(lookfrom=(0, 4, 10), lookat=(0, 0, 0), vfov=60)
    white = b.add_matte((0.7, 0.7, 0.7))
    b.add_rect_xz(-8, 8, -8, 8, -1, white)
    b.add_sphere((-2, 0, 0), 1.0, b.add_plastic((0.5, 0.3, 0.2),
                                               (0.4, 0.4, 0.4), 0.3))
    b.add_sphere((2, 0, 0), 1.0, b.add_metal(
        (0.2, 0.9, 1.1), (3.9, 2.4, 2.1), 0.2, 0.2))
    b.add_sphere((0, 0, 2), 0.7, b.add_glass(1.5))
    for k in range(24):
        a = 2 * np.pi * k / 24
        b.add_point_light((5 * np.cos(a), 3 + (k % 3), 5 * np.sin(a)),
                          (0.0, 0.0, 0.0) if k == 5 else
                          tuple(g.uniform(0.5, 3.0, 3)))
    b.add_directional_light((0.2, -1, -0.3), (0.3, 0.3, 0.3))
    b.add_env_light((0.05, 0.06, 0.08))
    for k in range(8):
        x = -7 + 2 * k
        b.add_area_light(b.add_rect_xz(x, x + 0.8, -6, -5, 5, white,
                                       flip_normal=True),
                         tuple(g.uniform(1.0, 4.0, 3)))
    for k in range(4):
        b.add_area_light(b.add_sphere((-3 + 2 * k, 4, 3), 0.2, white),
                         tuple(g.uniform(2.0, 6.0, 3)))
    for k in range(2):
        b.add_area_light(b.add_disk((-4 + 8 * k, 2, -2), (1 - 2 * k, -1, 0),
                                    0.5, white), (2.0, 1.5, 1.0))
        b.add_area_light(b.add_triangle((-1 + k, 4, -3), (1 + k, 4, -3),
                                        (k, 5, -3), white), (1.0, 2.0, 2.5))
    for fam in range(2):
        base = g.uniform(-1, 1, (60 + 40 * fam, 1, 3))
        b.add_instanced_mesh(
            base + g.uniform(-0.3, 0.3, (60 + 40 * fam, 3, 3)),
            [((-4 + 8 * fam, 0.5, -4), 0.5, white),
             ((-4 + 8 * fam, 3.5, -4), 0.3, white, (1.5, 1.0, 0.5)),
             ((-2 + 4 * fam, 3.0, 4), 0.2, white, (0.5, 1.0, 1.5))])
    return b.build()


# the many-slots scene's materials: more parameter slots (8 a material)
# than the kernel of commit feed372 held in a block's shared memory
# (14,528)
MANY_SLOTS_MATERIALS = 2000


def many_slots_scene(grid: int = 16, builder=SceneBuilder):
    """MANY_SLOTS_MATERIALS matte materials of seeded colours, the floor a
    grid x grid of rects with one of them each (spread over the table),
    under an area light, beside a metal sphere (the second tangent set):
    more parameter slots than a block's accumulators hold in shared
    memory, so the backward accumulates in device memory, and many rows
    in a warp. `builder` is a SceneBuilder class."""
    g = np.random.default_rng(11)
    b = builder("many-slots")
    b.set_camera(lookfrom=(0, 4, 8), lookat=(0, 0, 0), vfov=50)
    mats = [b.add_matte(tuple(g.uniform(0.2, 0.9, 3)))
            for _ in range(MANY_SLOTS_MATERIALS)]
    step = 12.0 / grid
    for k in range(grid * grid):
        x, z = -6 + step * (k % grid), -6 + step * (k // grid)
        b.add_rect_xz(x, x + step, z, z + step, 0,
                      mats[k * (MANY_SLOTS_MATERIALS // (grid * grid))])
    b.add_sphere((0, 1, 0), 1.0, b.add_metal((0.2, 0.9, 1.1),
                                            (3.9, 2.4, 2.1), 0.3, 0.3))
    b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, 5, b.add_matte(
        (0.6, 0.6, 0.6)), flip_normal=True), (6.0, 6.0, 6.0))
    b.add_env_light((0.1, 0.1, 0.15))
    return b.build(use_bvh=False)


@contextlib.contextmanager
def vertex_calls(out: list):
    """While open, each call of shade_ops.shade_vertex and
    shade_ops.nee_accumulate appends (name, args, keywords, output) to
    `out` (the wave changes no input in place but the ray counters
    shade_vertex adds to, which are recorded as copies made before and
    after the call). The wrapped function counts on the name in the module
    (functools.wraps copies the count), as recorded_calls does."""
    saved = []
    for name in ("shade_vertex", "nee_accumulate"):
        inner = getattr(shade_ops, name)

        @functools.wraps(inner)
        def call(*a, _inner=inner, _name=name, **kw):
            rec = dict(kw)
            if rec.get("counts") is not None:
                rec["counts"] = rec["counts"].clone()
            got = _inner(*a, **kw)
            out.append((_name, a, rec, got if getattr(got, "counts", None)
                        is None else got._replace(counts=got.counts.clone())))
            return got

        setattr(shade_ops, name, call)
        saved.append((name, inner))
    try:
        yield out
    finally:
        for name, inner in saved:
            setattr(shade_ops, name, inner)


@contextlib.contextmanager
def plain_vertex():
    """While open, the plain versions stand in the wrappers' places, so
    li_path's kernel route runs the plain vertex (a measurement only)."""
    sv, na = shade_ops.shade_vertex, shade_ops.nee_accumulate
    shade_ops.shade_vertex = (
        lambda *a, lights=None, counts=None: shade_ops.shade_vertex_plain(
            *a, counts=counts))
    shade_ops.nee_accumulate = shade_ops.nee_accumulate_plain
    try:
        yield
    finally:
        shade_ops.shade_vertex, shade_ops.nee_accumulate = sv, na


def differing_lanes(got, want, lane_dim: int):
    """[N] bool: lanes where got and want differ in any bit (NaN equal to
    NaN) anywhere in the lane's entries."""
    if got.dtype == torch.bool:
        diff = got != want
    else:
        diff = (got.view(torch.int32) != want.view(torch.int32)) \
            & ~(torch.isnan(got) & torch.isnan(want))
    diff = diff.movedim(lane_dim, 0)
    return diff.reshape(diff.shape[0], -1).any(dim=1)


def check_vertex_calls(label: str, calls: list) -> dict:
    """Each recorded shade_vertex call held against shade_vertex_plain on
    the same inputs, every output, and each nee_accumulate call against
    nee_accumulate_plain, bit for bit (NaN equal to NaN); a differing lane
    is printed with its inputs and both values before the run fails.
    Returns {"vertices", "accumulates", "lanes", "max_abs_err"}."""
    out = {"vertices": 0, "accumulates": 0, "lanes": 0, "max_abs_err": 0.0}
    bad = []
    for name, a, kw, got in calls:
        if name == "shade_vertex":
            meta, pack, hit, state, u, bounce, depth = a
            want = shade_ops.shade_vertex_plain(meta, pack, hit, state, u,
                                                bounce, depth,
                                                counts=kw.get("counts"))
            if (got.counts is None) != (want.counts is None) or (
                    got.counts is not None
                    and not torch.equal(got.counts, want.counts)):
                raise AssertionError(
                    f"{label} bounce {bounce}: ray counters {got.counts}, "
                    f"plain {want.counts}")
            pairs = [(f, getattr(got.state, f), getattr(want.state, f), 0)
                     for f in shade_ops.VertexState._fields] + [
                (f, getattr(got, f), getattr(want, f), 1)
                for f in ("useful", "contrib", "shadow_to")] + [
                (f, getattr(got, f), getattr(want, f), 0)
                for f in ("tmin", "tmax") if getattr(want, f) is not None]
            out["vertices"] += 1
            live = int(state.active.sum())
            per = {}
            for f, g, w, dim in pairs:
                if g.shape != w.shape:
                    raise AssertionError(
                        f"{label} bounce {bounce} {f}: shape "
                        f"{tuple(g.shape)} vs {tuple(w.shape)}")
                lanes = differing_lanes(g, w, dim)
                per[f] = int(lanes.sum())
                if per[f]:
                    bad.append((f, bounce, g, w, dim, lanes, hit, state, u))
                if g.dtype != torch.bool:
                    fin = torch.isfinite(g) & torch.isfinite(w)
                    if fin.any():
                        out["max_abs_err"] = max(
                            out["max_abs_err"],
                            float((g[fin] - w[fin]).abs().max()))
            out["lanes"] += state.L.shape[0]
            print(f"{label} vertex at bounce {bounce}: {state.L.shape[0]} "
                  f"lanes, {live} live, {got.useful.shape[0]} NEE lights; "
                  "lanes differing from the plain version by output "
                  + ", ".join(f"{k} {v}" for k, v in per.items()),
                  flush=True)
        else:
            want = shade_ops.nee_accumulate_plain(*a)
            lanes = differing_lanes(got, want, 0)
            out["accumulates"] += 1
            if int(lanes.sum()):
                bad.append(("nee_accumulate", None, got, want, 0, lanes,
                            None, None, None))
            print(f"{label} nee_accumulate of {a[1].shape[0]} lights: "
                  f"{int(lanes.sum())} lanes differ", flush=True)
    for f, bounce, g, w, dim, lanes, hit, state, u in bad[:6]:
        for i in lanes.nonzero().flatten()[:3].tolist():
            pick = lambda x: x.select(dim, i) if dim == 0 else x[:, i]
            print(f"{label} {f} at bounce {bounce} lane {i}: kernel "
                  f"{pick(g).tolist()}, plain {pick(w).tolist()}", flush=True)
            if hit is not None:
                print(f"  hit: valid {bool(hit.valid[i])} mat "
                      f"{int(hit.mat_id[i])} light {int(hit.light_id[i])} "
                      f"position {hit.position[i].tolist()} normal "
                      f"{hit.normal[i].tolist()} wo {hit.wo[i].tolist()}; "
                      f"active {bool(state.active[i])} beta "
                      f"{state.beta[i].tolist()}; u {u[i].tolist()}",
                      flush=True)
    if bad:
        raise AssertionError(f"{label}: the fused vertex differs from its "
                             f"plain version in {len(bad)} outputs")
    return out


def vertex_bytes(meta, pack, n: int, lights: int, last: bool) -> int:
    """Bytes one shade_vertex call must move: each input read once (the
    hit, the lane state, the vertex's uniforms, the material, texture and
    light tables, the light table's static part and emissive triangles)
    and each output written once (the state, and per NEE
    light its mask, contribution and shadow endpoint)."""
    hit = 1 + 12 + 12 + 12 + 4 + 4 + (8 if meta.n_tex else 0)
    state = 12 + 12 + 1 + 1 + 12 + 12
    tables = sum(t.numel() * t.element_size() for t in (
        pack.mat_kind, pack.mat_c0, pack.mat_c1, pack.mat_s0, pack.mat_s1,
        pack.mat_remap, pack.mat_tex, pack.mat_mf, pack.light_c,
        *pack.inst_em_tris, *pack.inst_em_n)) \
        + lights * (shade_ops.TABLE_W + shade_ops.STATIC_W) * 4 + 12
    if last:
        return n * (hit + 12 + 1 + 1 + 12 + 12) + tables
    u = 4 * (4 + 2 * meta.n_lights)
    # the state, the next cast's bounds, per light its mask, contribution
    # and endpoint
    outs = 12 + 12 + 1 + 1 + 4 + 12 + 12 + 4 + 4 + lights * (1 + 12 + 12)
    return n * (hit + state + u + outs) + tables + 4


def count_library():
    lib = cuda_build.load_library(*COUNT_LIBRARY, shade_ops._declare)
    lib.shade_count_ops.argtypes = [ctypes.c_void_p]
    lib.shade_count_ops.restype = ctypes.c_int
    return lib


def counted_ops(fn, n: int, dev):
    """(float operations fn's shade_vertex or nee_accumulate launch makes
    on its inputs, fn's output), by the COUNT_LIBRARY build of the kernel
    (each lane counts its own branch's operations) set in the wrappers'
    library's place; its launches are not counted."""
    lib = count_library()
    counts = torch.zeros((n + 256,), dtype=torch.int64, device=dev)
    if lib.shade_count_ops(counts.data_ptr()) != 0:
        raise AssertionError("the counting build did not take its buffer")
    inner = shade_ops._library
    shade_ops._library = lambda: lib
    try:
        got, _ = launch_registry.counted_apart(fn)
        torch.cuda.synchronize()
    finally:
        shade_ops._library = inner
    return int(counts.sum()), got


def same_vertex(a, b) -> bool:
    return all(differing_lanes(x, y, 0 if x.dim() < 2 or k < 7 else 1)
               .sum() == 0 for k, (x, y) in enumerate(zip(
                   (*a.state, a.useful, a.contrib, a.shadow_to),
                   (*b.state, b.useful, b.contrib, b.shadow_to))))


def time_vertex(label, call, smi: str, reps: int = 20) -> dict:
    """One recorded shade_vertex call and the nee_accumulate after it,
    each kernel timed by events, host enqueue and the profiler's device
    time (also with an L2 flush before each call), its plain version by
    events, and its bound: the bytes it must
    move (vertex_bytes; nee_accumulate: L and the lights' masks and
    contributions in, L out) at HBM_BW against its float operations at
    F32_PEAK, counted by the counting build on these inputs."""
    (_, a, kw, got), (_, na, _, _) = call
    meta, pack, hit, state, u, bounce, depth = a
    n = state.L.shape[0]
    nj = got.useful.shape[0]
    k = lambda: shade_ops.shade_vertex(*a, **kw)
    p = lambda: shade_ops.shade_vertex_plain(meta, pack, hit, state, u,
                                             bounce, depth)
    nk = lambda: shade_ops.nee_accumulate(*na)
    npl = lambda: shade_ops.nee_accumulate_plain(*na)
    out = {}
    flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.int32,
                        device=state.L.device)
    ops, counted = counted_ops(k, n, state.L.device)
    if not same_vertex(counted, got):
        raise AssertionError("the counting build's vertex differs from the "
                             "kernel's")
    nee_ops, counted = counted_ops(nk, n, state.L.device)
    if differing_lanes(counted, nk(), 0).any():
        raise AssertionError("the counting build's nee_accumulate differs")
    for name, fn, plain, kernel, nbytes, flops in (
            ("shade_vertex", k, p, "shade_vertex_kernel",
             vertex_bytes(meta, pack, n, nj, bounce >= depth), ops),
            ("nee_accumulate", nk, npl, "nee_accumulate_kernel",
             n * (12 + 12) + nj * n * (1 + 1 + 12), nee_ops)):
        ms, _ = time_ms(fn, reps)
        ev, host, host_max, stalls, _ = time_enqueue_ms(fn, reps)
        (src, dev_ms), = profiled_ms(fn, reps, (kernel,)).items()
        # the same calls each after a write of L2_FLUSH_BYTES: repeated
        # calls find their inputs in the 50 MB L2, which the bound's bytes
        # at HBM_BW do not count on
        cold = lambda: (flush.fill_(0), fn())
        (_, cold_ms), = profiled_ms(cold, reps, (kernel,)).items()
        plain_ms, _ = time_ms(plain, 3)
        b = bound(nbytes, flops)
        out[name] = {"ms": ms, "enqueue_ms": host, "device_ms": dev_ms,
                     "device_cold_ms": cold_ms,
                     "device_source": src,
                     "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "bytes": nbytes, "flops": flops,
                     "lanes": n, "lights": nj, "bounce": bounce}
        print(f"{label} {name} at bounce {bounce} ({n} lanes, {nj} NEE "
              f"lights): kernel {ms:.4f} ms by events, host enqueue "
              f"{host:.4f} ms (largest {host_max:.4f}), device "
              f"{dev_ms:.4f} ms ({out[name]['device_source']}), "
              f"{cold_ms:.4f} ms after an L2 flush each; plain "
              f"{plain_ms:.3f} ms; bound {b[0]:.4f} ms by {b[1]} ({nbytes} "
              f"bytes, {flops} float operations, "
              f"{flops / n:.1f} a lane) [{smi}]", flush=True)
    return out


def torch_rules(dev, n: int = 1 << 20) -> dict:
    """How torch's CUDA ops round what csrc/shade.cu mirrors, on n seeded
    rows (wide exponents, signed zeros, cancellations): for torch.sum(p,
    -1) over 3 and torch.linalg.cross, the rows each candidate rounding
    order misses (the kernel takes the one that misses none; its gate is
    the kernel-vs-plain comparison, this is the diagnosis)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = lambda: (torch.randn(n, 3, generator=g)
                    * torch.exp(3 * torch.randn(n, 3, generator=g)))
    a, b = rows(), rows()
    a[:1000], b[:1000] = torch.tensor([0.0, -0.0, 1.0]), torch.tensor(
        [-1.0, 0.0, 0.0])
    a[1000:2000], b[1000:2000] = torch.tensor([1e8, -1e8, 1.0]), 1.0
    a[2000:3000], b[2000:3000] = -0.0, 1.0
    a, b = a.to(dev), b.to(dev)
    p = a * b
    bits = lambda x: x.view(torch.int32)
    miss = lambda x, y: int((bits(x) != bits(y)).sum())
    total = torch.sum(p, dim=-1)
    p0, p1, p2 = p.unbind(-1)
    out = {"sum (p0 + p1) + p2": miss((p0 + p1) + p2, total),
           "sum (p0 + p2) + p1": miss((p0 + p2) + p1, total),
           "sum ((0 + p0) + p2) + (0 + p1)": miss(
               ((0.0 + p0) + p2) + (0.0 + p1), total)}
    c = torch.linalg.cross(a, b, dim=-1)
    (a0, a1, a2), (b0, b1, b2) = a.unbind(-1), b.unbind(-1)
    # float64 holds each product exactly: one rounding, as fmaf's
    fma = lambda x, y, z: (x.double() * y.double() + z.double()).float()
    out["cross a1 b2 - a2 b1"] = miss(torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1), c)
    out["cross fmaf(a1, b2, -(a2 b1))"] = miss(torch.stack(
        [fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
         fma(a0, b1, -(a1 * b0))], -1), c)
    print(f"torch's CUDA rounding on {n} rows, rows each candidate misses: "
          + ", ".join(f"{k} {v}" for k, v in out.items()), flush=True)
    return out


def vertex_phase(cases, dev, smi: str, time_case: str | None = None) -> dict:
    """For each (label, scene, res) of cases: one eager 1-spp wave at
    res^2, depth VERTEX_DEPTH, its shade_vertex and nee_accumulate calls
    recorded (exactly depth + 1 and depth) and each held bit for bit
    against its plain version (check_vertex_calls); then the frame of that
    wave on the kernel route against the plain route (plain_vertex),
    image and stats bit for bit. On the case labelled time_case, the
    bounce-1 vertex is timed (time_vertex). Returns {label: counts} and,
    where timed, "times"."""
    out = {}
    for label, scene, res in cases:
        kw = dict(spp=1, max_depth=VERTEX_DEPTH, seed=1, clamp=False,
                  device=dev, graph=False, with_stats=True)
        calls = []
        with torch.no_grad(), vertex_calls(calls):
            img, st = render(scene, res, res, **kw)
        got = collections.Counter(c[0] for c in calls)
        want = {"shade_vertex": VERTEX_DEPTH + 1,
                "nee_accumulate": VERTEX_DEPTH}
        if dict(got) != want:
            raise AssertionError(f"{label}: one wave made {dict(got)}, "
                                 f"expected {want}")
        out[label] = check_vertex_calls(label, calls)
        if label == time_case:
            sv = [c for c in calls if c[0] == "shade_vertex"]
            na = [c for c in calls if c[0] == "nee_accumulate"]
            out["times"] = time_vertex(label, (sv[1], na[1]), smi)
        del calls
        with plain_vertex():
            pimg, pst = render(scene, res, res, **kw)
        if not torch.equal(img, pimg) or st != pst:
            raise AssertionError(
                f"{label}: the kernel route's frame differs from the plain "
                f"route's (max |diff| {float((img - pimg).abs().max())}, "
                f"stats {st} vs {pst})")
        print(f"{label} {res}^2 1-spp frame: the kernel route's image and "
              f"stats equal the plain route's bit for bit ({st['rays']} "
              "rays)", flush=True)
    return out


# --------------------------------------------------------------------------
# 2d. the brute-force casts (ops/brute.py)
# --------------------------------------------------------------------------

# float operations per (lane, shape) test of each kind, counted on the
# plain formula (ops/intersect.py): products, sums, the division, the
# square root and clamp, |x| > eps, each comparison of the valid predicate
# and the running minimum's. Triangle: p 9, det 5, |det| > eps 1, 1 / det
# 1, o - p0 3, u 6, q 9, v 6, t 6, u + v and the 5 comparisons 6, minimum
# 1. Sphere: c - o 3, b 5, det 8, clamp and sqrt 2, t_near and t_far 2,
# 4 range comparisons, det >= 0 1, minimum 1. Rect: corners 12, four
# cross-dot-d 56, 8 sign comparisons, denom 5, |denom| > eps 1, numerator
# 5, division 1, range 2, minimum 1. Disk: denom 5, c - o 3, |denom| >
# eps 1, numerator 5, division 1, o + t d - c 9, r2 5, r2 <= r^2 1, range
# 2, minimum 1.
BRUTE_OPS = {"tri": 53, "sph": 26, "rect": 91, "disk": 33}
# the shapes' bytes per row as the kernel reads them
BRUTE_SHAPE_BYTES = {"tri": 36, "sph": 16, "rect": 60, "disk": 28}
# o, d, tmin, tmax of a live lane
BRUTE_RAY_BYTES = 4 * (3 + 3 + 1 + 1)


@contextlib.contextmanager
def brute_calls(out: list):
    """While open, each call of brute_ops.brute_hits appends (args,
    keywords, output) to `out` (the wave makes no in-place change). The
    wrapped function counts on the name in the module (functools.wraps
    copies the count), as vertex_calls does."""
    inner = brute_ops.brute_hits

    @functools.wraps(inner)
    def call(*a, **kw):
        got = inner(*a, **kw)
        out.append((a, kw, got))
        return got

    brute_ops.brute_hits = call
    try:
        yield out
    finally:
        brute_ops.brute_hits = inner


def into_out(plain):
    """plain taking the out (and rows) arguments its wrapper takes, its
    output copied there: the plain routes' stand-in for a wrapper that
    writes its caller's slab rows."""
    def call(*a, out=None, rows=None, **kw):
        got = plain(*a, **kw)
        if out is None:
            return got
        if torch.is_tensor(got):
            return out.copy_(got)
        rows = range(len(got)) if rows is None else rows
        for j, h in zip(rows, got):
            for slab, x in zip(out, h):
                slab[j].copy_(x)
        return [isect_ops.KindHit(*(slab[j] for slab in out)) for j in rows]
    return call


def without_out(kw: dict) -> dict:
    """A recorded call's keywords but the slab rows its wrapper wrote
    (the plain version returns what it computes)."""
    return {k: v for k, v in kw.items() if k not in ("out", "rows")}


@contextlib.contextmanager
def plain_brute():
    """While open, the plain version stands in the wrapper's place, so
    every cast tests its brute-force shapes in torch ops (a measurement
    only)."""
    inner = brute_ops.brute_hits
    brute_ops.brute_hits = into_out(isect_ops.brute_hits_plain)
    try:
        yield
    finally:
        brute_ops.brute_hits = inner


def brute_outputs(got, any_hit: bool) -> list:
    """A brute_hits output as [(name, tensor)]: per kind its t, index and
    valid, or the one any-hit flag."""
    if any_hit:
        return [("occluded", got)]
    return [(f"{k}{j}", x) for j, h in enumerate(got)
            for k, x in zip(("t", "index", "valid"), h)]


def check_brute_call(label: str, a, kw, got) -> tuple:
    """One brute_hits call against brute_hits_plain on the same inputs,
    every output bit for bit; a differing lane is printed with its inputs
    before the run fails. Returns (lanes, differing lanes, the largest
    |t| difference on lanes finite in both)."""
    o, d, tmin, tmax, shapes, any_hit = a
    want = isect_ops.brute_hits_plain(o, d, tmin, tmax, shapes, any_hit)
    g, w = brute_outputs(got, any_hit), brute_outputs(want, any_hit)
    if [n for n, _ in g] != [n for n, _ in w]:
        raise AssertionError(f"{label}: outputs {[n for n, _ in g]}, the "
                             f"plain version's {[n for n, _ in w]}")
    lanes = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    err = 0.0
    for (name, x), (_, y) in zip(g, w):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{label} {name}: {x.dtype} "
                                 f"{tuple(x.shape)} vs {y.dtype} "
                                 f"{tuple(y.shape)}")
        lanes |= differing_lanes(x, y, 0)
        if x.dtype == torch.float32:
            fin = torch.isfinite(x) & torch.isfinite(y)
            if fin.any():
                err = max(err, float((x[fin] - y[fin]).abs().max()))
    bad = int(lanes.sum())
    for i in lanes.nonzero().flatten()[:4].tolist():
        print(f"{label} lane {i}: o {o[i].tolist()} d {d[i].tolist()} tmin "
              f"{float(tmin[i])} tmax {float(tmax[i])}; kernel "
              f"{[(n, x[i].item()) for n, x in g]}, plain "
              f"{[(n, x[i].item()) for n, x in w]}", flush=True)
    return o.shape[0], bad, err


def check_brute_calls(label: str, calls: list) -> dict:
    """Each recorded call held against its plain version (check_brute_call);
    prints the counts by mode and fails on any differing lane. Returns
    {"calls", "lanes", "differing", "max_abs_err"}."""
    out = {"calls": 0, "lanes": 0, "differing": 0, "max_abs_err": 0.0}
    by_mode = collections.Counter()
    for a, kw, got in calls:
        any_hit = a[5]
        n, bad, err = check_brute_call(label, a, kw, got)
        out["calls"] += 1
        out["lanes"] += n
        out["differing"] += bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        by_mode["any hit" if any_hit else "closest"] += 1
    print(f"{label}: {out['calls']} brute_hits calls ({dict(by_mode)}), "
          f"{out['lanes']} lanes, {out['differing']} lanes differ from the "
          "plain version", flush=True)
    if out["differing"]:
        raise AssertionError(f"{label}: the brute-force kernel differs from "
                             f"its plain version on {out['differing']} lanes")
    return out


def short_of_closest(o, d, tmin, tmax, shapes):
    """An any-hit tmax for the rays: 10% short of the plain version's
    closest hit, 1e3 where there is none, tmax kept on dead lanes
    (tmax < 0)."""
    want = isect_ops.brute_hits_plain(o, d, tmin, tmax, shapes, False)
    t = torch.stack([h.t for h in want]).amin(0)
    tm = torch.where(torch.isfinite(t), t * 0.9, torch.full_like(t, 1e3))
    return torch.where(tmax < 0, tmax, tm).contiguous()


def brute_both_modes(label: str, o, d, tmin, tmax, shapes,
                     any_tmax=None) -> dict:
    """The kernel against the plain version on one ray set, closest hit
    and any hit with tmax `any_tmax` (default short_of_closest)."""
    o, d, tmin, tmax = (x.contiguous() for x in (o, d, tmin, tmax))
    calls = []
    with brute_calls(calls):
        brute_ops.brute_hits(o, d, tmin, tmax, shapes, False)
        tm = (short_of_closest(o, d, tmin, tmax, shapes) if any_tmax is None
              else any_tmax.contiguous())
        brute_ops.brute_hits(o, d, tmin, tm, shapes, True)
    torch.cuda.synchronize()
    return check_brute_calls(label, calls)


def brute_wave(label: str, scene, res: int, dev) -> tuple:
    """One eager 1-spp wave of scene at res^2, depth VERTEX_DEPTH, its
    brute_hits calls recorded: exactly one per cast, (depth + 1) + depth x
    lights. Returns (calls, image)."""
    meta = scene.meta
    calls = []
    with torch.no_grad(), brute_calls(calls):
        img = render(scene, res, res, spp=1, max_depth=VERTEX_DEPTH, seed=1,
                     clamp=False, device=dev, graph=False)
    lights = sum(1 for lt in meta.lights if not lt.static_black)
    want = n_waves(res, res, 1, DEFAULT_CHUNK) * (
        (VERTEX_DEPTH + 1) + VERTEX_DEPTH * lights)
    if len(calls) != want:
        raise AssertionError(f"{label}: one wave made {len(calls)} "
                             f"brute_hits calls, expected {want}")
    return calls, img


def brute_work(o, d, tmin, tmax, shapes, any_hit: bool) -> dict:
    """The (lane, shape) tests the function needs on these inputs, per
    kind, from the plain version's [M, N] valid masks: every shape of
    every live lane (tmin < tmax) in closest mode; in any-hit mode each
    live lane's shapes in kind and index order up to its first valid one.
    Returns {kind: tests}, "flops" (BRUTE_OPS each), "live"."""
    masks = []
    inner = isect_ops._closest_mn

    def keep(t, v):
        masks.append(v)
        return inner(t, v)

    isect_ops._closest_mn = keep
    try:
        isect_ops.brute_hits_plain(o, d, tmin, tmax, shapes, False)
    finally:
        isect_ops._closest_mn = inner
    live = tmin < tmax
    testing = live.clone()
    out = {"live": int(live.sum()), "flops": 0}
    for f, v in zip(shapes.present, masks):
        m = v.shape[0]
        if any_hit:
            v = v & testing[None]
            hit = v.any(0)
            first = torch.argmax(v.to(torch.uint8), 0) + 1
            tests = int(torch.where(testing, torch.where(hit, first, m),
                                    0).sum())
            testing &= ~hit
        else:
            tests = out["live"] * m
        out[f] = tests
        out["flops"] += tests * BRUTE_OPS[f]
    return out


def brute_bytes(o, tmin, tmax, shapes, any_hit: bool) -> int:
    """Bytes one cast must move: o, d, tmin, tmax of a live lane (tmin,
    tmax of a dead one) and the shapes read once; per lane t, index and
    valid of each kind written once (closest), or one flag (any hit)."""
    n = o.shape[0]
    live = int((tmin < tmax).sum())
    shape_bytes = sum(BRUTE_SHAPE_BYTES[f] * getattr(shapes, f)[0].shape[0]
                      for f in shapes.present)
    out = n * (1 if any_hit else 9 * len(shapes.present))
    return live * BRUTE_RAY_BYTES + (n - live) * 8 + shape_bytes + out


def brute_bounds(o, d, tmin, tmax, shapes, any_hit: bool) -> dict:
    """A cast's bound, both ways: "bound" prices brute_work's operations
    as one issued instruction each (int_rates' issue rate: none of them
    can be contracted into an FMA, since the kernel must round each as the
    plain version does), "flop_bound" at F32_PEAK (which counts an FMA as
    two), each against brute_bytes at HBM_BW. Returns those (ms, what
    binds) pairs, "work" and "bytes"."""
    work = brute_work(o, d, tmin, tmax, shapes, any_hit)
    nbytes = brute_bytes(o, tmin, tmax, shapes, any_hit)
    return {"work": work, "bytes": nbytes,
            "bound": bound(nbytes, work["flops"], (0, 0, work["flops"])),
            "flop_bound": bound(nbytes, work["flops"])}


def timed_brute_calls(calls: list) -> tuple:
    """Of a wave's recorded brute_hits calls, the bounce-1 closest cast's
    and the first shadow cast's after it (each (args, kw, output))."""
    i = [k for k, c in enumerate(calls) if not c[0][5]][1]
    return calls[i], next(c for c in calls[i + 1:] if c[0][5])


def time_brute(label: str, calls: list, smi: str, reps: int = 20) -> dict:
    """The bounce-1 closest cast and the first shadow cast after it, each
    timed: the kernel by events, host enqueue and the profiler's device
    time (warm, and after an L2 flush each), the plain version by events,
    and the bounds (brute_bounds)."""
    out = {}
    flush = None
    for mode, (a, kw, _) in zip(("closest", "shadow"),
                                timed_brute_calls(calls)):
        o, d, tmin, tmax, shapes, any_hit = a
        if flush is None:
            flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.int32,
                                device=o.device)
        k = lambda: brute_ops.brute_hits(*a)
        p = lambda: isect_ops.brute_hits_plain(*a)
        bb = brute_bounds(o, d, tmin, tmax, shapes, any_hit)
        work, nbytes, b, fb = bb["work"], bb["bytes"], bb["bound"], \
            bb["flop_bound"]
        ms, _ = time_ms(k, reps)
        ev, host, host_max, _, _ = time_enqueue_ms(k, reps)
        (src, dev_ms), = profiled_ms(k, reps, ("brute_hits_kernel",)).items()
        cold = lambda: (flush.fill_(0), k())
        (_, cold_ms), = profiled_ms(cold, reps,
                                    ("brute_hits_kernel",)).items()
        plain_ms, _ = time_ms(p, 3)
        out[mode] = {"ms": ms, "enqueue_ms": host, "device_ms": dev_ms,
                     "device_cold_ms": cold_ms,
                     "device_source": "profiler" if src == "brute_hits_kernel"
                     else src, "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "flop_bound_ms": fb[0],
                     "bytes": nbytes, "work": work, "lanes": o.shape[0]}
        print(f"{label} brute_hits {mode} cast ({o.shape[0]} lanes, "
              f"{work['live']} live, shapes "
              f"{ {f: getattr(shapes, f)[0].shape[0] for f in shapes.present} }"
              f"): kernel {ms:.4f} ms by events, host enqueue {host:.4f} ms "
              f"(largest {host_max:.4f}), device {dev_ms:.4f} ms "
              f"({out[mode]['device_source']}), {cold_ms:.4f} ms after an L2 "
              f"flush each; plain {plain_ms:.3f} ms; bound {b[0]:.4f} ms by "
              f"{b[1]} ({nbytes} bytes, {work['flops']} float operations, "
              f"one issued instruction each: tests by kind "
              f"{ {f: work[f] for f in shapes.present} }), device time "
              f"{dev_ms / b[0]:.2f}x it; at {F32_PEAK / 1e12:.0f} TFLOP/s "
              f"{fb[0]:.4f} ms by {fb[1]}, {dev_ms / fb[0]:.2f}x [{smi}]",
              flush=True)
    return out


def many_shapes_scene(builder=SceneBuilder):
    """More brute-force shapes than one of the kernel's shared-memory
    tiles of each kind: 3,000 spheres, 2,000 triangles (use_bvh=False),
    300 rects and 300 disks in a box, an area light and an env light."""
    g = np.random.default_rng(11)
    b = builder("many-shapes")
    b.set_camera(lookfrom=(0, 0, 30), lookat=(0, 0, 0), vfov=50)
    white = b.add_matte((0.7, 0.7, 0.7))
    red = b.add_plastic((0.6, 0.2, 0.2), (0.4, 0.4, 0.4), 0.3)
    for c, r in zip(g.uniform(-10, 10, (3000, 3)), g.uniform(0.1, 0.5, 3000)):
        b.add_sphere(tuple(c), float(r), red)
    b.add_mesh(g.uniform(-10, 10, (2000, 1, 3))
               + g.uniform(-0.6, 0.6, (2000, 3, 3)), white)
    for x, z in g.uniform(-10, 9, (300, 2)):
        b.add_rect_xz(x, x + 0.7, z, z + 0.7, float(g.uniform(-10, 10)),
                      white)
    for c, n in zip(g.uniform(-10, 10, (300, 3)), g.normal(size=(300, 3))):
        b.add_disk(tuple(c), tuple(n), 0.4, white)
    b.add_area_light(b.add_rect_xz(-3, 3, -3, 3, 12, white,
                                   flip_normal=True), (6.0, 6.0, 6.0))
    b.add_env_light((0.2, 0.2, 0.25))
    return b.build(use_bvh=False)


def edge_rays(shapes, n: int, lo, hi, seed: int, dev):
    """n rays from seeded points in the box [lo, hi] aimed at the shapes'
    edges and corners: each triangle's vertices and points on its edges
    (a quad's two triangles share their diagonal), each rect's corners and
    diagonals."""
    g = np.random.default_rng(seed)
    targets = []
    if shapes.tri is not None:
        p = np.stack([x.cpu().numpy() for x in shapes.tri], 1)  # [T,3,3]
        for a, b in ((0, 1), (1, 2), (2, 0)):
            for s in (0.0, 0.25, 0.5, 1.0 / 3.0):
                targets.append(p[:, a] + np.float32(s) * (p[:, b] - p[:, a]))
    if shapes.rect is not None:
        q = shapes.rect[0].cpu().numpy()
        for a, b in ((0, 2), (1, 3), (0, 1)):
            for s in (0.0, 0.5, 0.3):
                targets.append(q[:, a] + np.float32(s) * (q[:, b] - q[:, a]))
    targets = np.concatenate(targets)
    t = targets[g.integers(0, len(targets), n)]
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = (t - o).astype(np.float64)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return (f(o).contiguous(), f(d).contiguous(),
            torch.full((n,), 1e-3, device=dev),
            torch.full((n,), float("inf"), device=dev))


def compaction_lanes(o, d, tmin, tmax):
    """The rays in four quarters for the kernel's lane compaction: all
    dead; one live lane in 2,048 (blocks with one live lane and blocks
    with none); live only at the last 6 of every 256 lanes (a span's last
    slots, for any span that is a multiple of 256); all kept, with NaN and
    inf directions mixed into the live lanes. Lanes made dead get tmin =
    inf, tmax = -1."""
    n = o.shape[0]
    i = torch.arange(n, device=o.device)
    q = n // 4
    keep = torch.where(i < 2 * q, (i >= q) & (i % 2048 == 1234),
                       (i >= 3 * q) | (i % 256 >= 250))
    tmin = torch.where(keep, tmin, torch.full_like(tmin, float("inf")))
    tmax = torch.where(keep, tmax, torch.full_like(tmax, -1.0))
    d = d.clone()
    last = i >= 3 * q
    d[last & (i % 7 == 3)] = float("nan")
    d[last & (i % 11 == 5)] = float("inf")
    d[(last & (i % 13 == 2)).nonzero().flatten(), 1] = float("-inf")
    return o, d.contiguous(), tmin.contiguous(), tmax.contiguous()


def cut_shapes(shapes, m: int):
    """The first m shapes of every kind present."""
    return isect_ops.BruteShapes(*(
        None if x is None else tuple(y[:m].contiguous() for y in x)
        for x in shapes))


def last_tile_set(n: int, dev):
    """n rays from near the origin towards +z and 300 spheres, the first
    299 behind the rays' origins and the last one in front of them, so
    that an any-hit ray's only hit is in the last tile. Returns (o, d,
    tmin, tmax, shapes)."""
    g = np.random.default_rng(27)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=dev)
    c = np.concatenate([g.uniform(-50, 50, (299, 3)) - [0, 0, 100],
                        [[0.0, 0.0, 50.0]]])
    r = np.concatenate([g.uniform(1, 5, 299), [20.0]])
    o = g.uniform(-1, 1, (n, 3)) * [1, 1, 0]
    d = np.concatenate([g.uniform(-0.4, 0.4, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (f(o), f(d), torch.full((n,), 1e-3, device=dev),
            torch.full((n,), float("inf"), device=dev),
            isect_ops.BruteShapes(tri=None, sph=(f(c), f(r)), rect=None,
                                  disk=None))


def division_set(n: int, dev):
    """The triangle test's division edges: axis-aligned right triangles of
    side a in the planes z = 10 + k, det = -a^2 for a ray along +z. a =
    1.2e19 and 1.6e19 give 1 / det subnormal, 3e19 an infinite det (1 /
    det = -0, so u, v and t are zeros or NaN), 1e-6 and its neighbours
    det at the 1e-12 threshold; one triangle has a NaN vertex. A quarter
    of the rays start 1e-30 off a vertex (u and v round to zero or
    underflow against a subnormal 1 / det; tmin 1e-3), the rest from the
    plane z = 0, half of those with tmin = -1 (a valid t = +-0 on the
    infinite det). Returns (o, d, tmin, tmax, shapes)."""
    g = np.random.default_rng(28)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=dev)
    a = np.array([1.2e19, 1.6e19, 3e19, 1e-6, 1.0000001e-6, 0.9999999e-6,
                  1.0, 1e10])
    k = np.arange(len(a))
    p0 = np.stack([-a / 3, -a / 3, 10.0 + k], 1)
    p1, p2 = p0 + a[:, None] * [1, 0, 0], p0 + a[:, None] * [0, 1, 0]
    p0, p1, p2 = (np.concatenate([p, [[np.nan, 0.0, 20.0]]])
                  for p in (p0, p1, p2))
    i = np.arange(n)
    on = i % 4 == 0
    o = g.uniform(-1, 1, (n, 3)) * [1, 1, 0]
    o[on] = p0[(i[on] // 4) % len(a)].astype(np.float32) + 1e-30 * np.sign(
        g.normal(size=(on.sum(), 3)))
    d = np.concatenate([g.uniform(-0.1, 0.1, (n, 2)), np.ones((n, 1))], 1)
    d[on] = [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.where(~on & (i % 2 == 1), -1.0, 1e-3)
    return (f(o), f(d), f(tmin), torch.full((n,), float("inf"), device=dev),
            isect_ops.BruteShapes(tri=(f(p0), f(p1), f(p2)), sph=None,
                                  rect=None, disk=None))


def brute_edges(cornell, bunny, dev, many_res: int = 128) -> dict:
    """The kernel against the plain version, both modes, on edge sets:
    coincident duplicate triangles and spheres (the tie rule); rays aimed
    at the shared diagonals and corners of the Cornell box's quads and the
    bunny's rects; dead lanes with NaN and inf directions and a live lane
    with a NaN one; finite tmax, equal to a closest hit's t on some lanes
    and to tmin on others; the lane compaction's cases (compaction_lanes
    on 257^2 lanes, and on 1025^2 lanes against 129 shapes of each kind:
    counts no block span divides, the kernel's small and large spans); an
    any-hit whose only
    hit is in the last tile (last_tile_set); the triangle division's edges
    (division_set); the many-shapes scene (more shapes than a tile of each
    kind), and its first 256 and 257 shapes of each kind. Returns {set:
    check_brute_calls' counts}."""
    out = {}
    cs = scene_pack.brute_shapes(cornell.meta, cornell.pack)
    bs = scene_pack.brute_shapes(bunny.meta, bunny.pack)
    wo, wd, wt0, wt1 = wave_rays(cornell, 256, 21, dev)
    # coincident duplicates: every Cornell triangle twice, and 3 spheres
    # twice each at the box's centre
    dup_tri = tuple(torch.cat([x, x]).contiguous() for x in cs.tri)
    c = torch.tensor([[278.0, 273.0, 280.0], [200.0, 100.0, 300.0],
                      [350.0, 300.0, 200.0]], device=dev)
    r = torch.tensor([80.0, 40.0, 60.0], device=dev)
    dup = isect_ops.BruteShapes(
        tri=dup_tri, sph=(torch.cat([c, c]), torch.cat([r, r])), rect=None,
        disk=None)
    out["duplicates"] = brute_both_modes("duplicate triangles and spheres",
                                         wo, wd, wt0, wt1, dup)
    o, d, t0, t1 = edge_rays(cs, 1 << 16, (1.0, 1.0, 1.0),
                             (555.0, 548.0, 558.0), 22, dev)
    out["cornell edges"] = brute_both_modes("cornell quad diagonals and "
                                            "corners", o, d, t0, t1, cs)
    o, d, t0, t1 = edge_rays(bs, 1 << 16, (-8.0, 0.5, -8.0),
                             (8.0, 12.0, 8.0), 23, dev)
    out["bunny edges"] = brute_both_modes("bunny rect diagonals and corners",
                                          o, d, t0, t1, bs)
    # dead lanes with NaN and inf directions, a live lane with a NaN one
    n = wo.shape[0]
    k = torch.arange(n, device=dev) % 4
    bad_d = torch.where((k == 1)[:, None], torch.full_like(wd, float("nan")),
                        torch.where((k == 2)[:, None],
                                    torch.full_like(wd, float("inf")), wd))
    dead = (k == 1) | (k == 2)
    t0 = torch.where(dead, torch.full_like(wt0, float("inf")), wt0)
    t1 = torch.where(dead, torch.full_like(wt1, -1.0), wt1)
    bad_d[7] = float("nan")
    t0[7], t1[7] = 1e-3, float("inf")
    out["dead"] = brute_both_modes("dead lanes (NaN, inf directions)", wo,
                                   bad_d, t0, t1, cs)
    # finite tmax: a closest hit's own t (t < tmax fails), its t as tmin,
    # and half of it
    hit = isect_ops.brute_hits_plain(wo, wd, wt0, wt1, cs, False)[0]
    th = torch.where(hit.valid, hit.t, torch.full_like(hit.t, 100.0))
    t1 = torch.where(k == 0, th, torch.where(k == 1, th * 0.5, th * 4.0))
    t0 = torch.where(k == 2, th, wt0)
    t1 = torch.where(wt1 < 0, wt1, t1)
    out["finite tmax"] = brute_both_modes("finite tmax", wo, wd, t0, t1, cs)
    out["compaction"] = brute_both_modes(
        "compaction (dead blocks, lone and last-slot live lanes, NaN and "
        "inf directions; 257^2 lanes)",
        *compaction_lanes(*wave_rays(cornell, 257, 25, dev)), cs)
    many = many_shapes_scene().to(dev)
    ms = scene_pack.brute_shapes(many.meta, many.pack)
    out["compaction 1025^2"] = brute_both_modes(
        "compaction on 1025^2 lanes (the kernel's large span), 129 "
        "shapes of each kind", *compaction_lanes(*wave_rays(
            many, 1025, 26, dev)), cut_shapes(ms, 129))
    *rays, ls = last_tile_set(1 << 14, dev)
    out["last tile"] = brute_both_modes(
        "only hit in the last tile (300 spheres)", *rays, ls,
        any_tmax=rays[3])
    *rays, ds = division_set(1 << 14, dev)
    out["division"] = brute_both_modes(
        "triangle division edges (subnormal and infinite 1 / det, det at "
        "the threshold, NaN vertex)", *rays, ds)
    o, d, t0, t1 = wave_rays(many, many_res, 24, dev)
    out["many shapes"] = brute_both_modes(
        f"many shapes ({ {f: getattr(ms, f)[0].shape[0] for f in ms.present} })",
        o, d, t0, t1, ms)
    for m in (256, 257):
        out[f"{m} shapes"] = brute_both_modes(
            f"{m} shapes of each kind", o, d, t0, t1, cut_shapes(ms, m))
    calls, _ = brute_wave("many shapes wave", many, many_res, dev)
    out["many shapes wave"] = check_brute_calls(
        f"many-shapes {many_res}^2 wave", calls)
    return out


def brute_frames(cases, dev) -> None:
    """Each (label, scene, res, spp) frame, eager, on the kernel route
    against the same frame on the plain route (plain_brute), image and
    stats bit for bit."""
    for label, scene, res, spp in cases:
        kw = dict(spp=spp, max_depth=VERTEX_DEPTH, seed=0, clamp=False,
                  device=dev, graph=False, with_stats=True)
        img, st = render(scene, res, res, **kw)
        with plain_brute():
            pimg, pst = render(scene, res, res, **kw)
        if not torch.equal(img, pimg) or st != pst:
            raise AssertionError(
                f"{label}: the brute-force kernel's frame differs from the "
                f"plain version's (max |diff| "
                f"{float((img - pimg).abs().max())}, stats {st} vs {pst})")
        print(f"{label} {res}^2 {spp}-spp frame: the brute-force kernel "
              f"route's image and stats equal the plain route's bit for bit "
              f"({st['rays']} rays)", flush=True)


def brute_phase(cases, dev, smi: str, time_case: str | None = None) -> dict:
    """For each (label, scene, res) of cases one eager 1-spp wave, its
    brute_hits calls recorded (brute_wave) and each held bit for bit
    against the plain version (check_brute_calls); on the case labelled
    time_case its bounce-1 closest and shadow casts timed (time_brute).
    Returns {label: counts} and, where timed, "times"."""
    out = {}
    for label, scene, res in cases:
        calls, _ = brute_wave(label, scene, res, dev)
        out[label] = check_brute_calls(f"{label} {res}^2 wave", calls)
        if label == time_case:
            out["times"] = time_brute(label, calls, smi)
        del calls
    return out


# --------------------------------------------------------------------------
# 2e. the casts' set-up and the hit reconstruction
# --------------------------------------------------------------------------

# what each of ops/rays.py's kernels replaces (the kernels line)
RAYS_REPLACES = {
    "shadow_key": "jet_pbrt_tpu/ops/sort.py:77 (bvh_needed and the sort keys, "
                  ":45-127, with occluded's segment, scene/pack.py:537-562, "
                  "and li_path's key, models/integrators.py:250-260, under "
                  "jax.jit(wave): XLA fusion, no Pallas kernel)",
    "shadow_segments": "jet_pbrt_tpu/scene/pack.py:537 (occluded's segment "
                       "and its permuting gather, :537-569, under "
                       "jax.jit(wave): XLA fusion, no Pallas kernel)",
    "occlusion_merge": "jet_pbrt_tpu/scene/pack.py:572 (the flags' OR and "
                       "the un-permute, :570-578, under jax.jit(wave): XLA "
                       "fusion, no Pallas kernel)",
    "hit_reconstruct": "jet_pbrt_tpu/scene/pack.py:333 (intersect's merge "
                       "and hit reconstruction, :333-507, under "
                       "jax.jit(wave): XLA fusion, no Pallas kernel)"}
# the module of each of the slice's wrappers (scene/pack.py routes the hit
# reconstruction, whose kernel ops/rays.py launches), its plain version and
# its outputs' names
RAYS_MODULE = {"shadow_key": rays_ops, "shadow_segments": rays_ops,
               "occlusion_merge": rays_ops, "hit_reconstruct": scene_pack}
RAYS_PLAIN = {"shadow_key": rays_ops.shadow_key_plain,
              "shadow_segments": rays_ops.shadow_segments_plain,
              "occlusion_merge": rays_ops.occlusion_merge_plain,
              "hit_reconstruct": scene_pack.hit_reconstruct_plain}
RAYS_OUTPUTS = {"shadow_key": ("key",),
                "shadow_segments": ("o", "d", "tmin", "tmax"),
                "occlusion_merge": ("occluded",),
                "hit_reconstruct": scene_pack.Hit._fields}


@contextlib.contextmanager
def rays_calls(out: list):
    """While open, each call of the slice's wrappers (RAYS_MODULE) appends
    (name, args, keywords, output) to `out` (the wave makes no in-place
    change). The launches count in ops/rays.py, which stays as it is."""
    saved = {name: getattr(RAYS_MODULE[name], name) for name in RAYS}
    for name, inner in saved.items():
        @functools.wraps(inner)
        def call(*a, _inner=inner, _name=name, **kw):
            got = _inner(*a, **kw)
            out.append((_name, a, kw, got))
            return got

        setattr(RAYS_MODULE[name], name, call)
    try:
        yield out
    finally:
        for name, inner in saved.items():
            setattr(RAYS_MODULE[name], name, inner)


@contextlib.contextmanager
def plain_rays():
    """While open, the plain versions stand in the wrappers' places, so
    every cast's set-up and hit reconstruction runs in torch ops (a
    measurement only)."""
    saved = {name: getattr(RAYS_MODULE[name], name) for name in RAYS}
    for name in RAYS:
        setattr(RAYS_MODULE[name], name, into_out(RAYS_PLAIN[name]))
    try:
        yield
    finally:
        for name, inner in saved.items():
            setattr(RAYS_MODULE[name], name, inner)


def rays_outputs(name: str, got) -> list:
    """A wrapper's output as [(name, tensor)], each with its lanes first."""
    got = (got,) if torch.is_tensor(got) else tuple(got)
    return list(zip(RAYS_OUTPUTS[name], got))


def check_rays_call(label: str, name: str, a, kw, got) -> tuple:
    """One recorded call against its plain version on the same inputs,
    every output bit for bit (NaN equal to NaN); a differing lane is
    printed with both values before the run fails. Returns (lanes,
    differing lanes, the largest |difference| on float outputs finite in
    both)."""
    want = RAYS_PLAIN[name](*a, **without_out(kw))
    g, w = rays_outputs(name, got), rays_outputs(name, want)
    lanes = None
    err = 0.0
    for (field, x), (_, y) in zip(g, w):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{label} {name} {field}: {x.dtype} "
                                 f"{tuple(x.shape)} vs {y.dtype} "
                                 f"{tuple(y.shape)}")
        diff = differing_lanes(x, y, 0)
        lanes = diff if lanes is None else lanes | diff
        if x.is_floating_point():
            fin = torch.isfinite(x) & torch.isfinite(y)
            if fin.any():
                err = max(err, float((x[fin] - y[fin]).abs().max()))
    bad = int(lanes.sum())
    for i in lanes.nonzero().flatten()[:4].tolist():
        print(f"{label} {name} lane {i}: kernel "
              f"{[(f, x[i].tolist()) for f, x in g]}, plain "
              f"{[(f, x[i].tolist()) for f, x in w]}", flush=True)
    return lanes.shape[0], bad, err


def check_rays_calls(label: str, calls: list) -> dict:
    """Each recorded call held against its plain version (check_rays_call);
    prints the calls by wrapper and fails on any differing lane. Returns
    {"calls", "lanes", "differing", "max_abs_err"}."""
    out = {"calls": collections.Counter(), "lanes": 0, "differing": 0,
           "max_abs_err": 0.0}
    for name, a, kw, got in calls:
        n, bad, err = check_rays_call(label, name, a, kw, got)
        out["calls"][name] += 1
        out["lanes"] += n
        out["differing"] += bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
    out["calls"] = dict(out["calls"])
    print(f"{label}: ops/rays.py calls {out['calls']}, {out['lanes']} lanes, "
          f"{out['differing']} lanes differ from the plain versions",
          flush=True)
    if out["differing"]:
        raise AssertionError(f"{label}: ops/rays.py's kernels differ from "
                             f"their plain versions on {out['differing']} "
                             "lanes")
    return out


def rays_wave(label: str, scene, res: int, dev) -> list:
    """One eager 1-spp wave of scene at res^2, depth VERTEX_DEPTH, its
    ops/rays.py calls recorded: as many of each as rays_launches counts."""
    calls = []
    with torch.no_grad(), rays_calls(calls):
        render(scene, res, res, spp=1, max_depth=VERTEX_DEPTH, seed=1,
               clamp=False, device=dev, graph=False)
    got = collections.Counter(name for name, *_ in calls)
    want = rays_launches(scene.meta, n_waves(res, res, 1, DEFAULT_CHUNK),
                         VERTEX_DEPTH)
    if dict(got) != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: one wave made the calls {dict(got)},"
                             f" expected {want}")
    return calls


def rays_bytes(name: str, a, kw, got) -> int:
    """Bytes one call must move: every lane's inputs read once and its
    outputs written once; of the tables, the root table and pack scalars
    whole, and of hit_reconstruct's, its int64 table of the kinds' tables
    whole and the rows this call's lanes need (one read of each distinct
    row of each table the winning kind reads)."""
    if name == "shadow_key":
        meta, pack, x, y, *rest = a
        live = rest[0] if rest else kw.get("live")
        n = x.shape[0]
        roots = rays_ops.root_table(meta, pack)
        return (n * (12 + 12 + 4) + (n if live is not None else 0)
                + roots.numel() * 4 + 4 * 5)
    if name == "shadow_segments":
        _, p_from, _, mask, perm = (*a, *(None,) * (5 - len(a)))
        n = p_from.shape[0]
        return (n * (24 + 32) + (n if mask is not None else 0)
                + (8 * n if perm is not None else 0) + 4)
    if name == "occlusion_merge":
        flags = a[0]
        perm = a[1] if len(a) > 1 else kw.get("perm")
        n = flags[0].shape[0]
        return n * (len(flags) + 1) + (8 * n if perm is not None else 0)
    meta, pack, o, d, hits, kinds = a
    n = o.shape[0]
    n_fams = len(meta.n_inst)
    nbytes = (n * (24 + 8 * len(hits) + 1 + 4 + 36 + 8 + 4 + 4)
              + 8 * (2 * len(rays_ops.HIT_TABLES) + len(kinds)
                     + n_fams * (1 + 2 * len(rays_ops.FAMILY_TABLES))))
    _, kind, index, _ = isect_ops.merge_hits(hits, kinds)
    index = index.to(torch.int64)
    want_uv = meta.n_tex > 0
    for name, _, _, k, uv_only in rays_ops.HIT_TABLES:
        if k in kinds and (want_uv or not uv_only):
            x = getattr(pack, name)
            rows = index[kind == k].clamp(0, x.shape[0] - 1).unique().numel()
            nbytes += rows * x[0].numel() * x.element_size()
    for mi in range(n_fams):
        sel = index[kind == scene_pack.KIND_INST + mi]
        nb = meta.n_blas_tris[mi]
        for name, _, _, uv_only in rays_ops.FAMILY_TABLES:
            if want_uv or not uv_only:
                x = getattr(pack, name)[mi]
                by = sel // nb if name.startswith("inst_") else sel % nb
                rows = by.clamp(0, x.shape[0] - 1).unique().numel()
                nbytes += rows * x[0].numel() * x.element_size()
    return nbytes


def timed_rays_calls(calls: list) -> dict:
    """Of a wave's recorded calls: the first sorted shadow cast's key, the
    first sort's key between bounces, the bounce-1 closest cast's
    reconstruction and the first sorted shadow cast's segments and
    merge."""
    named = lambda name, pred=lambda c: True: next(
        c for c in calls if c[0] == name and pred(c))
    bounce = lambda c: bool(c[2].get("bounce"))
    return {"shadow_key": named("shadow_key", lambda c: not bounce(c)),
            "shadow_key bounce": named("shadow_key", bounce),
            "shadow_segments": named(
                "shadow_segments", lambda c: c[1][4] is not None),
            "occlusion_merge": named(
                "occlusion_merge", lambda c: c[1][1] is not None),
            "hit_reconstruct": [c for c in calls
                                if c[0] == "hit_reconstruct"][1]}


def rays_library(name: str, a) -> dict:
    """The PyTorch calls timed beside a kernel as yardsticks (the port
    calls none of them): for occlusion_merge the scatter out[perm] = occ
    (one index_put) and argsort-then-gather, for shadow_segments one
    index_select of the cast's packed [N, 8] (o, d, tmin, tmax) rows."""
    if name == "occlusion_merge":
        flags, perm = a
        occ = functools.reduce(torch.bitwise_or, flags)
        out = torch.empty_like(occ)

        def put():
            out[perm] = occ
        return {"index_put": put,
                "argsort_gather": lambda: occ[torch.argsort(perm)]}
    if name == "shadow_segments":
        pack, p_from, p_to, mask, perm = a
        o, d, tmin, tmax = rays_ops.shadow_segments_plain(pack, p_from, p_to,
                                                          mask, None)
        packed = torch.cat([o, d, tmin[:, None], tmax[:, None]], 1)
        return {"index_select": lambda: torch.index_select(packed, 0, perm)}
    return {}


def time_rays(label: str, calls: list, smi: str, reps: int = 20) -> dict:
    """Each timed call (timed_rays_calls) at the wave's 2^20 lanes: the
    kernel by events, host enqueue and the profiler's device time (warm,
    and after an L2 flush each), the plain version by events, the library
    yardsticks (rays_library) by events and by the profiler's device time
    of all they launch, and the bound: its bytes (rays_bytes) at
    HBM_BW."""
    out = {}
    flush = None
    for case, (name, a, kw, got) in timed_rays_calls(calls).items():
        dev = got[0].device if not torch.is_tensor(got) else got.device
        if flush is None:
            flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.int32,
                                device=dev)
        wrapper = getattr(RAYS_MODULE[name], name)
        k = lambda: wrapper(*a, **kw)
        p = lambda: RAYS_PLAIN[name](*a, **without_out(kw))
        kernel = f"{name}_kernel"
        nbytes = rays_bytes(name, a, kw, got)
        b = bound(nbytes, 0)
        ms, _ = time_ms(k, reps)
        ev, host, host_max, _, _ = time_enqueue_ms(k, reps)
        (src, dev_ms), = profiled_ms(k, reps, (kernel,)).items()
        cold = lambda: (flush.fill_(0), k())
        (_, cold_ms), = profiled_ms(cold, reps, (kernel,)).items()
        plain_ms, _ = time_ms(p, 3)
        lib = {}
        for lname, fn in rays_library(name, a).items():
            # every device operation the call makes (its names are torch's)
            (_, lib_dev), = profiled_ms(fn, reps, ("",)).items()
            lib[lname] = {"ms": time_ms(fn, reps)[0], "device_ms": lib_dev}
        n = (a[2] if name in ("shadow_key", "hit_reconstruct")
             else a[1] if name == "shadow_segments" else a[0][0]).shape[0]
        out[case] = {"ms": ms, "enqueue_ms": host, "device_ms": dev_ms,
                     "device_cold_ms": cold_ms,
                     "device_source": src,
                     "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "bytes": nbytes, "lanes": n,
                     "library_ms": lib}
        print(f"{label} {case} ({n} lanes): kernel {ms:.4f} ms by events, "
              f"host enqueue {host:.4f} ms (largest {host_max:.4f}), device "
              f"{dev_ms:.4f} ms ({out[case]['device_source']}), "
              f"{cold_ms:.4f} ms after an L2 flush each; plain "
              f"{plain_ms:.3f} ms; bound {b[0]:.4f} ms by {b[1]} ({nbytes} "
              f"bytes), device time {dev_ms / b[0]:.2f}x it"
              + "".join(f"; library {k_} {v['ms']:.4f} ms by events, "
                        f"{v['device_ms']:.4f} ms device"
                        for k_, v in lib.items()) + f" [{smi}]", flush=True)
    return out


def edge_segments(scene, n: int, seed: int, dev):
    """n seeded segments in the scene's world sphere for shadow_key and
    shadow_segments, by lane k % 8: 0 plain, 1 masked off, 2 p_to equal to
    p_from, 3 a NaN p_to, 4 an inf p_to, 5 a -inf p_from, 6 a NaN p_from,
    7 from far outside the world. Returns (p_from, p_to, mask)."""
    g = np.random.default_rng(seed)
    c = scene.pack.world_center.cpu().numpy()
    r = float(scene.pack.world_radius)
    p_from = (c + g.uniform(-0.8, 0.8, (n, 3)) * r).astype(np.float32)
    p_to = (c + g.uniform(-0.8, 0.8, (n, 3)) * r).astype(np.float32)
    k = np.arange(n) % 8
    p_to[k == 2] = p_from[k == 2]
    p_to[k == 3, 1] = np.nan
    p_to[k == 4, 0] = np.inf
    p_from[k == 5, 2] = -np.inf
    p_from[k == 6, 0] = np.nan
    p_from[k == 7] = c + 4.0 * r
    f = lambda x: torch.as_tensor(x, device=dev).contiguous()
    return f(p_from), f(p_to), f(k != 1)


def edge_hits(meta, pack, n: int, seed: int, dev):
    """n lanes of seeded closest hits of every kind the scene has, for
    hit_reconstruct: per kind t in [0.5, 5) on about half the lanes, inf on
    the others, NaN on every 97th, equal t across kinds on every 13th (the
    tie rule), indices over the kind's rows and a few past either end (the
    clamp); rays from the world sphere, NaN directions on every 89th.
    Returns (o, d, hits, kinds)."""
    g = np.random.default_rng(seed)
    # the kinds in _kind_hits order, each with its count of indices
    rows = ([(scene_pack.KIND_TRI, meta.n_tri)] if meta.n_tri else []) + [
        (scene_pack.KIND_INST + mi, ni * meta.n_blas_tris[mi])
        for mi, ni in enumerate(meta.n_inst)] + [
        (k, m) for k, m in ((scene_pack.KIND_SPHERE, meta.n_sph),
                            (scene_pack.KIND_RECT, meta.n_rect),
                            (scene_pack.KIND_DISK, meta.n_disk)) if m]
    kinds = [k for k, _ in rows]
    lanes = np.arange(n)
    tie = g.uniform(0.5, 5.0, n)
    hits = []
    for k, m in rows:
        t = np.where(g.uniform(size=n) < 0.5, g.uniform(0.5, 5.0, n),
                     np.inf)
        t[lanes % 13 == 0] = tie[lanes % 13 == 0]
        t[lanes % 97 == 0] = np.nan
        index = g.integers(0, m, n)
        index[lanes % 211 == 0] = -3
        index[lanes % 223 == 0] = m + 5
        hits.append(isect_ops.KindHit(
            t=torch.as_tensor(t.astype(np.float32), device=dev),
            index=torch.as_tensor(index.astype(np.int32), device=dev),
            valid=torch.as_tensor(np.isfinite(t), device=dev)))
    c = pack.world_center.cpu().numpy()
    r = float(pack.world_radius)
    o = (c + g.uniform(-0.8, 0.8, (n, 3)) * r).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[lanes % 89 == 0] = np.nan
    f = lambda x: torch.as_tensor(x, device=dev).contiguous()
    return f(o), f(d), hits, kinds


# flags of the edge sets' largest merge: more than the 16 the kernel once
# took by value
MERGE_EDGE_FLAGS = 17


def rays_edges(scenes, dev, sizes=(1 << 16, (1 << 20) + 1)) -> dict:
    """Each wrapper against its plain version on edge sets, for each
    (label, scene) of scenes, at 65,536 and 2^20 + 1 lanes: occluded's
    key sorted and its segments sorted and not, on edge_segments (masked
    lanes, zero-length segments, NaN and inf endpoints; the Cornell box's
    key has no BVH root, the bunny's instances a scale of 500, the
    every-kind scene's of 0.8 and 0.3); the bounce key on the same points
    as origins and directions with a third of the lanes inactive; the
    merge of one, three and MERGE_EDGE_FLAGS seeded flags, sorted and not;
    hit_reconstruct on edge_hits (with many_families_scene, more kinds
    than the by-value tables the kernels once took). Returns {label:
    check_rays_calls' counts}."""
    out = {}
    for label, scene in scenes:
        meta, pack = scene.meta, scene.pack
        for n in sizes:
            calls = []
            with rays_calls(calls):
                p_from, p_to, mask = edge_segments(scene, n, 31, dev)
                key = rays_ops.shadow_key(meta, pack, p_from, p_to, mask)
                perm = torch.argsort(key, stable=True)
                for pm in (perm, None):
                    rays_ops.shadow_segments(pack, p_from, p_to, mask, pm)
                    rays_ops.shadow_segments(pack, p_from, p_to, None, pm)
                rays_ops.shadow_key(meta, pack, p_from, p_to)
                d = (p_to - p_from).contiguous()
                active = (torch.arange(n, device=dev) % 3) != 0
                rays_ops.shadow_key(meta, pack, p_from, d, active,
                                    bounce=True)
                g = torch.Generator(device=dev).manual_seed(32)
                flags = [torch.rand(n, generator=g, device=dev) < 0.2
                         for _ in range(MERGE_EDGE_FLAGS)]
                for j in (1, 3, MERGE_EDGE_FLAGS):
                    rays_ops.occlusion_merge(flags[:j], perm)
                    rays_ops.occlusion_merge(flags[:j], None)
                scene_pack.hit_reconstruct(meta, pack,
                                           *edge_hits(meta, pack, n, 33, dev))
            torch.cuda.synchronize()
            out[f"{label} {n}"] = check_rays_calls(
                f"{label} edge sets, {n} lanes", calls)
    return out


def rays_frames(cases, dev) -> None:
    """Each (label, scene, res, spp) frame, eager, on the kernels' route
    against the same frame with ops/rays.py's plain versions
    (plain_rays), image and stats bit for bit."""
    for label, scene, res, spp in cases:
        kw = dict(spp=spp, max_depth=VERTEX_DEPTH, seed=0, clamp=False,
                  device=dev, graph=False, with_stats=True)
        img, st = render(scene, res, res, **kw)
        with plain_rays():
            pimg, pst = render(scene, res, res, **kw)
        if not torch.equal(img, pimg) or st != pst:
            raise AssertionError(
                f"{label}: the frame through ops/rays.py's kernels differs "
                f"from the plain versions' (max |diff| "
                f"{float((img - pimg).abs().max())}, stats {st} vs {pst})")
        print(f"{label} {res}^2 {spp}-spp frame: ops/rays.py's kernels' "
              f"image and stats equal the plain versions' bit for bit "
              f"({st['rays']} rays)", flush=True)


def rays_phase(cases, dev, smi: str, time_case: str | None = None) -> dict:
    """For each (label, scene, res) of cases one eager 1-spp wave, its
    ops/rays.py calls recorded (rays_wave) and each held bit for bit
    against its plain version (check_rays_calls); on the case labelled
    time_case its calls timed (time_rays). Returns {label: counts} and,
    where timed, "times"."""
    out = {}
    for label, scene, res in cases:
        calls = rays_wave(label, scene, res, dev)
        out[label] = check_rays_calls(f"{label} {res}^2 wave", calls)
        if label == time_case:
            out["times"] = time_rays(label, calls, smi)
        del calls
    return out


# --------------------------------------------------------------------------
# 2f. the wave's glue (ops/wave.py)
# --------------------------------------------------------------------------

WAVE_REPLACES = {
    "camera_rays": "jet_pbrt_tpu/models/render.py:39 (the film position, "
                   "models/camera.py:56-70's generate_rays and li_path's "
                   "initial state, integrators.py:237-250, under "
                   "jax.jit(wave): XLA fusion, no Pallas kernel)",
    "permute_state": "jet_pbrt_tpu/models/integrators.py:272 (the state's "
                     "packed [N, 19] gather between bounces, :259-285, under "
                     "jax.jit(wave): XLA fusion, no Pallas kernel)",
    "unsort_guard": "jet_pbrt_tpu/models/integrators.py:291 (the un-sort "
                    "L[argsort(lane)] and the invalid-sample guard, "
                    ":288-292, under jax.jit(wave): XLA fusion, no Pallas "
                    "kernel)"}
WAVE_PLAIN = {"camera_rays": wave_ops.camera_rays_plain,
              "permute_state": wave_ops.permute_state_plain,
              "unsort_guard": wave_ops.unsort_guard_plain}


@contextlib.contextmanager
def wave_calls(out: list):
    """While open, each call of ops/wave.py's wrappers appends (name, args,
    keywords, output) to `out`; unsort_guard's L is recorded as a copy
    (without a sort it guards L in place). The launches count in
    ops/wave.py, which stays as it is."""
    saved = {name: getattr(wave_ops, name) for name in WAVE}
    for name, inner in saved.items():
        @functools.wraps(inner)
        def call(*a, _inner=inner, _name=name, **kw):
            rec = (a[0].clone(), *a[1:]) if _name == "unsort_guard" else a
            got = _inner(*a, **kw)
            out.append((_name, rec, kw, got))
            return got

        setattr(wave_ops, name, call)
    try:
        yield out
    finally:
        for name, inner in saved.items():
            setattr(wave_ops, name, inner)


@contextlib.contextmanager
def plain_wave():
    """While open, the plain versions stand in ops/wave.py's wrappers'
    places, so li_path's kernel route runs its camera, permutes and
    un-sort in torch ops (a measurement only)."""
    saved = {name: getattr(wave_ops, name) for name in WAVE}
    for name in WAVE:
        setattr(wave_ops, name, WAVE_PLAIN[name])
    try:
        yield
    finally:
        for name, inner in saved.items():
            setattr(wave_ops, name, inner)


@contextlib.contextmanager
def plain_glue():
    """While open, the wave's glue is the torch code it was before
    ops/wave.py: the camera's plain version, and on li_path's kernel route
    integrators._li_path_plain with the fused vertex (the torch fills,
    bounds, counts, stacks, gathers and un-sort between the kernels; the
    casts still write their slab rows). A measurement only."""
    kernels, camera = integrators._li_path_kernels, wave_ops.camera_rays

    def glue(meta, pack, u, max_depth, with_stats, sort_rays, state):
        return integrators._li_path_plain(
            meta, pack, state.ray_o, state.ray_d, u, max_depth, False, True,
            with_stats, sort_rays, True)

    integrators._li_path_kernels = glue
    wave_ops.camera_rays = wave_ops.camera_rays_plain
    try:
        yield
    finally:
        integrators._li_path_kernels, wave_ops.camera_rays = kernels, camera


def wave_state_rows(x) -> list:
    """A WaveState's rows, or (state, u), or a tensor, as [(name, tensor)]
    with the lanes first (the counters apart, as one row)."""
    if torch.is_tensor(x):
        return [("L", x)]
    if isinstance(x, wave_ops.WaveState):
        return [(f, getattr(x, f)) for f in wave_ops.WaveState._fields]
    state, u = x
    rows = wave_state_rows(state)
    if isinstance(u, rng.LaneKeys):
        return rows + [(f"u.{f}", getattr(u, f)) for f in u._fields]
    return rows + [("u", u)]


def check_wave_call(label: str, name: str, a, kw, got) -> tuple:
    """One recorded call against its plain version on the same inputs,
    every row bit for bit (NaN equal to NaN), the counters equal; a
    differing lane is printed with both values before the run fails.
    Returns (lanes, differing lanes, the largest |difference| on float
    rows finite in both)."""
    want = WAVE_PLAIN[name](*a, **kw)
    g, w = wave_state_rows(got), wave_state_rows(want)
    lanes, err = None, 0.0
    for (field, x), (_, y) in zip(g, w):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{label} {name} {field}: {x.dtype} "
                                 f"{tuple(x.shape)} vs {y.dtype} "
                                 f"{tuple(y.shape)}")
        if field == "counts":
            if not torch.equal(x, y):
                raise AssertionError(f"{label} {name}: counters {x.tolist()}"
                                     f", plain {y.tolist()}")
            continue
        if x.dtype == torch.int64:
            diff = (x != y).reshape(x.shape[0], -1).any(dim=1)
        else:
            diff = differing_lanes(x, y, 0)
        lanes = diff if lanes is None else lanes | diff
        if x.is_floating_point():
            fin = torch.isfinite(x) & torch.isfinite(y)
            if fin.any():
                err = max(err, float((x[fin] - y[fin]).abs().max()))
    bad = int(lanes.sum())
    for i in lanes.nonzero().flatten()[:4].tolist():
        print(f"{label} {name} lane {i}: kernel "
              f"{[(f, x[i].tolist()) for f, x in g if f != 'counts']}, plain "
              f"{[(f, x[i].tolist()) for f, x in w if f != 'counts']}",
              flush=True)
    return lanes.shape[0], bad, err


def check_wave_calls(label: str, calls: list) -> dict:
    """Each recorded call held against its plain version (check_wave_call);
    prints the calls by wrapper and fails on any differing lane. Returns
    {"calls", "lanes", "differing", "max_abs_err"}."""
    out = {"calls": collections.Counter(), "lanes": 0, "differing": 0,
           "max_abs_err": 0.0}
    for name, a, kw, got in calls:
        n, bad, err = check_wave_call(label, name, a, kw, got)
        out["calls"][name] += 1
        out["lanes"] += n
        out["differing"] += bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
    out["calls"] = dict(out["calls"])
    print(f"{label}: ops/wave.py calls {out['calls']}, {out['lanes']} lanes, "
          f"{out['differing']} lanes differ from the plain versions",
          flush=True)
    if out["differing"]:
        raise AssertionError(f"{label}: ops/wave.py's kernels differ from "
                             f"their plain versions on {out['differing']} "
                             "lanes")
    return out


def wave_glue_calls(label: str, scene, res: int, dev, **kw) -> list:
    """One eager 1-spp wave of scene at res^2, depth VERTEX_DEPTH, its
    ops/wave.py calls recorded: as many of each as wave_launches counts."""
    calls = []
    with torch.no_grad(), wave_calls(calls):
        render(scene, res, res, spp=1, max_depth=VERTEX_DEPTH, seed=1,
               clamp=False, device=dev, graph=False, **kw)
    got = collections.Counter(name for name, *_ in calls)
    want = wave_launches(scene.meta, n_waves(res, res, 1, DEFAULT_CHUNK),
                         VERTEX_DEPTH)
    if dict(got) != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: one wave made the calls {dict(got)},"
                             f" expected {want}")
    return calls


def wave_bytes(name: str, a, kw, got) -> int:
    """Bytes one call must move: each input read once, each output written
    once (the camera's rows and ray_eps whole; the permute's perm, every
    state row and the streams in and out; the un-sort's L and lane in, L
    out)."""
    nb = lambda xs: sum(x.numel() * x.element_size() for _, x in xs)
    if name == "camera_rays":
        cam, pixel, _, jitter, eps = a
        return (nb([(0, pixel), (0, jitter), (0, eps)])
                + nb([(0, getattr(cam, f)) for f in cam._fields])
                + nb(wave_state_rows(got)))
    if name == "permute_state":
        state, u, perm = a
        rows = [r for r in wave_state_rows((state, u)) if r[0] != "counts"]
        return nb([(0, perm)]) + 2 * nb(rows)
    L, lane = a[0], (a[1] if len(a) > 1 else kw.get("lane"))
    return 2 * nb([(0, L)]) + (0 if lane is None else nb([(0, lane)]))


def wave_library(name: str, a) -> dict:
    """The PyTorch calls timed beside a kernel as yardsticks (the port
    calls none of them): for permute_state its plain version's eleven
    x[perm] gathers and one index_select of the state packed as [N, 16]
    int32 words (L, beta, o, d, pdf, tmin, tmax as their bits, the flags,
    lane and key words widened); for unsort_guard the scatter out[lane] =
    L (one index_put_) and L[argsort(lane)]."""
    if name == "permute_state":
        state, u, perm = a
        i32 = lambda x: x.reshape(x.shape[0], -1).view(torch.int32) \
            if x.dtype == torch.float32 else x.reshape(x.shape[0], -1).to(
                torch.int32)
        packed = torch.cat([i32(x) for _, x in wave_state_rows((state, u))
                            if _ != "counts"], dim=1)
        return {"gathers": lambda: wave_ops.permute_state_plain(state, u,
                                                                perm),
                "index_select": lambda: torch.index_select(packed, 0, perm)}
    if name == "unsort_guard":
        L, lane = a[0], a[1]
        out = torch.empty_like(L)

        def put():
            out[lane] = L
        return {"index_put": put,
                "argsort_gather": lambda: L[torch.argsort(lane)]}
    return {}


def timed_wave_calls(calls: list) -> dict:
    """Of a wave's recorded calls: the camera, the first permute and the
    un-sort."""
    return {name: next(c for c in calls if c[0] == name) for name in WAVE}


def time_wave(label: str, calls: list, smi: str, reps: int = 20) -> dict:
    """Each timed call (timed_wave_calls) at the wave's 2^20 lanes: the
    kernel by events, host enqueue and the profiler's device time (warm,
    and after an L2 flush each), the plain version by events, the library
    yardsticks (wave_library) by events and by the profiler's device time
    of all they launch, and the bound: its bytes (wave_bytes) at
    HBM_BW."""
    out = {}
    flush = None
    for case, (name, a, kw, got) in timed_wave_calls(calls).items():
        lanes = a[1].shape[0] if name == "camera_rays" else a[-1].shape[0] \
            if name == "permute_state" else a[0].shape[0]
        dev = a[1].device if name == "camera_rays" else a[0].L.device \
            if name == "permute_state" else a[0].device
        if flush is None:
            flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.int32,
                                device=dev)
        wrapper = getattr(wave_ops, name)
        if name == "unsort_guard" and a[1] is None:
            a = (a[0].clone(), None)    # in place: time it on a copy
        k = lambda: wrapper(*a, **kw)
        p = lambda: WAVE_PLAIN[name](*a, **kw)
        kernel = f"{name}_kernel"
        nbytes = wave_bytes(name, a, kw, got)
        b = bound(nbytes, 0)
        ms, _ = time_ms(k, reps)
        ev, host, host_max, _, _ = time_enqueue_ms(k, reps)
        (src, dev_ms), = profiled_ms(k, reps, (kernel,)).items()
        cold = lambda: (flush.fill_(0), k())
        (_, cold_ms), = profiled_ms(cold, reps, (kernel,)).items()
        plain_ms, _ = time_ms(p, 3)
        lib = {}
        for lname, fn in wave_library(name, a).items():
            (_, lib_dev), = profiled_ms(fn, reps, ("",)).items()
            lib[lname] = {"ms": time_ms(fn, reps)[0], "device_ms": lib_dev}
        out[case] = {"ms": ms, "enqueue_ms": host, "device_ms": dev_ms,
                     "device_cold_ms": cold_ms,
                     "device_source": src,
                     "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "bytes": nbytes, "lanes": lanes,
                     "library_ms": lib}
        print(f"{label} {case} ({lanes} lanes): kernel {ms:.4f} ms by "
              f"events, host enqueue {host:.4f} ms (largest {host_max:.4f}),"
              f" device {dev_ms:.4f} ms ({out[case]['device_source']}), "
              f"{cold_ms:.4f} ms after an L2 flush each; plain "
              f"{plain_ms:.3f} ms; bound {b[0]:.4f} ms by {b[1]} ({nbytes} "
              f"bytes), device time {dev_ms / b[0]:.2f}x it"
              + "".join(f"; library {k_} {v['ms']:.4f} ms by events, "
                        f"{v['device_ms']:.4f} ms device"
                        for k_, v in lib.items()) + f" [{smi}]", flush=True)
    return out


def wave_edge_state(n: int, seed: int, dev, keys: bool, depth: int = 5,
                    s: int = 8):
    """A seeded WaveState of n lanes and its streams for the permute and the
    un-sort: NaN, +inf and -inf in L on every 7th, 11th and 13th lane,
    dead lanes (inactive, tmin inf, tmax -1) on a third, -0.0 on every
    17th; u LaneKeys (keys) or the debug sampler's [n, depth + 1, s]
    uniforms."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *sh: torch.randn(sh, generator=g, device=dev)
    lanes = torch.arange(n, device=dev)
    L = f(n, 3)
    L[lanes % 7 == 0, 0] = float("nan")
    L[lanes % 11 == 3, 1] = float("inf")
    L[lanes % 13 == 5, 2] = -float("inf")
    L[lanes % 17 == 1] = -0.0
    active = (lanes % 3) != 0
    inf = torch.full((n,), float("inf"), device=dev)
    state = wave_ops.WaveState(
        L=L, beta=f(n, 3), active=active,
        prev_specular=torch.rand(n, generator=g, device=dev) < 0.3,
        prev_pdf=f(n), ray_o=f(n, 3), ray_d=f(n, 3),
        lane=torch.randperm(n, generator=g, device=dev),
        tmin=torch.where(active, torch.rand(n, generator=g, device=dev), inf),
        tmax=torch.where(active, inf, -torch.ones(n, device=dev)),
        counts=torch.arange(4, device=dev, dtype=torch.int64))
    if keys:
        u = rng.lane_keys(seed, torch.randint(0, 9, (n,), generator=g,
                                              device=dev), lanes)
    else:
        u = torch.rand((n, depth + 1, s), generator=g, device=dev)
    return state, u



def wave_edges(scene, dev, sizes=(1, 1000, (1 << 20) + 1)) -> dict:
    """Each wrapper against its plain version on edge sets, for each of
    sizes lanes (one lane, a count short of a block, one past 2^20): the
    camera on pixel ids from 0 and from past 2^24 (their float32 cast
    rounds) on a film of odd width, with the random, stratified and debug
    samplers' jitter; the permute of a wave_edge_state with its LaneKeys
    and with the debug sampler's uniforms, by the identity, the reversal
    and a seeded perm; the un-sort of its L with NaN and inf lanes by
    those perms as lanes, and without a sort (in place). Returns {label:
    check_wave_calls' counts}."""
    out = {}
    width = 1021
    cam = camera_mod.make_camera(scene.camera.lookfrom, scene.camera.front,
                                 scene.camera.vup, scene.camera.vfov,
                                 (width, 977), device=dev)
    for n in sizes:
        calls = []
        with wave_calls(calls):
            for first in (0, (1 << 24) + 3):
                pixel = torch.arange(first, first + n, device=dev)
                keys = rng.lane_keys(5, 2, pixel)
                for sampler in ("random", "stratified", "debug"):
                    jit = rng.camera_jitter(keys, sampler=sampler, spp=6)
                    wave_ops.camera_rays(cam, pixel, width, jit,
                                         scene.pack.ray_eps)
            g = torch.Generator(device=dev).manual_seed(n)
            perms = (torch.arange(n, device=dev),
                     torch.arange(n - 1, -1, -1, device=dev),
                     torch.randperm(n, generator=g, device=dev))
            for keys in (True, False):
                state, u = wave_edge_state(n, 40 + n, dev, keys)
                for perm in perms:
                    wave_ops.permute_state(state, u, perm)
            for perm in (None, *perms):
                wave_ops.unsort_guard(state.L.clone(), perm)
        torch.cuda.synchronize()
        out[f"edges {n}"] = check_wave_calls(f"edge sets, {n} lanes", calls)
    return out


def wave_frames(cases, dev) -> None:
    """Each (label, scene, res, spp, keywords) frame, eager, on the glue
    kernels' route against the same frame with ops/wave.py's plain
    versions (plain_wave) and with the glue as it was before them
    (plain_glue), image and stats bit for bit."""
    for label, scene, res, spp, extra in cases:
        kw = dict(spp=spp, max_depth=VERTEX_DEPTH, seed=0, clamp=False,
                  device=dev, graph=False, with_stats=True, **extra)
        img, st = render(scene, res, res, **kw)
        for route, ctx in (("plain versions", plain_wave),
                           ("plain glue", plain_glue)):
            with ctx():
                pimg, pst = render(scene, res, res, **kw)
            if not torch.equal(img, pimg) or st != pst:
                raise AssertionError(
                    f"{label}: the frame through ops/wave.py's kernels "
                    f"differs from the {route}' (max |diff| "
                    f"{float((img - pimg).abs().max())}, stats {st} vs "
                    f"{pst})")
        print(f"{label} {res}^2 {spp}-spp frame {extra}: ops/wave.py's "
              f"kernels' image and stats equal the plain versions' and the "
              f"plain glue's bit for bit ({st['rays']} rays)", flush=True)


def wave_phase(cases, dev, smi: str, time_case: str | None = None) -> dict:
    """For each (label, scene, res) of cases one eager 1-spp wave, its
    ops/wave.py calls recorded (wave_glue_calls) and each held bit for bit
    against its plain version (check_wave_calls); on the case labelled
    time_case its calls timed (time_wave). Returns {label: counts} and,
    where timed, "times"."""
    out = {}
    for label, scene, res in cases:
        calls = wave_glue_calls(label, scene, res, dev)
        out[label] = check_wave_calls(f"{label} {res}^2 wave", calls)
        if label == time_case:
            out["times"] = time_wave(label, calls, smi)
        del calls
    return out


# --------------------------------------------------------------------------
# 2g. the gradient's kernels
# --------------------------------------------------------------------------

# ops/shade.py's and ops/wave.py's backward wrappers, each counting its
# csrc/shade_grad.cu or csrc/wave.cu kernel's launches
GRAD_SHADE = ("vertex_backward", "grad_reduce")
GRAD_WAVE = ("permute_state_backward", "unsort_guard_backward")
GRAD = GRAD_SHADE + GRAD_WAVE
GRAD_SOURCE = {"vertex_backward": "jet_pbrt_tpu_torch/csrc/shade_grad.cu",
               "grad_reduce": "jet_pbrt_tpu_torch/csrc/shade_grad.cu",
               "permute_state_backward": "jet_pbrt_tpu_torch/csrc/wave.cu",
               "unsort_guard_backward": "jet_pbrt_tpu_torch/csrc/wave.cu"}
GRAD_REPLACES = {
    "vertex_backward": "jet_pbrt_tpu/models/integrators.py:108 (the "
                       "transpose of li_path's vertex, :108-237, under "
                       "jax.jit(jax.value_and_grad(loss)), "
                       "diff/params.py:55: XLA fusion, no custom_vjp and no "
                       "Pallas kernel)",
    "grad_reduce": "jet_pbrt_tpu/models/integrators.py:108 (the parameter "
                   "gradients' sum over the lanes in that transpose: XLA's "
                   "reduction, no Pallas kernel)",
    "permute_state_backward": "jet_pbrt_tpu/models/integrators.py:272 (the "
                              "transpose of the state's gather between "
                              "bounces under jax.value_and_grad: XLA, no "
                              "Pallas kernel)",
    "unsort_guard_backward": "jet_pbrt_tpu/models/integrators.py:291 (the "
                             "transpose of the un-sort and the guard under "
                             "jax.value_and_grad: XLA, no Pallas kernel)"}
# the backward against its plain version (autograd through the plain
# vertex): a lane's d loss / d beta within GRAD_LANE_RTOL of the plain one,
# or no farther from a float64 recomputation of the lane than the plain
# one is (the two sum the same terms in other orders, and take f's
# derivatives by other float operations than autograd's); each field's
# gradient within GRAD_FIELD_TOL of that field's largest |gradient|
GRAD_LANE_RTOL = 1e-5
GRAD_FIELD_TOL = 1e-4
# the fields the phase's waves differentiate
GRAD_WAVE_FIELDS = ("mat_c0", "mat_c1", "mat_s0", "mat_s1", "light_c")


def grad_launches(meta, waves: int, depth: int) -> dict:
    """The backward kernels' launches in the backward of `waves`
    differentiated waves on the kernel route at max_depth `depth`: per
    wave one vertex_backward per tangent set (shade.backward_sets) at
    each vertex below depth and one on the last, one grad_reduce per
    vertex (depth + 1), one permute_state_backward per sort between
    bounces (bounces 0 to 2 below depth, in a kernel-routed scene) and one
    unsort_guard_backward (the forward's launches are
    expected_launches')."""
    sorts = min(3, depth) if meta.kernel_routed else 0
    sets = len(shade_ops.backward_sets(meta))
    return {"vertex_backward": waves * (depth * sets + 1),
            "grad_reduce": waves * (depth + 1),
            "permute_state_backward": waves * sorts,
            "unsort_guard_backward": waves}


def detached_pack(pack):
    return pack._replace(**{f: getattr(pack, f).detach()
                            for f in shade_ops.GRAD_FIELDS})


@contextlib.contextmanager
def grad_calls(out: list):
    """While open, each shade_ops.vertex call appends ("vertex", (meta,
    pack, hit, state, u_vertex, bounce, max_depth, lights, occ)), each
    wave_ops.permute ("permute", perm) and each wave_ops.unsort ("unsort",
    (L, lane)), every tensor off the tape."""
    vertex, permute, unsort = shade_ops.vertex, wave_ops.permute, \
        wave_ops.unsort

    def rec_vertex(meta, pack, hit, state, u_vertex, bounce, max_depth, *,
                   lights=None, counts=None, occlude=None):
        v, occ = vertex(meta, pack, hit, state, u_vertex, bounce, max_depth,
                        lights=lights, counts=counts, occlude=occlude)
        out.append(("vertex", (
            meta, detached_pack(pack), hit,
            shade_ops.VertexState(*(x.detach() for x in state)), u_vertex,
            bounce, max_depth,
            lights if lights is None
            else lights._replace(le_env=lights.le_env.detach()), occ)))
        return v, occ

    def rec_permute(state, u, perm):
        out.append(("permute", perm))
        return permute(state, u, perm)

    def rec_unsort(L, lane=None):
        out.append(("unsort", (L.detach(), lane)))
        return unsort(L, lane)

    shade_ops.vertex, wave_ops.permute, wave_ops.unsort = \
        rec_vertex, rec_permute, rec_unsort
    try:
        yield out
    finally:
        shade_ops.vertex, wave_ops.permute, wave_ops.unsort = \
            vertex, permute, unsort


def grad_wave_calls(label: str, scene, res: int, dev) -> list:
    """The forward of one differentiated 1-spp wave (render_fn at res^2,
    depth VERTEX_DEPTH, GRAD_WAVE_FIELDS of the pack on the tape, and
    tex_image, tex_c0 and tex_c1 where the scene has textures), its
    vertex, permute and un-sort calls recorded: as many as grad_launches
    counts their backwards (a vertex call's one grad_reduce)."""
    fields = GRAD_WAVE_FIELDS + (("tex_image", "tex_c0", "tex_c1")
                                 if scene.meta.n_tex else ())
    fn, pack = render_fn(scene, res, res, 1, seed=1, max_depth=VERTEX_DEPTH,
                         device=dev)
    leaves = {f: getattr(pack, f).detach().clone().requires_grad_(True)
              for f in fields}
    calls = []
    with grad_calls(calls):
        img = fn(dparams.with_params(pack, leaves))
    del img
    got = collections.Counter(name for name, _ in calls)
    want = grad_launches(scene.meta, n_waves(res, res, 1, DEFAULT_CHUNK),
                         VERTEX_DEPTH)
    if got != collections.Counter({"vertex": want["grad_reduce"],
                                   "permute": want["permute_state_backward"],
                                   "unsort": want["unsort_guard_backward"]}):
        raise AssertionError(f"{label}: one differentiated wave made the "
                             f"calls {dict(got)}, expected {want}")
    return calls


def kernel_state(state):
    """The rows of a vertex's state its backward kernel reads (on the CPU,
    where the plain backward stands in for it, all of them)."""
    if state.L.device.type == "cpu":
        return state
    return state._replace(L=None, prev_pdf=None, ray_o=None, ray_d=None)


def seeded_grads(n: int, seed: int, dev, last: bool):
    """d loss / d L and d loss / d beta [n,3] for a vertex's backward,
    seeded (gbeta None on the last bounce, whose beta is no output)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gL = torch.randn((n, 3), generator=g, device=dev)
    gbeta = None if last else torch.randn((n, 3), generator=g, device=dev)
    return gL, gbeta


def lanes_of(rec, idx):
    """A recorded vertex call with its per-lane inputs taken at lanes idx."""
    meta, pack, hit, state, u, bounce, depth, lights, occ = rec
    take = lambda x: None if x is None else x[idx].contiguous()
    return (meta, pack, type(hit)(*(take(x) for x in hit)),
            shade_ops.VertexState(*(take(x) for x in state)), take(u), bounce,
            depth, lights, None if occ is None else occ[:, idx].contiguous())


def f64_lanes(rec, idx, gL, gbeta):
    """The plain backward's d loss / d beta of the lanes idx recomputed in
    float64 (every float input of those lanes and the pack's float tables
    widened; the sums then round far below float32's steps), and the same
    for |gL| and |gbeta|: every term of d loss / d beta is an upstream
    gradient times factors that are not negative (f, Li, |cos| / pdf, the
    roulette's scale, le), so that is the sum of the terms' magnitudes,
    which bounds a float32 sum's rounding in any order."""
    meta, pack, hit, state, u, bounce, depth, lights, occ = lanes_of(rec, idx)
    wide = lambda x: x.double() if x is not None and x.is_floating_point() \
        else x
    pack64 = pack._replace(**{f: wide(x) for f, x in zip(pack._fields, pack)
                              if torch.is_tensor(x)})
    run = lambda gl, gb: shade_ops.vertex_backward_plain(
        meta, pack64, type(hit)(*(wide(x) for x in hit)),
        shade_ops.VertexState(*(wide(x) for x in state)), wide(u), bounce,
        depth, occ, gl, gb,
        None if lights is None else lights.le_env.double())[1]
    gl, gb = gL[idx].double(), None if gbeta is None else gbeta[idx].double()
    return run(gl, gb), run(gl.abs(), None if gb is None else gb.abs())


def defined_plain(rec, gL, gbeta, idx, meta=None):
    """The plain backward's field gradients over the lanes idx where it is
    a number: where a lane's are NaN the lanes are halved until the NaN
    ones stand alone. Returns ({field: gradient} summed over the lanes
    kept, the lanes left out)."""
    sub = lanes_of(rec, idx)
    _, _, g, _ = shade_ops.vertex_backward_plain(
        meta or sub[0], *sub[1:7], sub[8], gL[idx],
        None if gbeta is None else gbeta[idx],
        None if rec[7] is None else rec[7].le_env)
    if not any(bool(torch.isnan(v).any()) for v in g.values()):
        return g, idx[:0]
    if idx.numel() == 1:
        return {f: torch.zeros_like(v) for f, v in g.items()}, idx
    half = idx.numel() // 2
    (a, na), (b, nb) = (defined_plain(rec, gL, gbeta, part, meta)
                        for part in (idx[:half], idx[half:]))
    return {f: a[f] + b[f] for f in a}, torch.cat([na, nb])


def own_branch_plain(rec, gL, gbeta):
    """The plain backward's field gradients with each lane computing only
    its own lobe, as the kernel does, over the live lanes where it is a
    number: the live lanes grouped by their lobe kind and microfacet
    distribution, each group's plain backward run on its lanes alone with
    the scene's present lobes and distributions cut to its own
    (defined_plain), summed over the groups. Returns (the fields, the live
    lanes kept, the lanes left out). Where the whole wave's plain
    backward computes every present lobe on every lane, where()'s zero
    gradient times an infinite slope of a lobe a lane does not take gives
    NaN (the every-kind scene's glass eta and metal roughness); within a
    lane's own lobe, reverse mode's zero gradient into a sqrt of 0 whose
    every use is masked (a direction along the normal, _trig's sin_theta)
    gives 0 / 0: those lanes are left out, and the kernel's forward-mode
    tangents, which a masked use does not reach, are held finite there."""
    meta, pack, hit, state, u, bounce, depth, lights, occ = rec
    mat_kind, c0, c1, s0, s1, remap, tex, mf_kind = \
        scene_pack.gather_material(pack, hit.mat_id)
    c0 = scene_pack.effective_kd(meta, pack, hit, c0, tex)
    lobe = bsdf_ops.make_lobe(mat_kind, c0, c1, s0, s1, remap,
                              rng.stream_lobe(u), mf_kind=mf_kind)
    live = state.active & hit.valid
    key = lobe.kind.long() * 2 + lobe.mf_kind.long()
    total = {f: torch.zeros_like(getattr(pack, f))
             for f in shade_ops.GRAD_FIELDS}
    kept, out = [], []
    for k in key[live].unique().tolist():
        idx = (live & (key == k)).nonzero().flatten()
        m = dataclasses.replace(meta, present_lobes=(k // 2,),
                                present_mf_kinds=(k % 2,))
        g, nan = defined_plain(rec, gL, gbeta, idx, m)
        for f in total:
            total[f] = total[f] + g[f]
        kept.append(idx[~torch.isin(idx, nan)])
        out.append(nan)
    return total, torch.cat(kept), torch.cat(out)


def check_vertex_grad(label: str, rec, seed: int) -> dict:
    """One recorded vertex's backward on the kernels (shade.vertex_grads:
    vertex_backward, grad_reduce) against its plain version
    (vertex_backward_plain, autograd through the plain vertex) for seeded
    upstream gradients: d loss / d L equal bit for bit (it passes through);
    d loss / d beta per lane within GRAD_LANE_RTOL, a lane further off
    explained by the float64 recomputation of the lane: kernel and plain
    sum the same float32 terms in other orders, so each lies within (J +
    6) unit roundoffs of the terms' magnitudes (J NEE lights; the
    recomputation with |gL| and |gbeta| gives those magnitudes' sum) of
    the exact sum, and the two within twice that of each other; the
    explained lanes printed with the float64 value; each field's
    gradient and the environment radiance's within GRAD_FIELD_TOL of its
    largest |gradient|; where the whole wave's plain backward is NaN, the
    fields are held over the live lanes where own_branch_plain's is a
    number, kernel against it, the lanes left out printed with the
    kernel's finite gradient there. Returns the
    lanes, the lanes outside rtol, the largest field error relative to its
    scale, the largest |difference| of d loss / d beta and the fields held
    against the lanes' own lobes."""
    meta, pack, hit, state, u, bounce, depth, lights, occ = rec
    n = state.L.shape[0]
    gL, gbeta = seeded_grads(n, seed, state.L.device, bounce >= depth)
    slim = kernel_state(state)
    gl, gb, gk, ge = shade_ops.vertex_grads(
        meta, pack, hit, slim, u, bounce, depth, lights, occ, gL, gbeta)
    pl, pb, gp, pe = shade_ops.vertex_backward_plain(
        meta, pack, hit, state, u, bounce, depth, occ, gL, gbeta,
        None if lights is None else lights.le_env)
    torch.cuda.synchronize()
    if not torch.equal(gl, pl):
        raise AssertionError(f"{label} bounce {bounce}: d loss / d L differs "
                             "from the plain backward's")
    both_nan = torch.isnan(gb) & torch.isnan(pb)
    off = ~(((gb - pb).abs() <= GRAD_LANE_RTOL * pb.abs()) | both_nan)
    lanes = off.any(dim=1).nonzero().flatten()
    explained = 0
    if lanes.numel():
        g64, mag = f64_lanes(rec, lanes, gL, gbeta)
        k, p = gb[lanes].double(), pb[lanes].double()
        terms = (0 if occ is None else occ.shape[0]) + 6
        # both sum the same float32 terms, each within terms * U32 * mag of
        # their exact sum: together twice that apart
        ok = ((k - p).abs() <= 2 * terms * U32 * mag).all(dim=1)
        shown = list(range(min(4, lanes.numel()))) + [
            j for j in (~ok).nonzero().flatten()[:4].tolist() if j >= 4]
        for j in shown:
            print(f"{label} bounce {bounce} lane {int(lanes[j])}: d loss / d "
                  f"beta kernel {k[j].tolist()}, plain {p[j].tolist()}, "
                  f"float64 {g64[j].tolist()}, their bound apart "
                  f"{(2 * terms * U32 * mag[j]).tolist()} "
                  f"({'explained' if ok[j] else 'NOT explained'})",
                  flush=True)
        if not bool(ok.all()):
            raise AssertionError(f"{label} bounce {bounce}: "
                                 f"{int((~ok).sum())} lanes of d loss / d "
                                 "beta differ from the plain backward beyond "
                                 "the float64 recomputation")
        explained = lanes.numel()
    worst, nan_fields = 0.0, []
    if any(bool(torch.isnan(gp[f]).any()) for f in shade_ops.GRAD_FIELDS):
        # the plain backward is NaN somewhere: the fields are held over the
        # live lanes where each lane's own lobe's plain backward is a number
        own, kept, dropped = own_branch_plain(rec, gL, gbeta)
        nan_fields = [f for f in shade_ops.GRAD_FIELDS
                      if bool(torch.isnan(gp[f]).any())]
        sub = lanes_of(rec, kept)
        _, _, gk, _ = shade_ops.vertex_grads(
            *sub[:3], kernel_state(sub[3]), *sub[4:7], lights, sub[8],
            gL[kept], None if gbeta is None else gbeta[kept])
        gp, pe = own, None
        shown = {}
        if dropped.numel():
            sub = lanes_of(rec, dropped)
            _, _, gd, _ = shade_ops.vertex_grads(
                *sub[:3], kernel_state(sub[3]), *sub[4:7], lights, sub[8],
                gL[dropped], None if gbeta is None else gbeta[dropped])
            if not all(bool(torch.isfinite(v).all()) for v in gd.values()):
                raise AssertionError(f"{label} bounce {bounce}: the kernel's "
                                     "gradient is not finite on the lanes "
                                     "the plain backward makes NaN")
            shown = {f: gd[f].flatten()[:8].tolist() for f in nan_fields}
        print(f"{label} bounce {bounce}: the plain backward's "
              f"{nan_fields} are NaN; held on the {kept.numel()} live lanes "
              f"where each lane's own lobe's plain backward is a number; "
              f"{dropped.numel()} lanes left out "
              f"{dropped[:8].tolist()}, where the kernel's is finite: "
              f"{shown}", flush=True)
    for f in (*shade_ops.GRAD_FIELDS, "le_env"):
        if f == "le_env" and pe is None:
            continue
        a, b = (ge, pe) if f == "le_env" else (gk[f], gp[f])
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        if not (err <= GRAD_FIELD_TOL * scale or err == 0.0) \
                or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} bounce {bounce}: d loss / d {f} "
                                 f"differs from the plain backward's by "
                                 f"{err} (largest |gradient| {scale}): "
                                 f"kernel {a.flatten()[:12].tolist()}, plain "
                                 f"{b.flatten()[:12].tolist()}")
        worst = max(worst, err / scale if scale else 0.0)
    fin = torch.isfinite(gb) & torch.isfinite(pb)
    return {"lanes": n, "explained": explained, "field_rel": worst,
            "max_abs_err": float((gb - pb)[fin].abs().max())
            if fin.any() else 0.0, "nan_fields": nan_fields}


def check_glue_grad(label: str, name: str, args, seed: int) -> int:
    """One recorded permute (args: perm) or un-sort (args: (L, lane)):
    its backward kernel against the plain version for seeded upstream
    gradients, bit for bit (NaN equal to NaN). Returns the lanes."""
    if name == "permute":
        perm = args
        n = perm.shape[0]
        g = torch.Generator(device=perm.device).manual_seed(seed)
        gL, gbeta = (torch.randn((n, 3), generator=g, device=perm.device)
                     for _ in range(2))
        got = wave_ops.permute_state_backward(perm, gL, gbeta)
        want = wave_ops.permute_state_backward_plain(perm, gL, gbeta)
    else:
        L, lane = args
        n = L.shape[0]
        g = torch.Generator(device=L.device).manual_seed(seed)
        gL = torch.randn((n, 3), generator=g, device=L.device)
        got = (wave_ops.unsort_guard_backward(L, lane, gL),)
        want = (wave_ops.unsort_guard_backward_plain(L, lane, gL),)
    for x, y in zip(got, want):
        bad = int(differing_lanes(x, y, 0).sum())
        if bad:
            raise AssertionError(f"{label} {name} backward: {bad} lanes "
                                 "differ from the plain version")
    return n


def check_reduce(label: str, rec, seed: int) -> None:
    """The recorded vertex's partial sums (vertex_backward) summed by
    grad_reduce and by its plain version, bit for bit."""
    meta, pack, hit, state, u, bounce, depth, lights, occ = rec
    if state.L.device.type != "cuda":
        return      # a rehearsal on the CPU: there is no kernel
    gL, gbeta = seeded_grads(state.L.shape[0], seed, state.L.device,
                             bounce >= depth)
    slim = kernel_state(state)
    _, partials, _, _ = shade_ops.vertex_backward(
        meta, pack, hit, slim, u, bounce, depth, lights, occ, gL, gbeta)
    got = shade_ops.grad_reduce(partials)
    if not torch.equal(got, shade_ops.grad_reduce_plain(partials)):
        raise AssertionError(f"{label}: grad_reduce differs from its plain "
                             "version")


def check_grad_calls(label: str, calls: list) -> dict:
    """Each recorded call's backward held against its plain version
    (check_vertex_grad, check_glue_grad; the first vertex's reduction also
    against grad_reduce_plain). Returns the counts and errors."""
    out = {"calls": collections.Counter(), "lanes": 0, "explained": 0,
           "field_rel": 0.0, "max_abs_err": 0.0, "nan_fields": []}
    for i, (name, args) in enumerate(calls):
        if name == "vertex":
            got = check_vertex_grad(label, args, 100 + i)
            out["lanes"] += got["lanes"]
            out["explained"] += got["explained"]
            out["field_rel"] = max(out["field_rel"], got["field_rel"])
            out["max_abs_err"] = max(out["max_abs_err"], got["max_abs_err"])
            out["nan_fields"] += [f"bounce {args[5]} {f}"
                                  for f in got["nan_fields"]]
            if out["calls"]["vertex"] == 0:
                check_reduce(label, args, 100 + i)
        else:
            out["lanes"] += check_glue_grad(label, name, args, 100 + i)
        out["calls"][name] += 1
    out["calls"] = dict(out["calls"])
    print(f"{label}: backward calls {out['calls']}, {out['lanes']} lanes, "
          f"d loss / d beta outside rtol {GRAD_LANE_RTOL} on "
          f"{out['explained']} lanes, each explained by float64; fields "
          f"within {out['field_rel']:.2e} of their largest |gradient| "
          f"(gate {GRAD_FIELD_TOL})", flush=True)
    return out


def grad_bytes(name: str, args) -> int:
    """Bytes one backward call must move: each input read once, each
    output written once (vertex_backward: the hit, beta, active,
    prev_specular, uniforms, shadow flags, gL and gbeta in, gbeta and its
    blocks' partial sums out; grad_reduce: the partials in, the vector out;
    the permute's perm and two gradients in, two out; the un-sort's L,
    lane and gradient in, one out)."""
    nb = lambda *xs: sum(x.numel() * x.element_size() for x in xs
                         if x is not None)
    if name == "vertex_backward":
        rec, gL, gbeta, partials = args
        meta, pack, hit, state, u, bounce, depth, lights, occ = rec
        return (nb(hit.valid, hit.position, hit.normal, hit.wo, hit.mat_id,
                   hit.light_id, state.beta, state.active,
                   state.prev_specular, u, occ, gL, gbeta, gL, partials)
                + (nb(hit.uv) if meta.n_tex else 0))
    if name == "grad_reduce":
        (partials,) = args
        return nb(partials) + partials.shape[1] * 4
    if name == "permute_state_backward":
        perm, gL, gbeta = args
        return nb(perm, gL, gbeta) * 1 + nb(gL, gbeta)
    L, lane, g = args
    return nb(L, lane, g, g)


def time_grads(label: str, calls: list, smi: str, reps: int = 20) -> dict:
    """The backward kernels at the wave's 2^20 lanes, on the first bounce
    below max_depth's vertex (and its partial sums), the first permute and
    the un-sort, with seeded upstream gradients: each kernel by events,
    host enqueue and the profiler's device time (warm, and after an L2
    flush each), its plain version by events, beside the PyTorch calls
    that compute the same function as yardsticks (grad_reduce:
    torch.sum(partials, 0), the same sum in another order, the kernels
    line's library_ms; and index_add_ of one [N, 8] row of parameter
    gradients a lane into the material rows, what the reduction by rows
    from the lanes costs in one call; the permute's backward: index_copy_
    of the two gradients packed
    as [N, 6]), and its bound: bytes (grad_bytes) at
    HBM_BW against, for vertex_backward, the forward vertex's float
    operations on the same inputs (counted_ops; the backward recomputes
    every one of them) at F32_PEAK."""
    rec = next(a for n_, a in calls if n_ == "vertex" and a[5] == 1)
    perm = next(a for n_, a in calls if n_ == "permute")
    L, lane = next(a for n_, a in calls if n_ == "unsort")
    meta, pack, hit, state, u, bounce, depth, lights, occ = rec
    n = state.L.shape[0]
    dev = state.L.device
    gL, gbeta = seeded_grads(n, 7, dev, False)
    slim = kernel_state(state)
    partials = shade_ops.vertex_backward(meta, pack, hit, slim, u, bounce,
                                         depth, lights, occ, gL, gbeta)[1]
    fwd_ops, _ = counted_ops(lambda: shade_ops.shade_vertex(
        meta, pack, hit, state, u, bounce, depth, lights=lights), n, dev)
    mat = hit.mat_id.long()
    rows8 = torch.randn((n, 8), device=dev)
    table8 = torch.zeros((pack.mat_c0.shape[0], 8), device=dev)
    packed = torch.cat([gL, gbeta], dim=1)
    into = torch.empty_like(packed)
    flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.int32, device=dev)
    cases = {
        "vertex_backward": (
            lambda: shade_ops.vertex_backward(meta, pack, hit, slim, u,
                                              bounce, depth, lights, occ, gL,
                                              gbeta),
            lambda: shade_ops.vertex_backward_plain(
                meta, pack, hit, state, u, bounce, depth, occ, gL, gbeta,
                lights.le_env),
            (rec, gL, gbeta, partials), fwd_ops, {}),
        "grad_reduce": (
            lambda: shade_ops.grad_reduce(partials),
            lambda: shade_ops.grad_reduce_plain(partials), (partials,), 0,
            {"torch.sum": lambda: torch.sum(partials, 0),
             "index_add_ [N, 8] by material": lambda: table8.index_add_(
                 0, mat, rows8)}),
        "permute_state_backward": (
            lambda: wave_ops.permute_state_backward(perm, gL, gbeta),
            lambda: wave_ops.permute_state_backward_plain(perm, gL, gbeta),
            (perm, gL, gbeta), 0,
            {"index_copy_ [N, 6]": lambda: into.index_copy_(0, perm,
                                                             packed)}),
        "unsort_guard_backward": (
            lambda: wave_ops.unsort_guard_backward(L, lane, gL),
            lambda: wave_ops.unsort_guard_backward_plain(L, lane, gL),
            (L, lane, gL), 0, {})}
    out = {}
    for name, (k, p, args, flops, lib) in cases.items():
        kernel = f"{name}_kernel"
        # the vertex's backward launches one kernel a tangent set: each
        # must be recorded once a call, and the device time is their sum
        names = tuple(f"{kernel}<{s}>" for s in shade_ops.backward_sets(
            meta)) if name == "vertex_backward" else (kernel,)
        nbytes = grad_bytes(name, args)
        b = bound(nbytes, flops)
        ms, _ = time_ms(k, reps)
        _, host, host_max, _, _ = time_enqueue_ms(k, reps)
        dev = profiled_ms(k, reps, names)
        dev_ms = sum(dev.values())
        src = "profiler" if set(dev) == set(names) else next(iter(dev))
        cold = lambda k=k: (flush.fill_(0), k())
        cold_ms = sum(profiled_ms(cold, reps, names).values())
        plain_ms, _ = time_ms(p, 3)
        libs = {}
        for lname, fn in lib.items():
            (_, lib_dev), = profiled_ms(fn, reps, ("",)).items()
            libs[lname] = {"ms": time_ms(fn, reps)[0], "device_ms": lib_dev}
        # each tangent set's launch apart
        per_set = {int(nm[len(kernel) + 1:-1]): v for nm, v in dev.items()
                   if len(names) > 1 and nm in names}
        out[name] = {"ms": ms, "enqueue_ms": host, "device_ms": dev_ms,
                     "set_device_ms": per_set,
                     "device_cold_ms": cold_ms,
                     "device_source": src,
                     "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "bytes": nbytes, "flops": flops,
                     "lanes": n, "library_ms": libs}
        print(f"{label} {name} ({n} lanes, bounce {bounce}): kernel "
              f"{ms:.4f} ms by events, host enqueue {host:.4f} ms (largest "
              f"{host_max:.4f}), device {dev_ms:.4f} ms "
              f"({out[name]['device_source']}), {cold_ms:.4f} ms after an "
              f"L2 flush each; plain {plain_ms:.3f} ms; bound {b[0]:.4f} ms "
              f"by {b[1]} ({nbytes} bytes, {flops} float operations), device "
              f"time {dev_ms / b[0]:.2f}x it"
              + "".join(f"; library {k_} {v['ms']:.4f} ms by events, "
                        f"{v['device_ms']:.4f} ms device"
                        for k_, v in libs.items())
              + "".join(f"; tangent set {s_}'s launch {v:.4f} ms device"
                        for s_, v in per_set.items()) + f" [{smi}]",
              flush=True)
    return out


def grad_edges(cases, dev, sizes=(1, 1000, (1 << 20) + 1)) -> dict:
    """The backward kernels against their plain versions at each of sizes
    lanes: each case's (label, recorded calls) first bounce-1 and last
    vertices with their lanes cut or repeated to the size (the bunny's
    alone past 2^20); the permute's backward by the identity, a reversal
    and a seeded perm, and the un-sort's by those perms as lanes and
    without a sort, on wave_edge_state's colours with NaN and inf lanes.
    Returns {label: counts}."""
    out = {}
    for n in sizes:
        calls = []
        for label, recorded in cases:
            if n > (1 << 20) and label != "bunny":
                continue
            for rec in (next(a for k, a in recorded
                             if k == "vertex" and a[5] == 1),
                        next(a for k, a in recorded
                             if k == "vertex" and a[5] == a[6])):
                m = rec[3].L.shape[0]
                idx = torch.arange(n, device=dev) % m
                calls.append(("vertex", lanes_of(rec, idx)))
        g = torch.Generator(device=dev).manual_seed(n)
        perms = (torch.arange(n, device=dev),
                 torch.arange(n - 1, -1, -1, device=dev),
                 torch.randperm(n, generator=g, device=dev))
        state, _ = wave_edge_state(n, 60 + n, dev, True)
        for perm in perms:
            calls.append(("permute", perm))
        for lane in (None, *perms):
            calls.append(("unsort", (state.L, lane)))
        out[f"edges {n}"] = check_grad_calls(f"gradient edge sets, {n} lanes",
                                             calls)
    return out


def check_tangents(dev) -> None:
    """The backward kernel's own tangent table (shade.kernel_tangents: each
    instantiation's parameters and each material kind's set) equal to
    ops/shade.py's TANGENT_SETS and tangent_set (on the card; the CPU has
    no kernel)."""
    if dev.type != "cuda":
        return
    sets, of = shade_ops.kernel_tangents()
    want = {k: shade_ops.tangent_set(k) for k in shade_ops.TANGENTS}
    if sets != shade_ops.TANGENT_SETS or of != want:
        raise AssertionError(f"the kernel's tangent sets {sets} and kinds' "
                             f"sets {of}; ops/shade.py's "
                             f"{shade_ops.TANGENT_SETS} and {want}")
    print(f"the backward kernel's tangent sets {sets} (parameters 0-2 c0, "
          f"3-5 c1, 6 s0, 7 s1) and material kinds' sets {of} equal "
          "ops/shade.py's", flush=True)


def many_slots_grads(dev, smi: str, res: int = 256, depth: int = 3) -> dict:
    """value_and_grad of the mean pixel of the many-slots scene at res^2,
    1 spp, over the material and light fields, on the kernel route (its
    backward through vertex_backward's device-memory accumulators, with
    the exact launches grad_launches counts) against the plain route
    (plain_grad): each field within GRAD_FIELD_TOL of its largest
    |gradient|, finite, and at least 16 of the floor's material rows with
    a gradient."""
    scene = many_slots_scene().to(dev)
    slots = shade_ops.n_grad_slots(scene.pack)
    fields = GRAD_WAVE_FIELDS
    fn, pack = render_fn(scene, res, res, 1, seed=3, max_depth=depth,
                         device=dev)
    loss = lambda img: img.mean()
    _, g, _, b_ms, _, bwd, _ = fwd_bwd(fn, pack, fields, loss)
    want = grad_launches(scene.meta, n_waves(res, res, 1, DEFAULT_CHUNK),
                         depth)
    if any(bwd[k] != want[k] for k in want):
        raise AssertionError(f"many-slots backward launches {bwd}, expected "
                             f"{want}")
    with plain_grad():
        _, gp, _, pb_ms, _, _, _ = fwd_bwd(fn, pack, fields, loss)
    worst = 0.0
    for k in fields:
        scale = float(gp[k].abs().max())
        err = float((g[k] - gp[k]).abs().max())
        if not (err <= GRAD_FIELD_TOL * scale or err == 0.0) \
                or not bool(torch.isfinite(g[k]).all()):
            raise AssertionError(f"many-slots d loss / d {k}: the kernels' "
                                 f"differ from the plain route's by {err} "
                                 f"(largest |gradient| {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    rows = int((g["mat_c0"].abs().sum(1) > 0).sum())
    if rows < 16:
        raise AssertionError(f"many-slots: {rows} material rows with a "
                             "gradient")
    print(f"many-slots scene ({scene.meta.n_mat} materials, {slots} "
          f"parameter slots) {res}^2 1 spp depth {depth}: value_and_grad on "
          f"the kernels, backward {b_ms:.1f} ms, launches {bwd}; {rows} "
          f"material rows with a gradient; every field within "
          f"{worst:.2e} of its largest |gradient| of the plain route's "
          f"(gate {GRAD_FIELD_TOL}; plain backward {pb_ms:.1f} ms) [{smi}]",
          flush=True)
    return {"slots": slots, "field_rel": worst, "backward_ms": b_ms,
            "plain_backward_ms": pb_ms, "rows": rows}


def grad_phase(cases, dev, smi: str, time_case: str | None = None) -> dict:
    """The kernel's tangent table (check_tangents); for each (label, scene,
    res) of cases the forward of one differentiated 1-spp wave, its
    vertex, permute and un-sort calls recorded (grad_wave_calls) and each
    call's backward held against its plain version (check_grad_calls); the
    case labelled time_case timed (time_grads); then the edge sets
    (grad_edges). Returns {label: counts} and "times"."""
    check_tangents(dev)
    out, recorded = {}, []
    for label, scene, res in cases:
        calls = grad_wave_calls(label, scene, res, dev)
        out[label] = check_grad_calls(f"{label} {res}^2 gradient wave", calls)
        if label == time_case:
            out["times"] = time_grads(label, calls, smi)
        recorded.append((label, calls))
    out.update(grad_edges(recorded, dev))
    return out


# --------------------------------------------------------------------------
# 3, 6. kernel vs plain
# --------------------------------------------------------------------------

def wave_rays(scene, res: int, seed: int, dev):
    """res^2 lanes: even pixels are camera rays; odd pixels are bounce rays
    from their camera ray's hit on the scene (floor included) with seeded
    cosine-weighted directions about the hit normal (lanes whose camera
    ray escapes are dead). Returns o, d, tmin, tmax."""
    cam = camera_mod.make_camera(scene.camera.lookfrom, scene.camera.front,
                                 scene.camera.vup, scene.camera.vfov,
                                 (res, res), device=dev)
    ids = torch.arange(res * res, device=dev)
    keys = rng.lane_keys(seed, 0, ids)
    jit = rng.camera_jitter(keys)
    xy = torch.stack([(ids % res).float() + jit[:, 0],
                      (ids // res).float() + jit[:, 1]], dim=-1)
    o, d = camera_mod.generate_rays(cam, xy)
    n = o.shape[0]
    tmin = scene.pack.ray_eps.expand(n).clone()
    tmax = torch.full((n,), float("inf"), device=dev)
    h = scene_pack.intersect(scene.meta, scene.pack, o, d, tmin, tmax)
    bounce = (ids % 2) == 1
    local = sample_cosine_hemisphere(rng.uniforms(keys, 1, 2))
    dirs = to_world(frame_from_z(h.normal), local)
    o = torch.where(bounce[:, None], h.position, o).contiguous()
    d = torch.where(bounce[:, None], dirs, d).contiguous()
    dead = bounce & ~h.valid
    tmin = torch.where(dead, torch.full_like(tmin, float("inf")), tmin)
    tmax = torch.where(dead, torch.full_like(tmax, -1.0), tmax)
    return o, d, tmin, tmax


def targeted_rays(scene, route: Route, n: int, seed: int, dev):
    """n incoherent rays that mostly hit the mesh: origins anywhere in a
    box around its instances, aimed at random points of a random
    instance's world box; the traversal goes deep on nearly every lane."""
    rs = np.random.default_rng(seed)
    r = route.rows
    pts = np.concatenate([r[:, 0:3], r[:, 0:3] + r[:, 3:6],
                          r[:, 0:3] + r[:, 6:9]])
    blo, bhi = pts.min(0), pts.max(0)
    inst = route.inst[1:]
    lo = (blo[None] * inst[:, 3:4] + inst[:, :3]).min(0)
    hi = (bhi[None] * inst[:, 3:4] + inst[:, :3]).max(0)
    pad = hi - lo
    o = rs.uniform(lo - pad, hi + pad, (n, 3))
    k = rs.integers(0, len(inst), n)
    target = rs.uniform(blo, bhi, (n, 3)) * inst[k, 3:4] + inst[k, :3]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return (f(o).contiguous(), f(d).contiguous(),
            scene.pack.ray_eps.expand(n).clone(),
            torch.full((n,), float("inf"), device=dev))


def _abs_cross(a, b):
    """|a| x |b| with every product added: bounds the rounding of a x b."""
    a, b = np.abs(a), np.abs(b)
    return np.stack([a[..., 1] * b[..., 2] + a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] + a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], -1)


def _mt64_all(o, d, rows):
    """Float64 Moller-Trumbore of one ray against rows [K,9] (p0, e1, e2)
    -> (t, margin = min(u, v, 1-u-v), dt, dm), each [K]; t = inf where
    det ~ 0. dt and dm bound, to first order, how far a float32 evaluation
    of the same test can land from t and margin: the origin's rounding in
    instance space (o - off, / scale, - p0: 3 roundings of |o| + |p0|)
    carried through the test's linear map, plus each cross-then-dot
    product's rounding (5 roundings of the sum of its absolute terms).
    A ray grazing the plane (det ~ 0) or a small triangle far from the
    origin makes them large."""
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pv = np.cross(d[None, :], e2)
    det = np.einsum("kj,kj->k", e1, pv)
    ok = np.abs(det) > 1e-18
    det = np.where(ok, det, 1.0)
    tv = o[None, :] - p0
    u = np.einsum("kj,kj->k", tv, pv) / det
    qv = np.cross(tv, e1)
    v = (qv @ d) / det
    t = np.where(ok, np.einsum("kj,kj->k", e2, qv) / det, np.inf)

    dot = lambda a, b: np.einsum("kj,kj->k", a, b)
    do = 3 * U32 * (np.abs(o).max() + np.abs(p0).max(axis=1))
    adet, atv = np.abs(det), np.abs(tv)
    apv, aqv = _abs_cross(d[None, :], e2), _abs_cross(atv, e1)
    rel = 5 * U32 * dot(np.abs(e1), apv) / adet
    du = (do * np.abs(pv).sum(1) + 5 * U32 * dot(atv, apv)) / adet
    dv = (do * np.abs(np.cross(e1, d[None, :])).sum(1)
          + 5 * U32 * (aqv @ np.abs(d))) / adet
    dt = (do * np.abs(np.cross(e1, e2)).sum(1)
          + 5 * U32 * dot(np.abs(e2), aqv)) / adet
    m = np.minimum(np.minimum(u, v), 1.0 - u - v)
    with np.errstate(invalid="ignore"):
        return (t, m, dt + np.abs(t) * rel,
                du + dv + (np.abs(u) + np.abs(v)) * rel)


class Cand(NamedTuple):
    """One float64 hit of a ray: world t, margin, instance, row, and the
    float32 rounding bounds of t and margin."""
    t: float
    m: float
    inst: int
    row: int
    dt: float
    dm: float


def _lane_candidates(o, d, tmin, tmax, tris64, inst):
    """Every f64 hit of one ray over all instances that is inside the ray
    interval or close to it, as Cand."""
    out = []
    for i in range(inst.shape[0] - 1):
        off, scl = inst[i + 1, :3], inst[i + 1, 3]
        t, m, dt, dm = _mt64_all((o - off) / scl, d, tris64)
        tw, dtw = t * scl, dt * scl
        with np.errstate(invalid="ignore"):
            near = (m >= -(GRAZE + dm)) \
                & (tw > tmin * (1 - TIE_RTOL) - dtw) \
                & (tw < tmax * (1 + TIE_RTOL) + dtw)
        for k in np.nonzero(near)[0]:
            out.append(Cand(tw[k], m[k], i, k, dtw[k], dm[k]))
    return out


def _fragile(c: Cand, tmin, tmax):
    """A hit that float32 rounding may move across an edge or an end of
    the ray interval."""
    slack = TIE_RTOL * c.t + c.dt
    return (abs(c.m) <= GRAZE + c.dm or abs(c.t - tmin) <= slack
            or (np.isfinite(tmax) and abs(c.t - tmax) <= slack))


def explain_lane(o, d, tmin, tmax, hits, any_hit, tris64, inst, n_tris):
    """True when the kernel / plain disagreement on this lane is an f32
    edge graze or a t near-tie: `hits` is [(valid, t, index)] per side."""
    cands = _lane_candidates(o, d, tmin, tmax, tris64, inst)
    if any_hit:
        robust = [c for c in cands if not _fragile(c, tmin, tmax)
                  and tmin < c.t < tmax]
        # a solid occluder inside (tmin, tmax) means the side that missed
        # it is wrong; no candidate at all means the other side is
        return not robust and bool(cands)
    # closest hit: each side's hit must be a real f64 hit of its triangle,
    # and the two must be a near-tie or involve a grazed triangle
    picked = []
    for valid, t, idx in hits:
        if not valid:
            picked.append(None)
            continue
        ins, row = divmod(int(idx), n_tris)
        same = [c for c in cands if c.inst == ins and c.row == row]
        if not same or abs(same[0].t - t) > TIE_RTOL * t + same[0].dt:
            return False
        picked.append(same[0])
    a, b = picked
    if a is None or b is None:
        hit = a or b
        return _fragile(hit, tmin, tmax)
    near = a if a.t <= b.t else b
    return abs(a.t - b.t) <= TIE_RTOL * max(a.t, b.t) + a.dt + b.dt or \
        abs(near.m) <= GRAZE + near.dm


def check_lanes(route: Route, mode, o, d, tmin, tm, any_hit, hk, hp,
                exact=None):
    """Hold the kernel's hits hk against the plain version's hp on the same
    rays. Prints the count of lanes whose t, index or valid differ at all.
    With exact (route.exact by default) that count must be 0; every such
    lane is still put through the float64 forensic and printed first.
    Otherwise every lane where the hits differ must be explained by the
    forensic, and at most MAX_EXPLAINED of the lanes may differ. Prints one
    line and returns the max |t| error on agreeing closest-hit lanes."""
    exact = route.exact if exact is None else exact
    tris_rows = route.rows
    n_tris = route.n_tris
    n = o.shape[0]
    vk, vp = hk.valid.cpu().numpy(), hp.valid.cpu().numpy()
    tk, tp = hk.t.cpu().numpy(), hp.t.cpu().numpy()
    ik, ip = hk.index.cpu().numpy(), hp.index.cpu().numpy()
    on, dn = o.cpu().numpy(), d.cpu().numpy()
    tmn, tmx = tmin.cpu().numpy(), tm.cpu().numpy()
    n_bits = int(((tk.view(np.int32) != tp.view(np.int32)) | (ik != ip)
                  | (vk != vp)).sum())
    bad = vk != vp
    max_err = 0.0
    if not any_hit:
        both = vk & vp
        # compare the triangle rows and instances the indices select:
        # leaves are padded by duplicating triangles
        same_row = np.all(tris_rows[ik % n_tris] == tris_rows[ip % n_tris],
                          axis=1) & (ik // n_tris == ip // n_tris)
        # t within T_RTOL, or within the float32 resolution of the ray's
        # origin (a smaller difference does not move the hit point o + t d):
        # hits just past tmin, t ~ 1e-3 on a bounce from a surface ~100
        # units out, differ by ~1e-7 between two float32 evaluations
        t_atol = np.finfo(np.float32).eps * np.abs(on).max(axis=1)
        with np.errstate(invalid="ignore"):
            t_ok = np.abs(tk - tp) <= T_RTOL * np.abs(tp) + t_atol
        bad |= both & ~(same_row & t_ok)
        agree = both & ~bad
        max_err = float(np.abs(tk[agree] - tp[agree]).max(initial=0.0))
    lanes = np.nonzero(bad)[0]
    tris64 = tris_rows.astype(np.float64)
    inst = route.inst.astype(np.float64)
    unexplained = [
        int(j) for j in lanes
        if not explain_lane(on[j].astype(np.float64),
                            dn[j].astype(np.float64), float(tmn[j]),
                            float(tmx[j]),
                            [(vk[j], float(tk[j]), ik[j]),
                             (vp[j], float(tp[j]), ip[j])],
                            any_hit, tris64, inst, n_tris)]
    print(f"{mode}: lanes {n}, valid kernel {int(vk.sum())} plain "
          f"{int(vp.sum())}, lanes not equal bit for bit {n_bits}, "
          f"disagreeing hits {len(lanes)}, explained "
          f"{len(lanes) - len(unexplained)}, unexplained {len(unexplained)}"
          + (f", closest-hit max |t_kernel - t_plain| on agreeing lanes "
             f"{max_err:.6g}" if not any_hit else ""), flush=True)
    if exact and n_bits:
        raise AssertionError(f"{mode}: {n_bits} lanes differ from the plain "
                             "version (bit for bit expected)")
    if unexplained:
        raise AssertionError(f"{mode}: unexplained lanes {unexplained[:20]}")
    if len(lanes) > MAX_EXPLAINED * n:
        raise AssertionError(f"{mode}: {len(lanes)} explained lanes exceed "
                             f"{MAX_EXPLAINED:.1%} of {n}")
    return max_err


def compare_modes(route: Route, label, o, d, tmin, tmax):
    """Kernel vs plain on the same rays in both modes; returns the max |t|
    error on agreeing closest-hit lanes."""
    n = o.shape[0]
    h_ref = route.plain(o, d, tmin, tmax, any_hit=False)
    rs = np.random.default_rng(3)
    # finite tmax 10% short of or beyond the closest hit (shadow rays)
    f = torch.as_tensor(np.where(rs.uniform(size=n) < 0.5, 0.9, 1.1),
                        dtype=torch.float32, device=o.device)
    tmax_sh = torch.where(h_ref.valid, h_ref.t * f, torch.full_like(f, 1e3))
    tmax_sh = torch.where(tmax < 0, tmax, tmax_sh)
    max_err = 0.0
    for any_hit, tm in ((False, tmax), (True, tmax_sh)):
        tm = tm.contiguous()
        ms_k, hk = time_ms(
            lambda: route.kernel(o, d, tmin, tm, any_hit=any_hit), 10)
        ms_p, hp = time_ms(
            lambda: route.plain(o, d, tmin, tm, any_hit=any_hit), 1)
        mode = f"{route.name} {label} {'any-hit' if any_hit else 'closest'}"
        max_err = max(max_err, check_lanes(route, mode, o, d, tmin, tm,
                                           any_hit, hk, hp))
        print(f"{mode}: kernel {ms_k:.4f} ms, plain {ms_p:.2f} ms",
              flush=True)
    return max_err


def time_ms(fn, reps: int):
    """(mean ms of reps calls by CUDA events, output of the warm-up call)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def time_enqueue_ms(fn, reps: int):
    """(mean ms per call by CUDA events, mean and largest host ms per call
    to enqueue it, host_stalls of the timed calls, output of the warm-up
    call): events bracket the reps calls on the stream and the host clock
    stops before the closing synchronize, so where the host ms reaches the
    events' ms the host, not the card, set the pace."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    laps = []
    with host_stalls() as stalls:
        start.record()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            laps.append((time.perf_counter() - t0) * 1e3)
        end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps, sum(laps) / reps, max(laps),
            stalls, out)


def _shadow_tmax(route: Route, o, d, tmin, tmax):
    h = route.kernel(o, d, tmin, tmax, any_hit=False)
    tmax_sh = torch.where(h.valid, h.t * 0.9, torch.full_like(h.t, 1e3))
    return torch.where(tmax < 0, tmax, tmax_sh).contiguous(), h


PROFILER_TRIES = 3
PROFILER_WARMUP_S = 0.02


def profiled_ms(fn, reps: int, names, each=None, walls=None) -> dict:
    """Device time per call in ms, by the profiler, of the device
    operations (kernels, memsets) whose names contain each of `names`, over
    reps calls of fn. `each` (default: all of names) are the operations
    every call launches. The profiler loses the records of the first
    launches after its trace starts (one cast of five lost its cull and
    memset, 10-62 of 100 K3 launches), so each run traces a warm-up step
    of calls (reps, and PROFILER_WARMUP_S at least) that its schedule
    discards before the reps calls it keeps. A run counts only where each
    of `each` was recorded reps times, or anything was where `each` is
    empty; the profiler now and then records nothing of a run, which is
    then made again, up to PROFILER_TRIES. Where none is complete the time
    is the events' behind a held stream (queued_events_ms), under the key
    "queued events", so that neither an unmeasured 0 nor a partial sum is
    reported as a device time. `walls`, where given, gets the host wall
    per call of each traced run's kept calls (to the card's synchronize),
    in ms."""
    from torch.profiler import ProfilerActivity, profile, schedule

    each = tuple(names) if each is None else tuple(each)
    for attempt in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            t0, n = time.perf_counter(), 0
            while n < reps or time.perf_counter() - t0 < PROFILER_WARMUP_S:
                fn()
                n += 1
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            if walls is not None:
                walls.append((time.perf_counter() - t0) * 1e3 / reps)
            prof.step()
        # the step's annotation spans the kernels: not device time
        events = [e for e in prof.key_averages() if _device_us(e) > 0
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("ProfilerStep")]
        out = {nm: sum(_device_us(e) for e in events if nm in e.key) / 1e3
               / reps for nm in names}
        seen = {nm: sum(e.count for e in events if nm in e.key)
                for nm in each}
        if all(n >= reps for n in seen.values()) and any(out.values()):
            return out
        print(f"the profiler's run {attempt + 1} of {PROFILER_TRIES} "
              f"recorded {seen} of {reps} calls", flush=True)
    ms = queued_events_ms(fn, reps)
    print(f"no complete profiler run of {names}: device time {ms:.4f} ms "
          "per call by events behind a held stream", flush=True)
    return {"queued events": ms}


def queued_events_ms(fn, reps: int) -> float:
    """Device time per call in ms by CUDA events, with the host's enqueue
    kept out: the stream is held by a spin kernel (torch.cuda._sleep) while
    the host enqueues the events and reps calls, so the events bracket the
    card's run of them alone, gaps between launches included. The hold
    doubles until the start event is still pending when the host is done;
    fn must not wait on the card."""
    cycles = 1 << 24
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the host could not enqueue the calls within the "
                         "stream's hold")


def time_wide(scene, route: Route, dev):
    """Kernel and plain times, both modes, on 1024^2 rays: one main-path
    wave (half camera, half bounce) and the targeted incoherent set. The
    kernel's event time per call is printed beside the profiler's device
    time. The timed calls' outputs are held against each other bit for
    bit, and the kernel's counters against the plain walk's node visits
    and triangle tests, which with its ranked visits give each closest-hit
    call its bound; the counters' SIMD efficiency and cycle split are
    printed."""
    tables = scene.pack.inst_wide[0]
    kw = dict(has_inst=True, leaf_size=scene.meta.blas_leaf_size[0],
              n_tris=scene.meta.n_blas_tris[0])
    out = {}
    for label, rays in (("wave", wave_rays(scene, 1024, 11, dev)),
                        ("targeted",
                         targeted_rays(scene, route, 1 << 20, 12, dev))):
        o, d, tmin, tmax = rays
        tmax_sh, h = _shadow_tmax(route, o, d, tmin, tmax)
        for mode, any_hit, tm in (("closest", False, tmax),
                                  ("any", True, tmax_sh)):
            call = lambda: route.kernel(o, d, tmin, tm, any_hit=any_hit)
            k, hk = time_ms(call, 10)
            k_dev = sum(profiled_ms(call, 10, WIDE_OPS).values())
            p, (hp, pst) = time_ms(lambda: wide_bvh.intersect_wide_plain(
                tables, o, d, tmin, tm, any_hit=any_hit, with_stats=True,
                **kw), 1)
            name = f"{route.name} {label} {mode} at {o.shape[0]} rays"
            out[label, mode] = (k, p)
            out["err"] = max(out.get("err", 0.0), check_lanes(
                route, name, o, d, tmin, tm, any_hit, hk, hp))
            kst = wide_bvh.stats_summary(wide_bvh.intersect_wide(
                tables, o, d, tmin, tm, any_hit=any_hit, with_stats=True,
                **kw)[1], kw["leaf_size"])
            if (kst["node_visits"], kst["tri_tests"]) != (
                    pst["node_visits"], pst["tri_tests"]):
                raise AssertionError(f"{name}: kernel counts {kst}, plain "
                                     f"walk {pst}")
            print(f"{name} ({int(h.valid.sum())} closest hits): kernel "
                  f"{k:.4f} ms by events, {k_dev:.4f} ms of device time by "
                  f"the profiler; plain {p:.2f} ms; node visits "
                  f"{kst['node_visits']}, triangle tests {kst['tri_tests']} "
                  f"(kernel = plain walk), ranked node visits "
                  f"{pst['ranked_visits']}; " + counters_line(kst), flush=True)
            if mode == "closest":
                nbytes, flops = wide_work(tables, o, d, tmin, tm, pst)
                ms, by = bound(nbytes, flops)
                out["bound", label] = (ms, by)
                out["dev", label] = k_dev
                print(f"{name}: {nbytes} bytes, {flops} float operations: "
                      f"bound {ms:.4f} ms ({by})", flush=True)
    return out


def wide_casts(scene, dev, res=1024, depth=5, seed=1):
    """Every wide-kernel cast of one 1-spp wave of the frame, in order:
    [(tables, o, d, tmin, tmax, kwargs)], recorded by wrapping
    wide_bvh.intersect_wide for the length of one render."""
    casts = []
    inner = wide_bvh.intersect_wide

    @functools.wraps(inner)  # the wrapper counts its launches on `record`
    def record(tables, o, d, tmin, tmax, **kw):
        # a replay writes outputs of its own, not the wave's slab rows
        casts.append((tables, o.clone(), d.clone(), tmin.clone(),
                      tmax.clone(), {k: v for k, v in kw.items()
                                     if k != "out"}))
        return inner(tables, o, d, tmin, tmax, **kw)

    wide_bvh.intersect_wide = record
    try:
        # the eager wave: a replayed graph runs no Python, so records nothing
        render(scene, res, res, spp=1, max_depth=depth, seed=seed, device=dev,
               graph=False)
    finally:
        wide_bvh.intersect_wide = inner
    return casts


def counters_line(st) -> str:
    """The wide kernel's counters (stats_summary) in words."""
    cyc = max(st["cycles_node"] + st["cycles_leaf"] + st["cycles_stack"], 1)
    return (f"live {st['live']}, survivors {st['survivors']}; SIMD efficiency "
            f"{st['simd']:.3f} (node steps {st['simd_node']:.3f}, leaf steps "
            f"{st['simd_leaf']:.3f}); lane-0 cycles of the walk node "
            f"{100 * st['cycles_node'] / cyc:.1f}%, leaf "
            f"{100 * st['cycles_leaf'] / cyc:.1f}%, stack "
            f"{100 * st['cycles_stack'] / cyc:.1f}%")


@contextlib.contextmanager
def host_stalls():
    """While open, counts what can stall the host between launches: the
    garbage collector's passes and their wall time in ms, and the caching
    allocator's cudaMalloc and cudaFree calls: {"gc": ..., "gc_ms": ...,
    "mallocs": ..., "frees": ...}."""
    out, start = {"gc": 0, "gc_ms": 0.0}, [0.0]

    def watch(phase, _info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            out["gc"] += 1
            out["gc_ms"] += (time.perf_counter() - start[0]) * 1e3

    alloc = lambda: [torch.cuda.memory_stats().get(k, 0)
                     for k in ("num_device_alloc", "num_device_free")]
    before = alloc()
    gc.callbacks.append(watch)
    try:
        yield out
    finally:
        gc.callbacks.remove(watch)
        out["mallocs"], out["frees"] = (a - b for a, b in zip(alloc(), before))


def stalls_line(st) -> str:
    return (f"{st['gc']} collector passes ({st['gc_ms']:.3f} ms), "
            f"{st['mallocs']} cudaMalloc, {st['frees']} cudaFree")


def time_casts(casts):
    """Each recorded cast replayed alone: live lanes, survivors of the
    cull, the kernel's event time, host enqueue time (mean and slowest
    call) and profiler device time, and its output held against the plain
    version's bit for bit; what could stall the host during the
    event-timed calls (host_stalls). Returns the summed event and device
    times in ms."""
    total = total_dev = total_host = 0.0
    stalls = dict.fromkeys(("gc", "gc_ms", "mallocs", "frees"), 0)
    missed = []
    for j, (tables, o, d, tmin, tmax, kw) in enumerate(casts):
        call = lambda: wide_bvh.intersect_wide(tables, o, d, tmin, tmax, **kw)
        ms, host_ms, slowest, g, hk = time_enqueue_ms(call, 5)
        for k in stalls:
            stalls[k] += g[k]
        dev = profiled_ms(call, 5, WIDE_OPS)
        dev_ms = sum(dev.values())
        hp = wide_bvh.intersect_wide_plain(tables, o, d, tmin, tmax, **kw)
        same = all(torch.equal(x, y) for x, y in zip(hk, hp))
        if not same:
            raise AssertionError(f"wide cast {j}: kernel and plain differ")
        live = int(wide_bvh.live_lanes(o, d, tmin, tmax).sum())
        surv = int(wide_bvh.wide_root_cull_plain(tables, o, d, tmin,
                                                 tmax).sum())
        total += ms
        total_dev += dev_ms
        total_host += host_ms
        if "queued events" in dev:
            missed.append(j)
        print(f"wide cast {j} ({'any-hit' if kw['any_hit'] else 'closest'}"
              f", {o.shape[0]} lanes): live {live}, survivors {surv}, hits "
              f"{int(hk.valid.sum())}; kernel {ms:.4f} ms by events (host "
              f"enqueue {host_ms:.4f} ms, slowest call {slowest:.4f} ms), "
              f"{dev_ms:.4f} ms of device time; equal to plain bit for bit",
              flush=True)
    print(f"wide casts of one 1-spp wave: {len(casts)}, kernel time summed "
          f"{total:.4f} ms by events (host enqueue {total_host:.4f} ms), "
          f"{total_dev:.4f} ms of device time (by queued events, no "
          f"complete profiler run: casts {missed}); during the event-timed "
          "calls " + stalls_line(stalls), flush=True)
    return total, total_dev


def timed_bound(route: Route, label, o, d, tmin, tmax):
    """The bound of the timed closest-hit call on these rays; prints its
    work counts."""
    nbytes, flops, counts = route.work(o, d, tmin, tmax)
    ms, by = bound(nbytes, flops)
    print(f"{route.name} {label} closest at {o.shape[0]} rays: {counts}, "
          f"{nbytes} bytes, {flops} float operations: bound {ms:.4f} ms "
          f"({by})", flush=True)
    return ms, by


def time_sweep(scene, route: Route, label, dev):
    """Kernel and plain times, both modes, on one main-path wave of 2^20
    rays. The plain version is timed at 2^18 first (the first 2^18 rays of
    the wave) and at 2^20 only when that took under PLAIN_2_18_LIMIT_S.
    The timed calls' outputs are held against each other as in
    compare_modes, on every ray the plain version was given."""
    o, d, tmin, tmax = wave_rays(scene, 1024, 11, dev)
    tmax_sh, h = _shadow_tmax(route, o, d, tmin, tmax)
    out = {}
    for mode, any_hit, tm in (("closest", False, tmax),
                              ("any", True, tmax_sh)):
        k, hk = time_ms(
            lambda: route.kernel(o, d, tmin, tm, any_hit=any_hit), 5)
        p_rays = min(1 << 18, o.shape[0])
        q = slice(0, p_rays)
        p, hp = time_ms(lambda: route.plain(o[q], d[q], tmin[q], tm[q],
                                            any_hit=any_hit), 1)
        if p < PLAIN_2_18_LIMIT_S * 1e3 and p_rays < o.shape[0]:
            p, hp = time_ms(
                lambda: route.plain(o, d, tmin, tm, any_hit=any_hit), 1)
            p_rays = o.shape[0]
        q = slice(0, p_rays)
        hk = type(hk)(*(x[q] for x in hk))
        out["err"] = max(out.get("err", 0.0), check_lanes(
            route, f"{route.name} {label} wave {mode} at {p_rays} rays", o[q],
            d[q], tmin[q], tm[q], any_hit, hk, hp))
        out[mode] = (k, p, p_rays)
        print(f"{route.name} {label} wave {mode} ({int(h.valid.sum())} closest "
              f"hits of {o.shape[0]}): kernel {k:.4f} ms at {o.shape[0]} rays, "
              f"plain {p:.2f} ms at {p_rays} rays", flush=True)
    out["bound"] = timed_bound(route, f"{label} wave", o, d, tmin, tmax)
    return out


# --------------------------------------------------------------------------
# 4, 7. main path
# --------------------------------------------------------------------------

def _device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def expected_launches(meta, res: int, spp: int, depth: int,
                       fused: bool = True) -> dict:
    """Each kernel's launches in render()'s res^2 frame (or a gradient's
    forward of it): per wave, (depth + 1) closest and depth x lights
    shadow casts of each BVH mesh on its route, and its lane keys, the
    camera's jitter and one set of uniforms per vertex below max_depth,
    one Threefry launch each; on the fused vertex's route
    (ops/shade.py::kernel_route, gradients in the appearance fields
    included; fused=False for the plain route: MIS, no NEE, a gradient in
    another field, plain_grad) one shade_vertex per vertex (depth + 1, the
    last the emission alone) and one nee_accumulate per vertex below
    max_depth;
    one brute_hits per cast where the scene has a brute-force shape
    (scene_pack.brute_shapes); on every path (rays_launches,
    wave_launches) ops/rays.py's and ops/wave.py's kernels; and no
    backward kernel (grad_launches counts a backward's)."""
    lights = sum(1 for lt in meta.lights if not lt.static_black)
    waves = n_waves(res, res, spp, DEFAULT_CHUNK)
    casts = waves * ((depth + 1) + depth * lights)
    brute = bool(meta.n_sph or meta.n_rect or meta.n_disk or (
        meta.n_tri and not (meta.wide_bvh or meta.pallas_bvh)))
    return {"wide_bvh": casts * (sum(meta.wide_blas) + int(meta.wide_bvh)),
            "sweep_bvh": casts * (sum(meta.pallas_blas)
                                  + int(meta.pallas_bvh)),
            "threefry": waves * (2 + depth),
            "shade_vertex": waves * (depth + 1) if fused else 0,
            "nee_accumulate": waves * depth if fused else 0,
            "brute_hits": casts if brute else 0,
            **rays_launches(meta, waves, depth),
            **wave_launches(meta, waves, depth, fused),
            **dict.fromkeys(GRAD, 0)}


def wave_launches(meta, waves: int, depth: int, fused: bool = True) -> dict:
    """ops/wave.py's launches in `waves` waves of the path integrator at
    max_depth `depth`: one camera_rays a wave on every path, and on the
    fused vertex's route (fused=False for the plain route) one
    permute_state per sort between bounces (bounces 0 to 2 below depth,
    where the sorts default on: a kernel-routed scene) and one
    unsort_guard a wave."""
    sorts = min(3, depth) if meta.kernel_routed else 0
    return {"camera_rays": waves,
            "permute_state": waves * sorts if fused else 0,
            "unsort_guard": waves if fused else 0}


def rays_launches(meta, waves: int, depth: int) -> dict:
    """ops/rays.py's launches in `waves` waves of li_path at max_depth
    `depth` (the forward of every path: their inputs never require grad):
    per wave one hit_reconstruct per closest cast (depth + 1), one
    shadow_segments and one occlusion_merge per shadow cast (depth x
    lights), and, in a kernel-routed scene (meta.kernel_routed, where the
    sorts default on), one shadow_key per sorted shadow cast (bounces 0
    and 1 below depth, x lights) and per sort between bounces (bounces 0
    to 2 below depth)."""
    lights = sum(1 for lt in meta.lights if not lt.static_black)
    keys = (min(2, depth) * lights + min(3, depth)
            if meta.kernel_routed else 0)
    return {"shadow_key": waves * keys,
            "shadow_segments": waves * depth * lights,
            "occlusion_merge": waves * depth * lights,
            "hit_reconstruct": waves * (depth + 1)}


TRACED_KERNELS = {"wide_bvh": ("wide_walk_kernel",),
                  "sweep_bvh": ("sweep_bvh_kernel",),
                  "threefry": ("lane_keys_kernel", "uniforms_kernel"),
                  "shade_vertex": ("shade_vertex_kernel",),
                  "nee_accumulate": ("nee_accumulate_kernel",),
                  "brute_hits": ("brute_hits_kernel",),
                  **{name: (f"{name}_kernel",)
                     for name in RAYS + WAVE + GRAD}}


def traced_launches(prof) -> dict:
    """Each kernel of the path's launches in a profiler trace: its device
    function's records counted by name (one per launch, a graph's kernel
    nodes on every replay)."""
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    return {k: sum(e.count for e in events if any(n in e.key for n in names))
            for k, names in TRACED_KERNELS.items()}


def traced_frame(frame, warm):
    """frame() under a profiler trace of the card, whose first step runs
    warm() and is discarded (the profiler loses the first launches after
    its trace starts), the launch counters set to 0 after it: (frame's
    output, its wall in s, the launches its trace recorded)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        reset_launches()
        t0 = time.perf_counter()
        out = frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return out, wall, traced_launches(prof)


def counted_frame(frame, warm, expected: dict, label: str):
    """frame() traced (traced_frame) with its launch counters checked:
    they must equal `expected`, and the launches the trace recorded must
    equal them; where a trace lost records the frame is run again, up to
    PROFILER_TRIES. Returns (frame's output, its wall in s under the
    trace, the traced launches, the peak memory allocated)."""
    for attempt in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, wall, traced = traced_frame(frame, warm)
        launches = launch_counts()
        if launches != expected:
            raise AssertionError(f"{label}: kernel launches {launches}, the "
                                 f"wave structure implies {expected}")
        if traced == launches:
            return out, wall, traced, torch.cuda.max_memory_allocated()
        print(f"the profiler's trace {attempt + 1} of {PROFILER_TRIES} of "
              f"the {label} frame recorded launches {traced}, its counters "
              f"{launches}", flush=True)
    raise AssertionError(f"{label}: no trace of the counted frame recorded "
                         "the launches its counters hold")


def main_path(scene, dev, label, res=1024, spp=4, depth=5):
    """Render the frame once with the exact launch count of each traversal
    kernel checked (phase 13 profiles its 1-spp wave). The frame replays its
    waves from CUDA graphs, captured by a 1-spp frame of the same key
    (seed, stats, lane count) rendered with graph=True first. The counted
    frame runs under a profiler trace: its counters (a replay counts its
    graph's kernel nodes) must equal what the wave structure implies, and
    the launches its trace recorded must equal the counters; where a trace
    lost records the frame is rendered again, up to PROFILER_TRIES.
    Returns the launches the trace recorded."""
    expected = expected_launches(scene.meta, res, spp, depth)
    warm = lambda: render(scene, res, res, spp=1, max_depth=depth, seed=0,
                          clamp=False, device=dev, with_stats=True,
                          graph=True)
    warm()  # captures the wave
    (img, st), wall, traced, peak = counted_frame(
        lambda: render(scene, res, res, spp=spp, max_depth=depth, seed=0,
                       clamp=False, device=dev, with_stats=True), warm,
        expected, label)
    if img.shape != (res, res, 3) or not torch.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError(f"{label}: render output is not a finite "
                             f"non-negative [{res},{res},3] image")
    sweep = {k: v for k, v in st.items() if k.startswith("sweep_")}
    print(f"{label} {res}^2 spp {spp} depth {depth}, waves replayed: wall "
          f"{wall:.3f} s under the profiler's trace, "
          f"rays {st['rays']} ({st['rays'] / wall:.1f} rays/s), "
          + ", ".join(f"{c} {st['rays_' + c]} ({st['rays_' + c] / wall:.1f}/s)"
                      for c in ("primary", "bounce", "shadow"))
          + f", kernel launches {traced} by the trace, equal to the counters "
          f"(expected {expected}), peak memory {peak} bytes, image mean "
          f"{float(img.mean()):.5f}"
          + (f", sweep counters {sweep}" if sweep else ""), flush=True)
    return traced


def profile_wave(scene, dev, label, res=1024, depth=5, table=True,
                 graph=True, draws=None):
    """Where a 1-spp wave's time goes, by kernel (profiled outside the
    launch counts): wall, device kernel time, busy share and each kernel's
    share, of the frame of one 1-spp wave replayed from its CUDA graph
    (graph=True) or run op by op (graph=False). The wave is rendered once
    before the trace (its capture), and the trace's first step renders it
    again and is discarded (the profiler loses the first launches after
    its trace starts). The kept step's device time counts where each of
    the wave's Threefry draws (`draws`, default 2 + depth a wave) was
    recorded once. Where not, a replayed wave's device time is its graph's
    alone by events behind a held stream (queued_events_ms); an eager
    wave is traced again, up to PROFILER_TRIES, and where no trace is
    complete its device time is None, not measured. The line names its
    source. Returns (wall ms, device ms or None, source)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    call = lambda: render(scene, res, res, spp=1, max_depth=depth, seed=1,
                          device=dev, graph=graph)
    call()
    torch.cuda.synchronize()
    if draws is None:
        draws = n_waves(res, res, 1, DEFAULT_CHUNK) * (2 + depth)
    for attempt in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
            prof.step()
        events = prof.key_averages()
        # device-side entries only: an aten op's self device time repeats
        # the time of the kernels it launched, and the step's annotation
        # spans them
        kernels = [e for e in events if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("ProfilerStep")]
        total = sum(_device_us(e) for e in kernels)
        seen = sum(e.count for e in kernels if "lane_keys_kernel" in e.key
                   or "uniforms_kernel" in e.key)
        if seen == draws:
            source = "profiler"
            break
        print(f"the profiler's trace {attempt + 1} of {PROFILER_TRIES} of "
              f"the {'replayed' if graph else 'eager'} wave recorded {seen} "
              f"of {draws} Threefry draws", flush=True)
        if graph:
            replay = next(reversed(graph_mod.CACHE.entries.values())).graph
            total = queued_events_ms(replay.replay, 1) * 1e3
            source = (f"events behind a held stream (the profiler recorded "
                      f"{seen} of {draws} Threefry draws)")
            break
    else:
        total = None
        source = (f"nothing: no trace of {PROFILER_TRIES} recorded the "
                  f"wave's {draws} Threefry draws")
    share = {name: sum(_device_us(e) for e in kernels
                       if any(k in e.key for k in keys))
             for name, keys in (("wide_bvh", WIDE_KERNELS),
                                ("sweep_bvh", ("sweep_bvh_kernel",)),
                                ("threefry", ("lane_keys_kernel",
                                              "uniforms_kernel")),
                                ("brute_hits", ("brute_hits_kernel",)))}
    mode = "replayed from its CUDA graph" if graph else "eager"
    if total is None:
        print(f"{label} profiled 1-spp wave ({mode}): wall "
              f"{prof_wall * 1e3:.1f} ms, device kernel time not measured "
              f"(measured by {source})", flush=True)
        return prof_wall * 1e3, None, source
    print(f"{label} profiled 1-spp wave ({mode}): wall "
          f"{prof_wall * 1e3:.1f} ms, device kernel time "
          f"{total / 1e3:.1f} ms by the {source} (busy "
          f"{total / 1e4 / prof_wall:.1f}%), "
          + ", ".join(f"{k} kernel {v / 1e3:.2f} ms "
                      f"({100 * v / max(total, 1):.1f}% of device time)"
                      for k, v in share.items()),
          flush=True)
    if table:
        print(events.table(sort_by="self_cuda_time_total", row_limit=12),
              flush=True)
    return prof_wall * 1e3, total / 1e3, source


def sort_effect(scene, dev, label, res=1024, depth=5):
    """The sweep's work on one 1-spp wave with sort_rays on (the default)
    and off, run on, off, off, on: group tests per packet that culled at
    least one instance, by cast class, and each run's wall time."""
    imgs, walls = {}, {True: [], False: []}
    for sort in (True, False):  # warm-up: captures each setting's wave
        render(scene, res, res, spp=1, max_depth=depth, seed=2, clamp=False,
               device=dev, with_stats=True, sort_rays=sort, graph=True)
    for sort in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, st = render(scene, res, res, spp=1, max_depth=depth, seed=2,
                         clamp=False, device=dev, with_stats=True,
                         sort_rays=sort)
        torch.cuda.synchronize()
        walls[sort].append(time.perf_counter() - t0)
        if sort in imgs:
            continue
        imgs[sort] = img
        parts = []
        for cls in ("closest", "shadow"):
            p, c, t = (st.get(f"sweep_{cls}_{k}", 0)
                       for k in ("packets", "culls", "tests"))
            parts.append(f"{cls}: {t} group tests, {p} live packets, {c} "
                         f"instance culls, {t / max(p, 1):.2f} tests per "
                         "live packet")
        print(f"{label} 1-spp wave, sort_rays={'on' if sort else 'off'}: "
              f"{st['rays']} rays; " + "; ".join(parts), flush=True)
    if not torch.equal(imgs[True], imgs[False]):
        diff = float((imgs[True] - imgs[False]).abs().max())
        raise AssertionError(f"{label}: sort_rays on and off give different "
                             f"images (max |diff| {diff})")
    print(f"{label} 1-spp wave wall (on, off, off, on order): sort on "
          f"{walls[True][0]:.3f} / {walls[True][1]:.3f} s, sort off "
          f"{walls[False][0]:.3f} / {walls[False][1]:.3f} s; images "
          "bit-identical (asserted)", flush=True)


# --------------------------------------------------------------------------
# 5. goldens (gates of tests/test_golden.py)
# --------------------------------------------------------------------------

def goldens(bunny, dev):
    ref = np.load(os.path.join(GOLDEN, "bunny_self_64.npz"))["img"]
    img = render(bunny, 64, 64, spp=32, seed=9, max_depth=5,
                 device=dev, graph=True).cpu().numpy()
    if not np.isfinite(img).all():
        raise AssertionError("bunny golden render is not finite")
    top = img[:8].mean(axis=(0, 1))
    if not top[2] > top[0]:
        raise AssertionError(f"bunny sky is not blue-dominant: {top}")
    if not (img.mean(-1) < 0.5 * img[:4].mean()).sum() > 20:
        raise AssertionError("bunny silhouettes missing")
    g8 = ref.reshape(8, 8, 8, 8, 3).mean((1, 3))
    i8 = img.reshape(8, 8, 8, 8, 3).mean((1, 3))
    scale = ref.mean()
    worst = float((np.abs(i8 - g8) / scale).max())
    if (np.abs(i8 - g8) > np.maximum(0.25 * g8, 0.25 * scale)).any():
        raise AssertionError(f"bunny region gate failed, worst {worst}")
    energy = abs(img.mean() - ref.mean()) / ref.mean()
    if not energy < 0.05:
        raise AssertionError(f"bunny energy gate failed: {energy}")
    print(f"bunny 64^2 32 spp vs golden: region worst {worst:.4f} of scale, "
          f"energy {energy:.4f} (gates 0.25 / 0.05)", flush=True)

    ref = np.load(os.path.join(GOLDEN, "cornell_self_48.npz"))["img"]
    img = render(cornell_box(), 48, 48, spp=512, seed=7, max_depth=5,
                 device=dev, graph=True).cpu().numpy()
    if not np.isfinite(img).all():
        raise AssertionError("cornell golden render is not finite")
    scale = ref.mean()
    mae = float(np.abs(img - ref).mean() / scale)
    g8 = ref.reshape(6, 8, 6, 8, 3).mean((1, 3))
    i8 = img.reshape(6, 8, 6, 8, 3).mean((1, 3))
    worst = float((np.abs(i8 - g8) / scale).max())
    energy = abs(img.mean() - ref.mean()) / ref.mean()
    if not mae < 0.05:
        raise AssertionError(f"cornell MAE gate failed: {mae}")
    if (np.abs(i8 - g8) > np.maximum(0.12 * g8, 0.12 * scale)).any():
        raise AssertionError(f"cornell region gate failed, worst {worst}")
    if not energy < 0.02:
        raise AssertionError(f"cornell energy gate failed: {energy}")
    print(f"cornell 48^2 512 spp vs golden: MAE {mae:.4f}, region worst "
          f"{worst:.4f}, energy {energy:.4f} (gates 0.05 / 0.12 / 0.02)",
          flush=True)

    ref = np.load(os.path.join(GOLDEN, "cornell_smoke_16.npz"))["img"]
    img = render(cornell_box(), 16, 16, spp=8, seed=42, max_depth=5,
                 device=dev, graph=True).cpu().numpy()
    off = ~np.all(np.isclose(img, ref, rtol=1e-4, atol=1e-5), axis=-1)
    rel = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
    print(f"cornell 16^2 8 spp seed 42 vs the exact-seed golden: "
          f"{int(off.sum())} of {off.size} pixels outside rtol 1e-4 / atol "
          f"1e-5 ({100 * off.mean():.1f}%; gate {100 * EXACT_SEED_MAX_OFF:.0f}"
          f"%), at (y, x) {[tuple(int(v) for v in p) for p in np.argwhere(off)]}"
          f", max |diff| {float(np.abs(img - ref).max()):.6f}; mean relative "
          f"difference {rel:.2e} (gate 1e-3)", flush=True)
    if not np.isfinite(img).all() or off.mean() > EXACT_SEED_MAX_OFF \
            or rel > 1e-3:
        raise AssertionError("cornell exact-seed golden gate failed")


# --------------------------------------------------------------------------
# 6-8. the sweep route
# --------------------------------------------------------------------------

def dense_obj(target: int) -> str:
    """assets/bunny_<target>.obj through scenes.bunny_obj (generated at
    first use, never committed), with the time it took."""
    t0 = time.perf_counter()
    path = bunny_obj(target)
    print(f"{os.path.basename(path)} ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return path


def build_sweep_scene(label, dev, **kw):
    t0 = time.perf_counter()
    scene = bunny_scene(**kw)
    secs = time.perf_counter() - t0
    m = scene.meta
    rows = m.n_blas_tris[0] if m.n_inst else m.n_bvh_tris
    groups = m.n_groups_blas[0] if m.n_inst else m.n_groups_bvh
    print(f"{label} built in {secs:.2f} s: {m.n_tri} soup triangles, "
          f"instances {m.n_inst}, {rows} sweep rows in {groups} groups, "
          f"routing wide_bvh={m.wide_bvh} wide_blas={m.wide_blas} "
          f"pallas_bvh={m.pallas_bvh} pallas_blas={m.pallas_blas}",
          flush=True)
    if m.wide_bvh or any(m.wide_blas) or not (m.pallas_bvh
                                              or any(m.pallas_blas)):
        raise AssertionError(f"{label} is not routed to the sweep alone")
    return scene.to(dev), secs


def prims(dev):
    """The primitives harness through its entry point (held against its
    numpy oracle bit for bit), then the kernel against its plain version
    and the oracle, bit for bit, on the harness's inputs, on seeds 1-3 and
    on keys with ties across the window edges (sweep_prims.inputs); the
    kernel timed on the harness's inputs (kernel_times)."""
    sweep_prims.sweep_prims.launches = 0
    err_oracle = sweep_prims.main("cuda")
    launches = sweep_prims.sweep_prims.launches
    if launches < 1:
        raise AssertionError("the harness never launched the kernel")
    err = 0.0
    for seed, ties in PRIMS_INPUTS:
        an, bn = sweep_prims.inputs(seed, ties)
        a, b = (torch.from_numpy(x).to(dev) for x in (an, bn))
        k = sweep_prims.sweep_prims(a, b)
        p = sweep_prims.sweep_prims_plain(a, b)
        err = max(err, float((k - p).abs().max()))
        if not (torch.equal(k, p) and np.array_equal(
                k.cpu().numpy(), sweep_prims.oracle(an, bn))):
            raise AssertionError(f"sweep_prims seed {seed} ties {ties}: "
                                 f"kernel, plain and oracle differ ({err})")
    a, b = (torch.from_numpy(x).to(dev) for x in sweep_prims.inputs(0))
    t = kernel_times(lambda: sweep_prims.sweep_prims(a, b),
                     ("sweep_prims_kernel",), 100)
    t["plain_ms"] = time_ms(lambda: sweep_prims.sweep_prims_plain(a, b),
                            100)[0]
    # a, b read once, out written once; the rank-4 product's multiply-adds,
    # the add of s to every element, the 3 x 7 window minima and 2 adds
    t["bound"] = bound(a.nbytes + b.nbytes + 128 * 128 * 4,
                       128 * 128 * 4 * 2 + 128 * 128 + 3 * 7 + 2)
    print(f"sweep_prims: oracle max error {err_oracle:.3g}; kernel, plain "
          "and oracle equal bit for bit on 6 inputs (seeds 0-3, two with "
          "tied keys across the window edges); " + times_line(t)
          + f"; harness launches {launches}", flush=True)
    t.update(launches=launches, err=err)
    return t


def probes(dev):
    """The wide kernel's primitive probes through their entry point (all
    11, timed at REPS, with the exact launch count); the output of each
    probe's timed launches held against its plain version at REPS, bit
    for bit, and the plain version timed there."""
    reps = prim_micro.REPS
    prim_micro.prim_micro.launches = 0
    ns, outs = prim_micro.main(prim_micro.PROBES, "cuda")
    launches = prim_micro.prim_micro.launches
    expected = len(prim_micro.PROBES) * (1 + prim_micro.RUNS)
    if launches != expected:
        raise AssertionError(f"prim_micro launches {launches}, the entry "
                             f"point's runs imply {expected}")
    tables = prim_micro.tables(dev)
    out_bytes = outs[prim_micro.PROBES[0]].nbytes
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    err, bounds = 0.0, []
    for probe in prim_micro.PROBES:
        t, k = tables[prim_micro.TABLE_OF[probe]], outs[probe]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = prim_micro.prim_micro_plain(probe, t, reps)
        torch.cuda.synchronize()
        ms_p = (time.perf_counter() - t0) * 1e3
        # inf == inf (mt) is no error
        e = float(torch.where(k == p, 0.0, (k - p).abs()).max())
        if not torch.equal(k, p):
            raise AssertionError(f"prim_micro {probe}: kernel {float(k[0, 0, 0])}"
                                 f" != plain {float(p[0, 0, 0])}, max error {e}")
        if not bool(torch.isinf(k).all() if probe == "mt"
                    else torch.isfinite(k).all()):
            raise AssertionError(f"prim_micro {probe}: value "
                                 f"{float(k[0, 0, 0])}")
        ms_k = ns[probe] * reps * 1e-6
        if probe == "srt":   # integer work: its SASS loop body per rep
            work = sass_work(sass_function(
                "prim_micro",
                f"prim_micro_kernelILi{prim_micro.PROBES.index(probe)}EE"))
            ms_b, by = bound(t.nbytes + out_bytes, 0,
                             tuple(w * reps for w in work))
            print("prim_micro srt SASS per rep (ALU-pipe / FMA-heavy-pipe / "
                  "all instructions): " + " / ".join(f"{w:.0f}" for w in work),
                  flush=True)
        else:
            ms_b, by = bound(t.nbytes + out_bytes, PROBE_OPS[probe] * reps)
        err = max(err, e)
        bounds.append((ms_b, by))
        total["ms"] += ms_k
        total["plain_ms"] += ms_p
        total["bound_ms"] += ms_b
        print(f"prim_micro {probe}: {ns[probe]:.1f} ns/iter, at REPS {reps} "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.2f} ms, bound {ms_b:.6f} ms "
              f"({by}), equal bit for bit (value {float(k[0, 0, 0])!r})",
              flush=True)
    print(f"prim_micro: entry-point launches {launches} (expected "
          f"{expected})", flush=True)
    # the sum's binding resource is that of its largest term
    return launches, ns, total, max(bounds)[1], err


# --------------------------------------------------------------------------
# 10. the command line
# --------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """A written BMP, PPM or HDR file back as float32 [H, W, 3] (the BMP's
    and PPM's gamma undone, the HDR's RGBE decoded)."""
    if path.endswith(".ppm"):
        return image_io.read_ppm(path)
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".bmp"):
        w, h = (int(x) for x in np.frombuffer(data[18:26], "<i4"))
        rows = np.frombuffer(data[54:], np.uint8).reshape(h, -1)
        u8 = rows[::-1, :w * 3].reshape(h, w, 3)[..., ::-1]
        return np.power(u8 / 255.0, 2.2).astype(np.float32)
    head = data.index(b"+X")
    dims = data[data.rindex(b"\n", 0, head) + 1:data.index(b"\n", head)]
    h, w = int(dims.split()[1]), int(dims.split()[3])
    rgbe = np.frombuffer(data[data.index(b"\n", head) + 1:], np.uint8)
    rgbe = rgbe.reshape(h, w, 4).astype(np.float64)
    scale = np.where(rgbe[..., 3] > 0, np.ldexp(1.0, rgbe[..., 3].astype(int)
                                                - 136), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def cli_phase(dev, res=1024, small=256):
    """The bunny CLI at res^2 in a subprocess against render(graph=True) +
    write_bmp here (the CLI's frame of four waves, one per sample, runs op
    by op: a wave shape is captured after graph.CAPTURE_AFTER eager
    calls), Cornell small^2 through cli.main under each option, and a
    resumed render through graphed waves. Returns the bunny CLI's wall
    time in s. (On the CPU, a rehearsal, both pass --device cpu and run
    eagerly.)"""
    where = [] if dev.type == "cuda" else ["--device", dev.type]
    graph = True if dev.type == "cuda" else None
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "bunny")
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "jet_pbrt_tpu_torch.cli", "1", "4",
             "--size", str(res), "--out", base] + where, cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"the CLI exited {proc.returncode}")
        with open(base + ".bmp", "rb") as f:
            got = f.read()
        img = render(bunny_scene(), res, res, 4, seed=0, device=dev,
                     graph=graph)
        image_io.write_bmp(os.path.join(tmp, "here.bmp"), img.cpu().numpy())
        with open(os.path.join(tmp, "here.bmp"), "rb") as f:
            want = f.read()
        if got != want:
            n = min(len(got), len(want))
            diff = int(np.count_nonzero(np.frombuffer(got[:n], np.uint8)
                                        != np.frombuffer(want[:n], np.uint8)))
            raise AssertionError(f"CLI BMP differs from render() + write_bmp "
                                 f"in {diff} bytes (sizes {len(got)}, "
                                 f"{len(want)})")
        print(f"cli 1 4 --size {res}: exit 0 in {wall:.2f} s (process start, "
              f"scene build and render); its BMP ({len(got)} bytes) equals "
              f"write_bmp(render(bunny_scene(), {res}, {res}, 4, seed=0, "
              f"graph={graph})) byte for byte", flush=True)

        for flags in (["--integrator", "whitted"], ["--integrator", "debug"],
                      ["--sampler", "stratified"], ["--mis"],
                      ["--format", "ppm"], ["--format", "hdr"]):
            out = os.path.join(tmp, "cornell")
            t0 = time.perf_counter()
            rc = cli.main(["0", "4", "--size", str(small), "--out", out]
                          + flags + where)
            secs = time.perf_counter() - t0
            fmt = flags[1] if flags[0] == "--format" else "bmp"
            back = read_image(f"{out}.{fmt}")
            if rc != 0 or back.shape != (small, small, 3) \
                    or not np.isfinite(back).all() or not back.mean() > 0.01:
                raise AssertionError(f"cli 0 4 --size {small} {flags}: exit "
                                     f"{rc}, image {back.shape} mean "
                                     f"{back.mean()}")
            print(f"cli 0 4 --size {small} {' '.join(flags)}: {secs:.3f} s, file "
                  f"read back finite, mean {float(back.mean()):.5f}",
                  flush=True)

        scene = cornell_box()
        ck = os.path.join(tmp, "resume.npz")
        whole = checkpoint.render_resumable(scene, small, small, 4,
                                            os.path.join(tmp, "whole.npz"),
                                            device=dev, graph=graph)
        checkpoint.render_resumable(scene, small, small, 2, ck, device=dev,
                                    graph=graph)
        resumed = checkpoint.render_resumable(scene, small, small, 4, ck,
                                              device=dev, graph=graph)
        if not torch.equal(resumed, whole):
            raise AssertionError("the resumed render differs from the "
                                 "uninterrupted one")
        same = torch.equal(whole, render(scene, small, small, 4, device=dev))
        print(f"render_resumable Cornell {small}^2 4 spp (graph={graph}), "
              "stopped after 2 samples "
              "and resumed: equal to the uninterrupted run bit for bit "
              f"(asserted); equal to render(): {same}", flush=True)
    return wall


# --------------------------------------------------------------------------
# 11. the differentiable path
# --------------------------------------------------------------------------

def mean64(fn, pack):
    """f(params): the mean pixel of fn(pack with params), summed in
    float64 so the finite differences see no float32 rounding of the sum."""
    return lambda p: fn(dparams.with_params(pack, p)).double().mean()


def fwd_bwd(fn, pack, fields, loss):
    """One forward and one backward of loss(image) over the fields, each
    timed by the host clock to torch.cuda.synchronize(): (image, grads,
    forward ms, backward ms, forward launches, backward launches, peak
    bytes above what was allocated before)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in dparams.get_params(pack, fields).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    img = fn(dparams.with_params(pack, leaves))
    val = loss(img)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = launch_counts()
    reset_launches()
    grads = torch.autograd.grad(val, list(leaves.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bwd = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    return (img.detach(), dict(zip(fields, grads)), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3, fwd, bwd, peak)


@contextlib.contextmanager
def plain_calls(out: list):
    """While open, each call of shade_vertex_plain or nee_accumulate_plain
    appends its name to `out` (the kernel route on the card calls
    neither)."""
    saved = {name: getattr(shade_ops, name) for name in (
        "shade_vertex_plain", "nee_accumulate_plain")}
    for name, inner in saved.items():
        def call(*a, _inner=inner, _name=name, **kw):
            out.append(_name)
            return _inner(*a, **kw)
        setattr(shade_ops, name, call)
    try:
        yield out
    finally:
        for name, inner in saved.items():
            setattr(shade_ops, name, inner)


@contextlib.contextmanager
def plain_grad():
    """While open, a pack with a field on the tape takes li_path's plain
    route (integrators._li_path_plain: the plain vertex and the torch glue,
    differentiated by autograd op by op, the gradient's route before the
    backward kernels): shade.kernel_route refuses any gradient. A
    measurement of this script only; the port never takes it."""
    inner = shade_ops.kernel_route

    def route(meta, pack, *tensors, nee, mis):
        return inner(meta, pack, *tensors, nee=nee, mis=mis) and not any(
            x.requires_grad for _, x in shade_ops._pack_tensors(pack))

    shade_ops.kernel_route = route
    try:
        yield
    finally:
        shade_ops.kernel_route = inner


def profile_backward(fn, pack, fields, loss, label):
    """Where one backward of loss(fn(pack)) over the fields spends its
    time, by the profiler: two tapes made first (their forwards outside
    the trace), a warm-up backward of the first (the profiler loses a
    trace's first launches), then the measured backward of the second in
    a range of its own: its wall, and every device operation that starts
    after the range does, by name with its device time and count (device
    kernel time, busy share)."""
    from torch.profiler import ProfilerActivity, profile
    tapes = []
    for _ in range(2):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in dparams.get_params(pack, fields).items()}
        tapes.append((loss(fn(dparams.with_params(pack, leaves))), leaves))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        torch.autograd.grad(tapes[0][0], list(tapes[0][1].values()))
        torch.cuda.synchronize()
        with torch.profiler.record_function("chip_smoke.measured_backward"):
            t0 = time.perf_counter()
            torch.autograd.grad(tapes[1][0], list(tapes[1][1].values()))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    # the range's host record (and its annotation on the device's timeline)
    start = min(e.time_range.start for e in events
                if e.name == "chip_smoke.measured_backward")
    ops = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if str(e.device_type).endswith("CUDA") and e.time_range.start >= start \
                and e.name != "chip_smoke.measured_backward":
            ops[e.name[:70]][0] += e.time_range.elapsed_us() / 1e3
            ops[e.name[:70]][1] += 1
    total = sum(ms for ms, _ in ops.values())
    every = sorted(ops.items(), key=lambda kv: -kv[1][0])
    print(f"{label} profiled backward: wall {wall * 1e3:.1f} ms, device "
          f"kernel time {total:.2f} ms (busy {100 * total / 1e3 / wall:.1f}%); "
          f"every device operation by device time ({len(every)}): " + "; ".join(
              f"{name} {ms:.3f} ms x {count}" for name, (ms, count) in every),
          flush=True)
    return wall * 1e3, total, dict(every)


def grad_scene(texture: str):
    """tests/test_grad.py's textured scene: a matte floor whose Kd is a 2x2
    bilinear image, under an area light; or its checker variant, the
    floor's Kd a 3D sine checker of scale 4, the floor raised to y = 0.25
    so that the checker's sin(4 y) has a sign."""
    b = SceneBuilder(f"grad-{texture}")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    if texture == "image":
        tex = b.add_image_texture(
            np.asarray([[[0.7, 0.3, 0.2], [0.3, 0.7, 0.2]],
                        [[0.2, 0.3, 0.7], [0.5, 0.5, 0.5]]], np.float32),
            bilinear=True)
    else:
        tex = b.add_checker_texture((0.7, 0.3, 0.2), (0.2, 0.3, 0.7), 4.0)
    b.add_rect_xz(-10, 10, -10, 10, 0.0 if texture == "image" else 0.25,
                  b.add_matte((1.0, 1.0, 1.0), tex=tex))
    light = b.add_rect_xz(-1, 1, -1, 1, 3, b.add_matte((0.6, 0.6, 0.6)),
                          flip_normal=True)
    b.add_area_light(light, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


def fd_line(label, g_auto, g_fd, rtol, secs):
    """check_grads' result in one line: the largest relative difference of
    the elements it holds (above its atol on either side)."""
    worst = 0.0
    for k, b in g_fd.items():
        a = g_auto[k].detach().cpu().numpy().astype(np.float64)
        held = (np.abs(a) > 1e-4) | (np.abs(b) > 1e-4)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4 / rtol)
        worst = max(worst, float(rel[held].max(initial=0.0)))
        print(f"{label} {k}: autograd {np.round(a.ravel(), 6).tolist()}, "
              f"finite differences {np.round(b.ravel(), 6).tolist()}",
              flush=True)
    print(f"{label}: agree within rtol {rtol} (largest relative difference "
          f"{worst:.2e}) in {secs:.2f} s", flush=True)
    return worst


def node_launches(nodes: dict) -> dict:
    """A graph's kernel nodes by registered device function, per kernel as
    launch_counts() names them."""
    return {"wide_bvh": nodes["wide_walk_kernel"],
            "sweep_bvh": nodes["sweep_bvh_kernel"],
            "threefry": nodes["lane_keys_kernel"] + nodes["uniforms_kernel"],
            "shade_vertex": nodes["shade_vertex_kernel"],
            "nee_accumulate": nodes["nee_accumulate_kernel"],
            "brute_hits": nodes["brute_hits_kernel"],
            **{name: nodes[f"{name}_kernel"] for name in RAYS + WAVE + GRAD}}


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def spread_check(label, got: dict, eager: list) -> dict:
    """A graphed gradient held to the eager ones of the same loss, taken in
    this run (atomic adds reorder their sums, so two eager gradients
    differ): its distance to the nearest eager gradient (largest absolute
    difference of an element) must not exceed the largest distance between
    two eager ones; both printed, with the first two eager gradients'
    distance."""
    spread = max(max_diff(a, b) for i, a in enumerate(eager)
                 for b in eager[i + 1:])
    near = min(max_diff(got, e) for e in eager)
    print(f"{label}: the graphed gradient lies {near:.3e} from the nearest of "
          f"{len(eager)} eager gradients, which lie up to {spread:.3e} apart "
          f"(the first two {max_diff(eager[0], eager[1]):.3e}); largest "
          f"element {max(float(v.abs().max()) for v in got.values()):.3e}",
          flush=True)
    if near > spread:
        raise AssertionError(f"{label}: the graphed gradient lies outside the "
                             f"eager gradients' spread ({near} > {spread})")
    return {"nearest": near, "spread": spread,
            "spread_first_two": max_diff(eager[0], eager[1])}


def device_ms(fn) -> tuple:
    """(device ms per call of fn, its source, the host wall per call of the
    same calls in ms) over 3 calls, by profiled_ms (every operation; each
    call's lane-key draw recorded)."""
    walls = []
    (source, ms), = profiled_ms(fn, 3, ("",), each=("lane_keys_kernel",),
                                walls=walls).items()
    return ms, "profiler" if source == "" else source, walls[-1]


def graphed_value_and_grad(fn, pack, target, fields, eager: list,
                           want: dict, smi: str) -> dict:
    """compile_value_and_grad of mean((fn(pack with params) - target)^2)
    over `fields` against diff.params.value_and_grad: the capturing call
    (GRAD_WARMUPS eager warm-ups counted, its seconds, the warm-ups' and
    the capture's, the pool's bytes), the graph's kernel nodes equal to
    one eager forward's launches `want` (so its backward adds none), a
    replay's loss bit for bit with eager's and its gradient within the
    eager gradients' spread (spread_check over `eager`, the phase's runs,
    and one more) and, the backward kernels' sums being in a fixed order,
    bit for bit with eager's for every field; wall in GRAPH_TURNS after a
    warm-up each, device time and busy share of each, peak memory of a
    call; then under deterministic() the replay's gradient bit for bit
    with eager's. `want`: one eager forward and backward's launches, which
    the graph's kernel nodes must equal. Returns a summary dict."""
    f = dparams.loss_fn(fn, pack, target)
    params = dparams.get_params(pack, fields)
    graph_mod.clear()
    vg = dparams.compile_value_and_grad(f)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vg(params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm = launch_counts()
    (entry,) = graph_mod.GRAD_CACHE.entries.values()
    nodes = node_launches(entry.launches)
    if nodes != want or warm != {k: graph_mod.GRAD_WARMUPS * v
                                 for k, v in want.items()}:
        raise AssertionError(f"the gradient graph's kernel nodes {nodes}, "
                             f"its warm-ups' launches {warm}; one forward "
                             f"and backward launch {want}")
    val, g = vg(params)
    val, g = val.clone(), {k: v.clone() for k, v in g.items()}
    loss_e, g_e = dparams.value_and_grad(f, params)
    if not torch.equal(val, loss_e):
        raise AssertionError(f"the graphed loss {float(val)} differs from "
                             f"eager {float(loss_e)}")
    spread = spread_check(f"bunny value_and_grad [{smi}]", g,
                          eager + [g_e])
    if not all(torch.equal(g[k], g_e[k]) for k in g_e):
        raise AssertionError(f"the graphed gradient differs from eager's "
                             f"(largest difference {max_diff(g, g_e)}); the "
                             "backward kernels sum in a fixed order")
    walls = {True: [], False: []}
    call = {True: lambda: vg(params),
            False: lambda: dparams.value_and_grad(f, params)}
    for graph in (True, False) + GRAPH_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call[graph]()
        torch.cuda.synchronize()
        walls[graph].append(time.perf_counter() - t0)
    med = {k: float(np.median(v[1:])) * 1e3 for k, v in walls.items()}
    dev_ms = {k: device_ms(call[k]) for k in (True, False)}
    peaks = {}
    for graph in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call[graph]()
        torch.cuda.synchronize()
        peaks[graph] = torch.cuda.max_memory_allocated() - base
    out = {"first_call_s": first_s, "warmup_s": entry.warmup_s,
           "capture_s": entry.capture_s, "pool_bytes": entry.pool_bytes,
           "nodes": nodes, "loss": float(val), **spread,
           "wall_ms": {"graphed": walls[True][1:], "eager": walls[False][1:]},
           "median_ms": {"graphed": med[True], "eager": med[False]},
           "device_ms": {"graphed": dev_ms[True][0], "eager": dev_ms[False][0]},
           "device_source": {"graphed": dev_ms[True][1],
                             "eager": dev_ms[False][1]},
           "profiled_wall_ms": {"graphed": dev_ms[True][2],
                                "eager": dev_ms[False][2]},
           "peak_bytes": {"graphed": peaks[True], "eager": peaks[False]}}
    vg.release()
    print(f"bunny value_and_grad over {fields}, graphed (one CUDA graph of "
          f"forward and backward, compile_value_and_grad): the capturing "
          f"call {first_s:.3f} s ({graph_mod.GRAD_WARMUPS} warm-ups "
          f"{entry.warmup_s:.3f} s, capture {entry.capture_s:.3f} s), pool "
          f"{entry.pool_bytes} bytes; kernel nodes {nodes} (one forward's "
          f"and one backward's launches); loss {float(val)} and gradient "
          f"equal to eager's bit for bit; wall in turns after a warm-up "
          f"each, graphed "
          f"{[round(x * 1e3, 1) for x in walls[True][1:]]} ms, eager "
          f"{[round(x * 1e3, 1) for x in walls[False][1:]]} ms, medians "
          f"{med[True]:.1f} / {med[False]:.1f} ms; under the profiler, "
          f"graphed {dev_ms[True][0]:.1f} ms of device time by the "
          f"{dev_ms[True][1]} in {dev_ms[True][2]:.1f} ms of wall (busy "
          f"{100 * dev_ms[True][0] / dev_ms[True][2]:.1f}%), eager "
          f"{dev_ms[False][0]:.1f} ms by the {dev_ms[False][1]} in "
          f"{dev_ms[False][2]:.1f} ms (busy "
          f"{100 * dev_ms[False][0] / dev_ms[False][2]:.1f}%); peak memory of a "
          f"call graphed {peaks[True]} bytes, eager {peaks[False]} bytes "
          f"[{smi}]", flush=True)

    with deterministic():
        t0 = time.perf_counter()
        loss_d, g_d = dparams.value_and_grad(f, params)
        vg = dparams.compile_value_and_grad(f)
        vg(params)
        val, g = vg(params)
        torch.cuda.synchronize()
        if not (torch.equal(val, loss_d)
                and all(torch.equal(g[k], g_d[k]) for k in g_d)):
            raise AssertionError(f"under deterministic algorithms the graphed "
                                 f"value_and_grad differs from eager's (loss "
                                 f"{float(val)} / {float(loss_d)}, largest "
                                 f"difference {max_diff(g, g_d)})")
        vg.release()
    out["deterministic_s"] = time.perf_counter() - t0
    print(f"bunny value_and_grad under deterministic algorithms: the graphed "
          f"loss and gradient equal eager's bit for bit (eager, capture and "
          f"replay {out['deterministic_s']:.1f} s) [{smi}]", flush=True)
    return out


@contextlib.contextmanager
def timed_fit(out: dict):
    """While open, a fit's steps are timed: each call of its value and
    gradient (diff.params.value_and_grad, or a compile_value_and_grad
    function's) first synchronizes the card and appends the host time to
    out["marks"], and the first graphed call records its capture (warm-up
    and capture s, pool bytes) in out["capture"] before the fit releases
    it. A measurement of this script only."""
    eager_vg = dparams.value_and_grad
    compile_vg = dparams.compile_value_and_grad
    marks = out.setdefault("marks", [])

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def timed_eager(f, params):
        mark()
        return eager_vg(f, params)

    def timed_compile(f, *a, **kw):
        vg = compile_vg(f, *a, **kw)

        def call(params):
            mark()
            got = vg(params)
            if "capture" not in out:
                e = next(reversed(graph_mod.GRAD_CACHE.entries.values()))
                out["capture"] = {"warmup_s": e.warmup_s,
                                  "capture_s": e.capture_s,
                                  "pool_bytes": e.pool_bytes}
            return got

        call.release = vg.release
        return call

    dparams.value_and_grad = timed_eager
    dparams.compile_value_and_grad = timed_compile
    try:
        yield out
        mark()
    finally:
        dparams.value_and_grad = eager_vg
        dparams.compile_value_and_grad = compile_vg


def graphed_fits(fn, pack, target, smi: str) -> dict:
    """fit of mat_c0 towards target at lr FIT_LR, FIT_STEPS steps, in
    FIT_TURNS: on the default (graph=None) a fit of that many steps
    captures its value and gradient at its first step and replays the
    rest; graph=False runs them eagerly. Every fit's first loss equal bit
    for bit (the forward is), its first three falling; ms per step, the
    graphed fits' capture step apart. Then under deterministic() a
    DETERMINISTIC_FIT_STEPS-step fit with graph=True and one with
    graph=False: losses and params bit for bit. Returns a summary dict."""
    runs = []
    for graph in FIT_TURNS:
        with timed_fit({}) as t:
            params, losses = dparams.fit(fn, pack, target, fields=("mat_c0",),
                                         steps=FIT_STEPS, lr=FIT_LR,
                                         graph=graph)
        ms = [(b - a) * 1e3 for a, b in zip(t["marks"], t["marks"][1:])]
        runs.append({"graphed": graph is None, "losses": losses,
                     "step_ms": ms, "capture": t.get("capture"),
                     "albedo": params["mat_c0"][0].tolist()})
        if not losses[2] < losses[1] < losses[0]:
            raise AssertionError(f"the fit's loss does not fall: {losses}")
        if (graph is None) != ("capture" in t):
            raise AssertionError(f"fit(graph={graph}) of {FIT_STEPS} steps "
                                 f"took the wrong route")
    if len({r["losses"][0] for r in runs}) != 1:
        raise AssertionError(f"the fits' first losses differ: {runs}")
    per = {g: [x for r in runs if r["graphed"] == g
               for x in r["step_ms"][int(g):]] for g in (True, False)}
    med = {g: float(np.median(v)) for g, v in per.items()}
    for r in runs:
        print(f"bunny fit of mat_c0 from red albedo (0.9, 0.1, 0.7), lr "
              f"{FIT_LR}, {FIT_STEPS} steps, "
              f"{'graphed' if r['graphed'] else 'eager'}: losses "
              f"{r['losses']}, ms per step "
              f"{[round(x, 1) for x in r['step_ms']]}"
              + (f" (the first the capture: warm-ups "
                 f"{r['capture']['warmup_s']:.3f} s, capture "
                 f"{r['capture']['capture_s']:.3f} s, pool "
                 f"{r['capture']['pool_bytes']} bytes)" if r["graphed"]
                 else "") + f", red albedo now {r['albedo']} [{smi}]",
              flush=True)
    print(f"bunny fit, in turns {FIT_TURNS}: median ms per step graphed "
          f"{med[True]:.1f} (replays), eager {med[False]:.1f}; first losses "
          f"equal bit for bit [{smi}]", flush=True)
    with deterministic():
        t0 = time.perf_counter()
        got = {g: dparams.fit(fn, pack, target, fields=("mat_c0",),
                              steps=DETERMINISTIC_FIT_STEPS, lr=FIT_LR,
                              graph=g) for g in (True, False)}
    (pg, lg), (pe, le) = got[True], got[False]
    if lg != le or not torch.equal(pg["mat_c0"], pe["mat_c0"]):
        raise AssertionError(f"under deterministic algorithms the graphed fit "
                             f"differs from the eager one: {lg} / {le}")
    det_s = time.perf_counter() - t0
    print(f"bunny fit under deterministic algorithms, "
          f"{DETERMINISTIC_FIT_STEPS} steps graph=True and graph=False: "
          f"losses {lg} and params equal bit for bit ({det_s:.1f} s) "
          f"[{smi}]", flush=True)
    return {"runs": runs, "median_step_ms": {"graphed": med[True],
                                             "eager": med[False]},
            "deterministic_losses": lg, "deterministic_s": det_s}


GRAD_TURNS = ("kernels", "plain", "plain", "kernels")


def diff_phase(dev, smi: str, res: int = 1024):
    """render_fn on the default bunny (wide route) at res^2, 1 spp, depth 5:
    its image equal to render(clamp=False) bit for bit; the forward of the
    loss mean((img - target)^2) over mat_c0 and light_c (target: light_c x
    1.2) launching one fused wave's kernels (expected_launches: 16 wide, 16
    brute_hits, 7 Threefry, 6 shade_vertex, 5 nee_accumulate, the rays and
    wave glue) and its backward exactly grad_launches' backward kernels
    (6 vertex_backward, 6 grad_reduce, 3 permute_state_backward, 1
    unsort_guard_backward) and no other port kernel, no call of the plain
    vertex (plain_calls), forward and backward ms, their ratio and the
    tape's peak memory (two runs); finite
    gradients, the red bunny's albedo row non-zero; the backward profiled
    (every device operation listed); in GRAD_TURNS with the plain route
    (plain_grad: the plain vertex and glue under autograd, no shade_vertex,
    permute or backward kernel) forward and backward ms and peak memory,
    each plain gradient within GRAD_FIELD_TOL of the kernels' for each
    field; check_grads for light_c at depth 5 (rtol 1e-2) and mat_c0[0]
    at depth 2 (no roulette, rtol 5e-2); the same loss's value and
    gradient graphed (graphed_value_and_grad: loss and gradient bit for
    bit, also under deterministic algorithms; kernel nodes, times,
    capture, pool); fits of mat_c0 from a wrong red albedo, graphed and
    eager in turns (graphed_fits); then texture_grads. Returns a summary
    dict."""
    scene = bunny_scene()
    fn, pack = render_fn(scene, res, res, spp=1, seed=0, max_depth=5,
                         device=dev)
    with torch.no_grad():
        target = fn(dparams.with_params(
            pack, {"light_c": pack.light_c * 1.2}))
    ref = render(scene, res, res, spp=1, seed=0, max_depth=5, clamp=False,
                 device=dev, graph=True)
    loss = lambda img: torch.mean((img - target) ** 2)
    fields = ("mat_c0", "light_c")
    out = {"runs": []}
    want = expected_launches(scene.meta, res, 1, 5)
    want_bwd = {**dict.fromkeys(want, 0), **grad_launches(scene.meta, 1, 5)}
    # the plain route: no fused vertex, glue or backward kernel
    want_plain = expected_launches(scene.meta, res, 1, 5, fused=False)
    eager = []      # the eager gradients of the loss
    for run in range(2):
        with plain_calls([]) as plain:
            img, g, f_ms, b_ms, fwd, bwd, peak = fwd_bwd(fn, pack, fields,
                                                         loss)
        eager.append(g)
        if fwd != want or bwd != want_bwd or plain:
            raise AssertionError(f"render_fn launches: forward {fwd} (expected "
                                 f"{want}), backward {bwd} (expected "
                                 f"{want_bwd}); plain vertex calls {plain} "
                                 "(expected none)")
        if not torch.equal(img, ref):
            diff = float((img - ref).abs().max())
            raise AssertionError(f"render_fn differs from render(clamp=False) "
                                 f"(max |diff| {diff})")
        if not all(bool(torch.isfinite(x).all()) for x in g.values()) \
                or not bool((g["mat_c0"][0] != 0).any()):
            raise AssertionError(f"bunny gradients: {g}")
        if not all(torch.equal(g[k], eager[0][k]) for k in g):
            raise AssertionError(f"bunny run {run + 1}'s gradient differs "
                                 f"from run 1's (largest difference "
                                 f"{max_diff(g, eager[0])}): the backward "
                                 "kernels sum in a fixed order")
        out["runs"].append({"forward_ms": f_ms, "backward_ms": b_ms,
                            "ratio": b_ms / f_ms, "peak_bytes": peak,
                            "forward_launches": fwd,
                            "backward_launches": bwd})
        print(f"bunny render_fn {res}^2 1 spp depth 5, run {run + 1}: forward "
              f"{f_ms:.1f} ms, backward {b_ms:.1f} ms (backward/forward "
              f"{b_ms / f_ms:.2f}), peak memory of the tape {peak} bytes; "
              f"launches forward {fwd}, backward {bwd}; image equal to "
              f"render(clamp=False) bit for bit; d loss / d mat_c0[0] "
              f"{g['mat_c0'][0].tolist()}, d loss / d light_c "
              f"{g['light_c'].tolist()} [{smi}]", flush=True)

    prof = profile_backward(fn, pack, fields, loss, f"bunny [{smi}]")
    out["backward_profile"] = {"wall_ms": prof[0], "device_ms": prof[1],
                               "operations": prof[2]}
    turns = []
    for route in GRAD_TURNS:
        with plain_grad() if route == "plain" else contextlib.nullcontext():
            img, g, f_ms, b_ms, fwd, bwd, peak = fwd_bwd(fn, pack, fields,
                                                         loss)
        plain = route == "plain"
        if fwd != (want_plain if plain else want) or bwd != (
                dict.fromkeys(want, 0) if plain else want_bwd) \
                or not torch.equal(img, ref):
            raise AssertionError(f"the {route} route's launches: forward {fwd},"
                                 f" backward {bwd}, or its image differs")
        for k in fields:
            err = float((g[k] - eager[0][k]).abs().max())
            scale = float(eager[0][k].abs().max())
            if not err <= GRAD_FIELD_TOL * scale:
                raise AssertionError(f"the {route} route's d loss / d {k} "
                                     f"differs from the kernels' by {err} "
                                     f"(largest |gradient| {scale})")
        turns.append({"route": route, "forward_ms": f_ms, "backward_ms": b_ms,
                      "peak_bytes": peak})
        if not plain:
            eager.append(g)
    out["route_turns"] = turns
    print(f"bunny forward / backward ms and the tape's peak bytes in turns, "
          f"kernel route and plain route (autograd through the plain vertex "
          f"and glue): " + "; ".join(
              f"{t['route']} {t['forward_ms']:.1f} / {t['backward_ms']:.1f} "
              f"ms, {t['peak_bytes']} bytes" for t in turns)
          + f"; each plain gradient within {GRAD_FIELD_TOL} of the "
          f"kernels' largest |gradient| [{smi}]", flush=True)
    t0 = time.perf_counter()
    ga, gf = check_grads(mean64(fn, pack), {"light_c": pack.light_c},
                         rtol=1e-2, eps=1e-2)
    out["fd_light_c"] = fd_line(f"bunny light_c depth 5 [{smi}]", ga, gf,
                                1e-2, time.perf_counter() - t0)
    fn2, pack2 = render_fn(scene, res, res, spp=1, seed=0, max_depth=2,
                           device=dev)
    rest = pack2.mat_c0[1:]
    f2 = lambda p: mean64(fn2, pack2)(
        {"mat_c0": torch.cat([p["mat_c0[0]"][None], rest])})
    t0 = time.perf_counter()
    ga, gf = check_grads(f2, {"mat_c0[0]": pack2.mat_c0[0]}, rtol=5e-2)
    out["fd_mat_c0"] = fd_line(f"bunny mat_c0[0] depth 2 [{smi}]", ga, gf,
                               5e-2, time.perf_counter() - t0)
    del fn2, pack2, rest

    out["graphed_vg"] = graphed_value_and_grad(
        fn, pack, target, fields, eager,
        {k: want[k] + want_bwd[k] for k in want}, smi)
    wrong = pack.mat_c0.clone()
    wrong[0] = torch.tensor([0.9, 0.1, 0.7], device=dev)
    with torch.no_grad():
        target = fn(pack)
    out["fit"] = graphed_fits(fn, pack._replace(mat_c0=wrong), target, smi)
    del fn, pack, target, ref, eager
    graph_mod.clear()

    out.update(texture_grads(dev, smi, res))
    return out


def texture_grads(dev, smi: str, res: int = 1024) -> dict:
    """The textured scene's texels and its checker variant's two colours
    at res^2, 1 spp, depth 1: autograd against finite differences (rtol
    5e-2), one forward and backward of the mean pixel timed, their
    launches exact (the fused wave forward, the backward kernels
    backward)."""
    out = {}
    for texture, fields in (("image", ("tex_image",)),
                            ("checker", ("tex_c0", "tex_c1"))):
        scene = grad_scene(texture)
        fn, pk = render_fn(scene, res, res, spp=1, seed=0, max_depth=1,
                           device=dev)
        _, g, f_ms, b_ms, fwd, bwd, peak = fwd_bwd(
            fn, pk, fields, lambda img: img.double().mean())
        want = expected_launches(scene.meta, res, 1, 1)
        if fwd != want or bwd != {**dict.fromkeys(want, 0),
                                  **grad_launches(scene.meta, 1, 1)}:
            raise AssertionError(f"{texture} texture launches: forward {fwd}"
                                 f", backward {bwd}")
        t0 = time.perf_counter()
        ga, gf = check_grads(mean64(fn, pk), dparams.get_params(pk, fields),
                             rtol=5e-2)
        worst = fd_line(f"{texture} texture {res}^2 depth 1 [{smi}]", ga, gf,
                        5e-2, time.perf_counter() - t0)
        if not float(sum(x.abs().sum() for x in g.values())) > 1e-4:
            raise AssertionError(f"{texture}: no texture gradient")
        print(f"{texture} texture: forward {f_ms:.1f} ms, backward "
              f"{b_ms:.1f} ms (backward/forward {b_ms / f_ms:.2f}), peak "
              f"memory {peak} bytes, launches forward {fwd}, backward {bwd} "
              f"[{smi}]", flush=True)
        out[texture] = {"forward_ms": f_ms, "backward_ms": b_ms,
                        "peak_bytes": peak, "fd_worst": worst}
    return out


# --------------------------------------------------------------------------
# 12. sharded render and train (parallel/)
# --------------------------------------------------------------------------

# the phase's frame: the default bunny at 1024^2, 4 spp, depth 5
SHARD_SPP, SHARD_DEPTH = 4, 5
# the gloo world whose ranks share the card, and its meshes: (px, spp) ->
# the world's ranks on it (None: all of them)
CARD_RANKS = 4
CARD_LAYOUTS = {(2, 1): [0, 1], (4, 1): None, (2, 2): None, (1, 4): None}
# the reference's own tolerance for the spp axis, whose sum reassociates
# (tests/test_parallel.py:38-39)
SPP_ATOL = 2e-4
# the layout whose ranks replay their first wave's wide casts through the
# plain walk (every layout replays its Threefry draws)
PLAIN_LAYOUT = (4, 1)
# the train steps' relative agreement between (1, 1) and (2, 1): the loss
# sums blocks in another order
TRAIN_RTOL = 1e-5
# the sharded gradient against value_and_grad's: the loss reaches the film
# by another sequence of float operations
GRAD_RTOL = 1e-6
# (c)'s train steps at (1, 1): the graphed step's capture, then graphed
# (True) and eager steps in turns
TRAIN_TURNS = (True, False, False, True, True, False, False, True)
# (a)'s frames in turns: a warm-up each, then three samples each
TURNS = ("sharded", "render", "sharded", "render", "render", "sharded",
         "sharded", "render")
CARD_DEADLINE_S = 600.0
RANK_TIMEOUT = datetime.timedelta(seconds=300)


@contextlib.contextmanager
def deterministic():
    """While open, PyTorch's deterministic algorithms (warning where an op
    has none): the backward's index_add_ then sums in a fixed order, not by
    atomics, so two gradients of the same loss differ only where their
    arithmetic does. A measurement setting of this script only."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def sharded_launches(shape, lights: int, fused: bool = True) -> dict:
    """Launches per rank of the phase's frame on a (px, spp) mesh (or of
    the train step's differentiated partial film's forward): one wave per
    local sample, each with (depth + 1) closest and depth x lights shadow
    casts, 2 + depth Threefry draws and, on the fused vertex's route
    (fused=False for the plain route), depth + 1 shade_vertex and depth
    nee_accumulate launches; one brute_hits per cast (the bunny's rects)
    and ops/rays.py's kernels (rays_launches of the kernel-routed bunny),
    on every path; one camera_rays a wave, and on the fused route one
    permute_state per sort and one unsort_guard (wave_launches); no
    backward kernel (sharded_grad counts the train step's backward)."""
    local = SHARD_SPP // shape[1]
    casts = local * (SHARD_DEPTH + 1 + SHARD_DEPTH * lights)
    keys = min(2, SHARD_DEPTH) * lights + min(3, SHARD_DEPTH)
    sorts = min(3, SHARD_DEPTH)
    return {"wide_bvh": casts, "sweep_bvh": 0,
            "threefry": local * (2 + SHARD_DEPTH),
            "shade_vertex": local * (SHARD_DEPTH + 1) if fused else 0,
            "nee_accumulate": local * SHARD_DEPTH if fused else 0,
            "brute_hits": casts, "shadow_key": local * keys,
            "shadow_segments": local * SHARD_DEPTH * lights,
            "occlusion_merge": local * SHARD_DEPTH * lights,
            "hit_reconstruct": local * (SHARD_DEPTH + 1),
            "camera_rays": local,
            "permute_state": local * sorts if fused else 0,
            "unsort_guard": local if fused else 0, **dict.fromkeys(GRAD, 0)}


def sharded_grad(shape) -> dict:
    """The backward kernels' launches per rank in the backward of the
    train step's partial film on a (px, spp) mesh: grad_launches of its
    local samples' waves of the kernel-routed bunny."""
    return grad_launches(bunny_scene().meta, SHARD_SPP // shape[1],
                         SHARD_DEPTH)


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the kernels whose calls recorded_calls records
RECORDED = ("wide_bvh", "sweep_bvh", "threefry", "brute_hits")


@contextlib.contextmanager
def recorded_calls(out: list, limit: int):
    """While open, the first `limit` calls of wide_bvh.intersect_wide,
    rng.lane_keys, rng.uniforms and brute_ops.brute_hits append (name,
    inputs, keywords, output) to `out`, their input tensors cloned."""
    copy = lambda a: tuple(
        rng.LaneKeys(*(k.clone() for k in x)) if isinstance(x, rng.LaneKeys)
        else x.clone() if torch.is_tensor(x) else x for x in a)
    saved = []
    for mod, name in ((wide_bvh, "intersect_wide"), (rng, "lane_keys"),
                      (rng, "uniforms"), (brute_ops, "brute_hits")):
        inner = getattr(mod, name)

        # the wrapped function counts its launches on its module's name, so
        # on `call` (functools.wraps copies the count) while this is open
        @functools.wraps(inner)
        def call(*a, _inner=inner, _name=name, **kw):
            got = _inner(*a, **kw)
            if len(out) < limit:
                out.append((_name, copy(a), kw, got))
            return got

        setattr(mod, name, call)
        saved.append((mod, name, inner))
    try:
        yield out
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


def replay_plain(calls) -> dict:
    """Each recorded call through its plain version, bit for bit; returns
    the number of calls checked by name."""
    n = collections.Counter()
    for name, a, kw, got in calls:
        kw = without_out(kw)
        if name == "intersect_wide":
            want = wide_bvh.intersect_wide_plain(*a, **kw)
        elif name == "lane_keys":
            seed, sample, pixel = a
            want = rng.lane_keys_plain(seed, torch.as_tensor(
                sample, device=pixel.device).expand(pixel.shape), pixel)
        elif name == "brute_hits":
            got, want = ([x for _, x in brute_outputs(out, a[5])] for out in
                         (got, isect_ops.brute_hits_plain(*a, **kw)))
        else:
            got, want = (got.view(torch.int32),), (rng.uniforms_plain(
                *a).view(torch.int32),)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 "on the sharded path")
        n[name] += 1
    return dict(n)


def train_steps(scene, mesh, dev, res: int, turns=(True, True, True)):
    """build_train_step on the mesh at res^2, 1 spp, depth 5, fields
    ("mat_c0",), lr FIT_LR, from the red bunny's albedo set to (0.9, 0.1,
    0.7) towards the scene's own frame: one step function per route in
    `turns` (True graph=True, whose first call captures its two graphs;
    False graph=False, eager), called in that order, each route continuing
    its own params. Per route ("graphed", "eager"): its losses, ms per step
    (host clock to synchronize) and, for the graphed one, its capture
    (warm-up and capture s, pool bytes, each graph's kernel nodes); each
    route's first three losses must fall and the routes' first losses be
    equal bit for bit (the forward is). Also the peak memory above what
    was allocated before the steps, and (a step's render, pack, cam,
    params, target) for the caller's checks."""
    routes = {g: ptrain.build_train_step(
        scene, mesh, res, res, 1, fields=("mat_c0",), lr=FIT_LR,
        max_depth=SHARD_DEPTH, device=dev, graph=g)
        for g in dict.fromkeys(turns)}
    _, init, rend, cam = routes[turns[0]]
    pack = scene.pack
    target = rend.frame(pack, cam)
    wrong = init()["mat_c0"].clone()
    wrong[0] = torch.tensor([0.9, 0.1, 0.7], device=dev)
    params = dict.fromkeys(routes, {"mat_c0": wrong})
    name = {True: "graphed", False: "eager"}
    out = {name[g]: {"losses": [], "ms": []} for g in routes}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for graph in turns:
        rec = out[name[graph]]
        t0 = time.perf_counter()
        params[graph], loss = routes[graph][0](params[graph], target)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(float(loss))
        if graph and "capture" not in rec:
            g = next(reversed(graph_mod.GRAD_CACHE.entries.values())).graphs
            rec["capture"] = {
                "warmup_s": g.warmup_s, "capture_s": g.capture_s,
                "pool_bytes": g.pool_bytes,
                "nodes": {k: node_launches(v) for k, v in g.launches.items()}}
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    for rec in (out[name[g]] for g in routes):
        ls = rec["losses"]
        if not ls[2] < ls[1] < ls[0]:
            raise AssertionError(f"the sharded fit's loss does not fall: {ls}")
    if len({out[name[g]]["losses"][0] for g in routes}) != 1:
        raise AssertionError(f"the routes' first losses differ: {out}")
    return out, (rend, pack, cam, {"mat_c0": wrong}, target)


def card_rank(rank, scene, dev_type, res):
    """One of CARD_RANKS gloo ranks sharing one device: each layout's frame
    through render_sharded with its launches counted (not traced: a trace
    per rank, four processes on the host's cores, doubled the phase's
    time); then the rank's
    partial film of the same frame, the first wave's kernel calls recorded
    and replayed through the plain versions (the wide casts on
    PLAIN_LAYOUT only); three graphed train steps at (2, 1) on ranks 0 and
    1; the scaling report at 1, 2 and 4 ranks; the pool bytes of its
    cached wave and gradient graphs. Returns its results, rank 0's with
    each layout's frame (on the CPU)."""
    torch.set_num_threads(2)
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    start = time.perf_counter()
    note = lambda what: print(f"rank {rank}: {what} at "
                              f"{time.perf_counter() - start:.1f} s",
                              flush=True)
    dev = pmesh.rank_device(dev_type)
    scene = scene.to(dev)
    lights = sum(1 for lt in scene.meta.lights if not lt.static_black)
    # the calls recorded_calls records: traversal, streams, brute force
    per_wave = sum(v for k, v in sharded_launches(
        (1, SHARD_SPP), lights).items() if k in RECORDED)
    out = {"layouts": {}}
    for shape, ranks in CARD_LAYOUTS.items():
        mesh = pmesh.make_mesh(*shape, ranks=ranks, device=dev)
        if mesh.get_coordinate() is None:
            continue
        frame = lambda graph=None: prender.render_sharded(
            scene, res, res, SHARD_SPP, mesh, max_depth=SHARD_DEPTH,
            clamp=False, device=dev, graph=graph)
        frame(True)  # warm-up: captures this layout's wave
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        img = frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        note(f"{shape} frame in {wall:.3f} s")
        if rank == 0:
            out.setdefault("frames", {})[shape] = img.cpu()
        _, pack, cam = setup(scene, res, res, dev)
        fn = prender.build_sharded_render(scene.meta, mesh, res, res,
                                          SHARD_SPP,
                                          max_depth=SHARD_DEPTH,
                                          device=dev)
        calls = []
        with torch.no_grad(), recorded_calls(calls, per_wave):
            part = fn.partial(pack, cam)
        note(f"{shape} partial film")
        calls = [c for c in calls if shape == PLAIN_LAYOUT
                 or c[0] != "intersect_wide"]
        out["layouts"][shape] = {
            "launches": launches, "wall": wall, "coord": (fn.ip, fn.isp),
            "partial": part.cpu(), "plain": replay_plain(calls)}
        del calls, part, img
        note(f"{shape} kernel calls replayed through the plain versions")
    mesh = pmesh.make_mesh(2, 1, ranks=[0, 1], device=dev)
    if rank < 2:
        out["train"] = train_steps(scene, mesh, dev, res)[0]["graphed"]
        note("(2, 1) graphed train steps")
    out["rows"] = multihost.scaling_report(
        scene, res, res, SHARD_SPP, rank_counts=[1, 2, 4],
        max_depth=SHARD_DEPTH, device=dev)
    note("scaling report")
    out["graphs"] = [(e.inputs[-1].shape[0], e.pool_bytes)
                     for e in graph_mod.CACHE.entries.values()]
    out["grad_graphs"] = [e.graphs.pool_bytes for e in
                          graph_mod.GRAD_CACHE.entries.values()]
    return out


def sharded_phase(dev, smi: str, res: int = 1024) -> dict:
    """parallel/ on the default bunny at res^2, 4 spp, depth 5. (a) A world
    of one rank over NCCL (multihost.initialize), mesh (1, 1):
    render_sharded equal to render_fn's frame bit for bit, with the exact
    launch counts, traced (counted_frame); its wall time and rays/s in turns with render()'s
    frame (a warm-up each, then 3 samples each, medians), its peak memory.
    (c) build_train_step at (1, 1), graphed and eager in TRAIN_TURNS
    (train_steps): the step's partial film launches one wave's kernels and
    its backward none, as the graphs' kernel nodes count them; under
    deterministic() the graphed step equals the eager one bit for bit and
    its gradient diff.params.value_and_grad's within GRAD_RTOL. (b) CARD_RANKS gloo ranks sharing the card (card_rank), the
    scene and kernels built here: (2, 1) and (4, 1) frames equal to (a)'s
    bit for bit, (2, 2) and (1, 4) within SPP_ATOL; exact launches per
    rank; every rank's partial film equal bit for bit to the sum of its
    samples' waves on its block as the single-card path computes them;
    their recorded kernel calls equal to the plain versions'; (2, 1)
    graphed train losses within TRAIN_RTOL of (1, 1)'s; (d) the scaling
    report; (e) dryrun_multichip(CARD_RANKS). Returns a summary dict."""
    scene = bunny_scene()
    sdev = scene.to(dev)
    lights = sum(1 for lt in scene.meta.lights if not lt.static_black)
    n_pix = res * res
    out = {"device": smi}
    world = multihost.initialize(f"localhost:{free_port()}", 1, 0, device=dev,
                                 timeout=RANK_TIMEOUT)
    if world != 1:
        raise AssertionError(f"a world of one rank has size {world}")
    out["backend"] = dist.get_backend()
    try:
        mesh = pmesh.make_mesh(device=dev)
        fn, pack = render_fn(sdev, res, res, SHARD_SPP, max_depth=SHARD_DEPTH,
                             device=dev)
        _, _, cam = setup(sdev, res, res, dev)
        wave = wave_fn(sdev.meta, res, SHARD_DEPTH)
        ids = torch.arange(n_pix, device=dev)
        with torch.no_grad():
            ref = fn(pack)
            waves = [wave(pack, cam, s, ids).cpu() for s in range(SHARD_SPP)]
        sharded = lambda graph=None: prender.render_sharded(
            sdev, res, res, SHARD_SPP, mesh, max_depth=SHARD_DEPTH,
            clamp=False, device=dev, graph=graph)
        sharded(True)  # warm-up: captures the rank's wave
        want = sharded_launches((1, 1), lights)
        img, _, launches, out["peak_bytes"] = counted_frame(
            sharded, sharded, want, "(1, 1) sharded")
        if not torch.equal(img, ref):
            raise AssertionError(f"the (1, 1) frame differs from render_fn's "
                                 f"(max |diff| {float((img - ref).abs().max())})")
        out["launches"] = {"1x1": launches}
        _, st = render(sdev, res, res, SHARD_SPP, max_depth=SHARD_DEPTH,
                       clamp=False, device=dev, with_stats=True)
        frame = lambda graph=None: render(sdev, res, res, SHARD_SPP,
                                          max_depth=SHARD_DEPTH, clamp=False,
                                          device=dev, graph=graph)
        frame(True)  # captures render()'s wave
        walls = {"sharded": [], "render": []}
        for name in TURNS:
            call = sharded if name == "sharded" else frame
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        med = {k: float(np.median(v[1:])) for k, v in walls.items()}
        out["walls"], out["median_s"], out["rays"] = walls, med, st["rays"]
        print(f"(a) world of 1 over {out['backend']}, mesh (1, 1), bunny "
              f"{res}^2 spp {SHARD_SPP} depth {SHARD_DEPTH}: render_sharded "
              f"equal to render_fn bit for bit; launches {launches} by "
              f"its trace, equal to the counters (expected {want}); peak "
              f"memory {out['peak_bytes']} bytes; "
              f"in turns after a warm-up each, sharded {walls['sharded'][1:]} "
              f"s, render {walls['render'][1:]} s; medians sharded "
              f"{med['sharded']:.4f} s ({st['rays'] / med['sharded']:.1f} "
              f"rays/s), render {med['render']:.4f} s "
              f"({st['rays'] / med['render']:.1f} rays/s), {st['rays']} rays "
              f"as render(with_stats=True) counts them [{smi}]", flush=True)
        del img, fn

        train, (rend, tpack, tcam, params, target) = train_steps(
            sdev, mesh, dev, res, TRAIN_TURNS)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        reset_launches()
        part = rend.partial(dparams.with_params(tpack, leaves), tcam)
        torch.cuda.synchronize()
        fwd = launch_counts()
        reset_launches()
        torch.autograd.grad(part.sum(), list(leaves.values()))
        torch.cuda.synchronize()
        bwd = launch_counts()
        del part, leaves
        want1 = sharded_launches((1, SHARD_SPP), lights)
        bwant = {**dict.fromkeys(want1, 0), **sharded_grad((1, SHARD_SPP))}
        nodes = train["graphed"]["capture"]["nodes"]
        if fwd != want1 or bwd != bwant or nodes != {
                "forward": want1, "backward": bwant}:
            raise AssertionError(f"train launches: forward {fwd} (expected "
                                 f"{want1}), backward {bwd} (expected "
                                 f"{bwant}); the graphs' kernel nodes "
                                 f"{nodes}")
        out["train_launches"] = {"forward": fwd, "backward": bwd}
        fn1, pk1 = render_fn(sdev, res, res, 1, max_depth=SHARD_DEPTH,
                             device=dev)
        timg = target.view(res, res, 3)
        with deterministic():
            reset_launches()
            loss_s, g_s = ptrain.value_and_grad(rend, tpack, tcam, params,
                                                target)
            if launch_counts() != {k: want1[k] + bwant[k] for k in want1}:
                raise AssertionError(f"a gradient launched {launch_counts()}"
                                     f", one forward wave is {want1} and "
                                     f"its backward {bwant}")
            graphed = ptrain.GraphedValueAndGrad(rend, tpack, tcam, params,
                                                 target)
            loss_g, g_g = graphed((params, target))
            loss_1, g_1 = dparams.value_and_grad(
                lambda p: torch.mean((fn1(dparams.with_params(pk1, p))
                                      - timg) ** 2), params)
            graphed.release()
        if not (torch.equal(loss_g, loss_s)
                and torch.equal(g_g["mat_c0"], g_s["mat_c0"])):
            raise AssertionError("under deterministic algorithms the graphed "
                                 "train step's loss or gradient differs from "
                                 "the eager step's")
        rel = float(((g_g["mat_c0"] - g_1["mat_c0"]).abs()
                     / g_1["mat_c0"].abs().clamp_min(1e-30)).max())
        if not torch.allclose(g_g["mat_c0"], g_1["mat_c0"], rtol=GRAD_RTOL,
                              atol=0.0):
            raise AssertionError(f"sharded gradient differs from "
                                 f"value_and_grad's (max rel {rel:.3e})")
        out["train_1x1"] = train | {"grad_rel": rel, "loss": float(loss_g),
                                    "loss_single": float(loss_1)}
        gr, ea = train["graphed"], train["eager"]
        med = {k: float(np.median(r["ms"][int(k == "graphed"):]))
               for k, r in (("graphed", gr), ("eager", ea))}
        out["train_1x1"]["median_ms"] = med
        print(f"(c) build_train_step (1, 1), {res}^2 1 spp depth "
              f"{SHARD_DEPTH}, mat_c0 from red albedo (0.9, 0.1, 0.7), lr "
              f"{FIT_LR}, steps in turns {TRAIN_TURNS} (True graphed): "
              f"graphed losses {gr['losses']}, ms per step "
              f"{[round(x, 1) for x in gr['ms']]} (the first its capture: "
              f"warm-ups {gr['capture']['warmup_s']:.3f} s, capture "
              f"{gr['capture']['capture_s']:.3f} s, pool "
              f"{gr['capture']['pool_bytes']} bytes); eager losses "
              f"{ea['losses']}, ms per step {[round(x, 1) for x in ea['ms']]};"
              f" medians graphed {med['graphed']:.1f} (replays), eager "
              f"{med['eager']:.1f} ms; peak memory {train['peak_bytes']} "
              f"bytes; the partial film launches {fwd}, its backward {bwd}, "
              f"the graphs' kernel nodes {nodes}; under deterministic "
              f"algorithms the graphed step equals the eager one bit for bit, "
              f"loss {float(loss_g)} vs value_and_grad's {float(loss_1)}, "
              f"gradient within {rel:.3e} relative [{smi}]", flush=True)
        del rend, tpack, tcam, params, target, fn1, pk1, g_s, g_1
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = multihost.spawn(card_rank, CARD_RANKS, scene, dev.type, res,
                            deadline_s=CARD_DEADLINE_S, timeout=RANK_TIMEOUT)
    world_s = time.perf_counter() - t0
    imgs = ranks[0]["frames"]
    ref = ref.cpu()
    out["layouts"] = {}
    for shape, img in imgs.items():
        err = float((img - ref).abs().max())
        exact = torch.equal(img, ref)
        if shape[1] == 1 and not exact:
            raise AssertionError(f"{shape}: the frame differs from (1, 1)'s "
                                 f"(max |diff| {err})")
        if err > SPP_ATOL:
            raise AssertionError(f"{shape}: max |diff| {err} > {SPP_ATOL}")
        want = sharded_launches(shape, lights)
        local_px = n_pix // shape[0]
        local_spp = SHARD_SPP // shape[1]
        rows = []
        for rank, got in enumerate(ranks):
            lay = got["layouts"].get(shape)
            if lay is None:
                continue
            if lay["launches"] != want:
                raise AssertionError(f"{shape} rank {rank}: launches "
                                     f"{lay['launches']}, expected {want}")
            ip, isp = lay["coord"]
            block = slice(ip * local_px, (ip + 1) * local_px)
            part = torch.zeros((local_px, 3), dtype=torch.float32)
            for s in range(isp * local_spp, (isp + 1) * local_spp):
                part = part + waves[s][block]
            if not torch.equal(lay["partial"], part):
                raise AssertionError(f"{shape} rank {rank}: the partial film "
                                     "differs from the single-card waves")
            rows.append({"rank": rank, "wall_s": lay["wall"],
                         "plain": lay["plain"]})
        out["layouts"][f"{shape[0]}x{shape[1]}"] = {
            "max_abs_err": err, "bit_for_bit": exact, "launches": want,
            "ranks": rows}
        out["launches"][f"{shape[0]}x{shape[1]}"] = want
        print(f"(b) {len(rows)} gloo ranks sharing the card, mesh {shape}: "
              f"frame {'equal to (1, 1) bit for bit' if exact else 'within '}"
              f"{'' if exact else f'{err:.3e} of (1, 1)'}; launches per rank "
              f"{want}; partial films equal to the single-card waves bit for "
              f"bit; kernel calls equal to plain {[r['plain'] for r in rows]};"
              f" walls {[round(r['wall_s'], 3) for r in rows]} s [{smi}]",
              flush=True)
    losses = ranks[0]["train"]["losses"]
    base = out["train_1x1"]["graphed"]["losses"]
    if not all(abs(a - b) <= TRAIN_RTOL * abs(b) for a, b in zip(losses, base)):
        raise AssertionError(f"(2, 1) train losses {losses} vs (1, 1) {base}")
    out["train_2x1"] = ranks[0]["train"]
    print(f"(c) build_train_step (2, 1) over gloo on the card, graphed: losses "
          f"{losses} (1, 1): {base}; ms per step "
          f"{[round(x, 1) for x in ranks[0]['train']['ms']]} (the first its "
          f"capture) [{smi}]", flush=True)
    rows = ranks[0]["rows"]
    out["scaling"], out["world_s"] = rows, world_s
    print(f"(d) scaling_report, bunny {res}^2 spp {SHARD_SPP} depth "
          f"{SHARD_DEPTH}, ranks sharing one card over gloo (a check of the "
          f"machinery, not of scaling) [{smi}]:\n"
          + multihost.format_scaling_table(rows), flush=True)
    out["graphs"] = [r["graphs"] for r in ranks]
    out["grad_graphs"] = [r["grad_graphs"] for r in ranks]
    print(f"the {CARD_RANKS}-rank world took {world_s:.1f} s, start-up "
          f"included; each rank's cached graphs at its end, (lanes, pool "
          f"bytes): {out['graphs']}; its gradient graphs' pool bytes: "
          f"{out['grad_graphs']} [{smi}]", flush=True)
    t0 = time.perf_counter()
    out["dryrun_loss"] = dryrun_multichip(CARD_RANKS)
    out["dryrun_s"] = time.perf_counter() - t0
    print(f"(e) dryrun_multichip({CARD_RANKS}): gloo ranks sharing the card, "
          f"one graphed train step, in {out['dryrun_s']:.1f} s, start-up "
          f"included [{smi}]", flush=True)
    return out


# --------------------------------------------------------------------------
# 13. the compiled wave
# --------------------------------------------------------------------------

GRAPH_TURNS = (False, True, True, False, False, True)
GRAPH_DEPTH = 5


# the routes phase 13 splits a wave under, in turns: the kernels, the
# wave's glue as it was before ops/wave.py (plain_glue), the plain vertex
# (plain_vertex), the plain brute-force casts (plain_brute), the plain
# casts' set-up and hit reconstruction (plain_rays)
SPLIT_TURNS = ("fused", "plain glue", "plain vertex", "plain brute",
               "plain rays", "plain rays", "plain brute", "plain vertex",
               "plain glue", "fused")
SPLIT_ROUTES = {"fused": contextlib.nullcontext, "plain glue": plain_glue,
                "plain vertex": plain_vertex, "plain brute": plain_brute,
                "plain rays": plain_rays}
def host_replay_ms(scene, dev, res: int, depth: int, reps: int = 20) -> dict:
    """The host's time per replayed wave in models/graph.py's _copy_in (the
    inputs copied into the graph's buffers) and wave_key (the cache key of
    the call's inputs), by perf_counter around each over reps replays of
    the 1-spp wave, and the replay call's whole host time; nothing is
    changed."""
    spent = collections.defaultdict(float)
    saved = {name: getattr(graph_mod, name) for name in ("_copy_in",
                                                         "wave_key")}

    def timed(name, inner):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    render(scene, res, res, spp=1, max_depth=depth, seed=1, device=dev,
           graph=True)
    torch.cuda.synchronize()
    for name, inner in saved.items():
        setattr(graph_mod, name, timed(name, inner))
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            render(scene, res, res, spp=1, max_depth=depth, seed=1,
                   device=dev, graph=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, inner in saved.items():
            setattr(graph_mod, name, inner)
    return {**{k: v * 1e3 / reps for k, v in spent.items()},
            "frame_ms": wall * 1e3 / reps}


def module_split(scene, dev, label: str, res: int, depth: int,
                 smi: str) -> dict:
    """scripts/wave_nodes.py's wave_nodes (one 1-spp wave's device time
    and operations by range and class, eager and replayed) on each route
    of SPLIT_ROUTES (each route captures its
    own graph: the cache is cleared between turns), in SPLIT_TURNS; prints
    each turn's replayed and eager device ms per range, the replay's
    operations by range and class (and, for the kernels' first turn, the
    names of those of class other) and each range's device ms by class;
    then the host's time per replay (host_replay_ms). Returns {route:
    [turn's wave_nodes, ...], "host": host_replay_ms}."""
    out = {route: [] for route in SPLIT_ROUTES}
    for route in SPLIT_TURNS:
        graph_mod.clear()
        with SPLIT_ROUTES[route]():
            got = wave_nodes.wave_nodes(scene, dev, res, depth)
        out[route].append(got)
        fmt = lambda d: ("not split (the replay's operations differ from "
                         "the eager wave's)" if d is None else ", ".join(
                             f"{k.replace('li_path.', '')} {v:.2f}"
                             for k, v in d.items()))
        cls = lambda d: "; ".join(
            f"{k.replace('li_path.', '')} " + ", ".join(
                f"{c} {n}" for c, n in v.items() if n)
            for k, v in d.items() if any(v.values()))
        print(f"{label} {res}^2 1-spp wave, route {route}: replayed "
              f"{got['replayed_ms']:.2f} ms device ({got['replayed_ops']} "
              f"operations): {fmt(got['replayed'])}; eager "
              f"{got['eager_ms']:.2f} ms ({got['ops']} operations, "
              f"{got['spans']} range spans): {fmt(got['eager'])}; replayed "
              f"operations by class: {cls(got['nodes'])}; device ms by "
              f"class: " + "; ".join(
                  f"{k.replace('li_path.', '')} " + ", ".join(
                      f"{c} {v:.3f}" for c, v in d.items() if v)
                  for k, d in got["class_ms"].items() if any(d.values()))
              + f" [{smi}]", flush=True)
        if route == "fused" and len(out[route]) == 1:
            print(f"{label} the kernels' replayed wave's operations of class "
                  f"other, by range and name: {got['other']}", flush=True)
    graph_mod.clear()
    out["host"] = host_replay_ms(scene, dev, res, depth)
    print(f"{label} {res}^2 1-spp wave replayed: host ms per replay in "
          f"graph._copy_in {out['host'].get('_copy_in', 0.0):.4f}, in "
          f"graph.wave_key {out['host'].get('wave_key', 0.0):.4f}, the "
          f"whole render() call {out['host']['frame_ms']:.3f} [{smi}]",
          flush=True)
    graph_mod.clear()
    return out


# the wave's glue in turns: the kernels and the glue as it was before
# ops/wave.py (plain_glue)
GLUE_TURNS = ("fused", "plain glue", "plain glue", "fused")


def glue_turns(scene, dev, label: str, res: int, kw: dict, img, st) -> dict:
    """The graphed frame (render(graph=True, **kw)) and the profiled
    replayed 1-spp wave (profile_wave) on the glue kernels' route and on
    the plain glue's, in GLUE_TURNS, each route capturing its own graphs
    (the cache is cleared between turns): each frame's image and stats
    equal to img, st (the kernels' graphed frame) bit for bit. Returns
    {route: {"frame_s": [...], "wave": [(wall ms, device ms, source)]}}."""
    out = {route: {"frame_s": [], "wave": []} for route in GLUE_TURNS}
    for route in GLUE_TURNS:
        graph_mod.clear()
        with SPLIT_ROUTES[route]():
            render(scene, res, res, graph=True, **kw)   # captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, gst = render(scene, res, res, graph=True, **kw)
            torch.cuda.synchronize()
            out[route]["frame_s"].append(time.perf_counter() - t0)
            if not torch.equal(got, img) or gst != st:
                raise AssertionError(f"{label}: the graphed frame on route "
                                     f"{route} differs from the kernels'")
            out[route]["wave"].append(profile_wave(
                scene, dev, f"{label} {res}^2 ({route})", res, GRAPH_DEPTH,
                table=False, graph=True))
    graph_mod.clear()
    print(f"{label} {res}^2 graphed frames in turns {GLUE_TURNS}: "
          + "; ".join(f"{r} {v['frame_s']} s, replayed 1-spp wave (wall, "
                      f"device ms) {[w[:2] for w in v['wave']]}"
                      for r, v in out.items()), flush=True)
    return out


def compiled_phase(cases, dev, smi: str) -> dict:
    """render()'s frame with its waves replayed from CUDA graphs (graph=
    True) against the eager frame (graph=False), for each (label, scene,
    res, spp) of cases at depth GRAPH_DEPTH, seed 0, with stats: the first
    frame on render()'s default (graph=None, a fresh cache: its waves run
    op by op until a shape has run graph.CAPTURE_AFTER times) with the
    captures it made; the first graphed frame's wall (graph=True, its
    captures) and each captured wave's warm-up and capture seconds, pool
    bytes and the launches its graph's kernel nodes count per replay; an
    eager warm-up frame; then the two in GRAPH_TURNS, each frame's launches exact
    (expected_launches), every image bit for bit equal to the other mode's
    and to its own mode's first, and the stats equal; medians, rays/s and
    each mode's peak memory above what was allocated before the frame (a
    graph's pool is reserved at capture, not allocated in a frame); and
    the 1-spp wave replayed and eager (profile_wave): wall, device time,
    busy share. Returns a summary dict."""
    out = {}
    for label, scene, res, spp in cases:
        kw = dict(spp=spp, max_depth=GRAPH_DEPTH, seed=0, clamp=False,
                  device=dev, with_stats=True)
        want = expected_launches(scene.meta, res, spp, GRAPH_DEPTH)
        first = {}
        for graph in (None, True):
            graph_mod.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, res, res, graph=graph, **kw)
            torch.cuda.synchronize()
            first[graph] = (time.perf_counter() - t0,
                            len(graph_mod.CACHE.entries))
        first_s = first[True][0]
        captured = [{"lanes": e.inputs[-1].shape[0], "warmup_s": e.warmup_s,
                     "capture_s": e.capture_s, "pool_bytes": e.pool_bytes,
                     "replay_launches": {k: v for k, v in e.launches.items()
                                         if v}}
                    for e in graph_mod.CACHE.entries.values()]
        render(scene, res, res, graph=False, **kw)
        walls, peaks, firsts = {True: [], False: []}, {True: 0, False: 0}, {}
        for graph in GRAPH_TURNS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            img, st = render(scene, res, res, graph=graph, **kw)
            torch.cuda.synchronize()
            walls[graph].append(time.perf_counter() - t0)
            peaks[graph] = max(peaks[graph],
                               torch.cuda.max_memory_allocated() - base)
            if launch_counts() != want:
                raise AssertionError(f"{label} graph={graph}: launches "
                                     f"{launch_counts()}, expected {want}")
            if graph not in firsts:
                firsts[graph] = (img.clone(), st)
            elif not torch.equal(img, firsts[graph][0]):
                raise AssertionError(f"{label} graph={graph}: two frames "
                                     "differ")
        (gi, gs), (ei, es) = firsts[True], firsts[False]
        if not torch.equal(gi, ei) or gs != es:
            raise AssertionError(
                f"{label}: the graphed frame differs from the eager one (max "
                f"|diff| {float((gi - ei).abs().max())}, stats {gs} vs {es})")
        med = {k: float(np.median(v)) for k, v in walls.items()}
        rays = gs["rays"]
        wave = {mode: profile_wave(scene, dev, f"{label} {res}^2", res,
                                   GRAPH_DEPTH, table=graph, graph=graph)
                for mode, graph in (("graphed", True), ("eager", False))}
        glue = glue_turns(scene, dev, label, res, kw, gi, gs)
        split = module_split(scene, dev, label, 1024, GRAPH_DEPTH, smi)
        out[label] = {
            "res": res, "spp": spp, "rays": rays, "launches": want,
            "first_graphed_s": first_s, "first_default_s": first[None][0],
            "first_default_captures": first[None][1], "captured": captured,
            "walls": {"graphed": walls[True], "eager": walls[False]},
            "median_s": {"graphed": med[True], "eager": med[False]},
            "peak_bytes": {"graphed": peaks[True], "eager": peaks[False]},
            "wave": {m: {"wall_ms": w[0], "device_ms": w[1], "source": w[2]}
                     for m, w in wave.items()},
            "glue_turns": glue, "modules": split}
        print(f"{label} {res}^2 spp {spp} depth {GRAPH_DEPTH}: graphed frame "
              f"equal to the eager one bit for bit (images and stats), "
              f"launches {want} a frame in both modes; first frame on the "
              f"default {first[None][0]:.3f} s ({first[None][1]} captures); "
              f"first graphed frame {first_s:.3f} s with its captures "
              + ", ".join(f"({c['lanes']} lanes: warm-up wave "
                          f"{c['warmup_s']:.3f} s, capture "
                          f"{c['capture_s']:.3f} s, pool {c['pool_bytes']} "
                          f"bytes, a replay's launches by its kernel nodes "
                          f"{c['replay_launches']})" for c in captured)
              + f"; in turns after a warm-up each, graphed {walls[True]} s, "
              f"eager {walls[False]} s; medians graphed {med[True]:.4f} s "
              f"({rays / med[True]:.1f} rays/s), eager {med[False]:.4f} s "
              f"({rays / med[False]:.1f} rays/s), {rays} rays; peak memory "
              f"in a frame graphed {peaks[True]} bytes, eager {peaks[False]} "
              f"bytes [{smi}]", flush=True)
    graph_mod.clear()
    return out


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    phase("2 build")
    t0 = time.perf_counter()
    cuda_build.build_libraries(LIBRARIES + (COUNT_LIBRARY,))
    print(f"kernels built in {time.perf_counter() - t0:.2f} s, one nvcc each "
          "in parallel", flush=True)
    for name, *_ in LIBRARIES + (COUNT_LIBRARY,):
        secs, log = cuda_build.BUILD_LOG.get(name, (0.0, "(cached build)"))
        print(f"{name}: nvcc {secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)

    phase("2b threefry kernel vs plain")
    t0 = time.perf_counter()
    bunny = bunny_scene().to(dev)
    bunny_s = time.perf_counter() - t0
    rng_s = 4 + 2 * bunny.meta.n_lights
    streams = rng_phase(dev, bunny.meta.n_lights)

    phase("2c fused vertex kernel vs plain")
    t0 = time.perf_counter()
    torch_rules(dev)
    cornell = cornell_box().to(dev)
    cases = (("bunny", bunny, 1024), ("cornell", cornell, 1024),
             ("every-kind wide", every_kind_scene(False).to(dev), 256),
             ("every-kind sweep", every_kind_scene(True).to(dev), 256),
             ("many-lights", many_lights_scene().to(dev), 256))
    vertex = vertex_phase(cases, dev, smi.splitlines()[0], time_case="bunny")
    print(f"phase 2c took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("2d brute-force kernel vs plain")
    t0 = time.perf_counter()
    brute = brute_phase(cases, dev, smi.splitlines()[0], time_case="cornell")
    edges = brute_edges(cornell, bunny, dev)
    brute_frames((("cornell", cornell, 512, 16), ("bunny", bunny, 1024, 4)),
                 dev)
    print(f"phase 2d took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("2e casts' set-up and hit reconstruction kernels vs plain")
    t0 = time.perf_counter()
    rays = rays_phase(cases, dev, smi.splitlines()[0], time_case="bunny")
    families = many_families_scene().to(dev)
    rays_edge = rays_edges((("cornell", cornell), ("bunny", bunny),
                            ("every-kind", cases[2][1]),
                            ("many-families", families)), dev)
    rays_frames((("cornell", cornell, 512, 16), ("bunny", bunny, 1024, 4),
                 ("many-families", families, 256, 2)), dev)
    del families
    print(f"phase 2e took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("2f the wave's glue kernels vs plain")
    t0 = time.perf_counter()
    glue = wave_phase(cases, dev, smi.splitlines()[0], time_case="bunny")
    glue.update(wave_edges(bunny, dev))
    wave_frames((("cornell", cornell, 512, 16, {}),
                 ("bunny", bunny, 1024, 4, {}),
                 ("bunny debug sampler", bunny, 256, 2,
                  {"sampler": "debug"}),
                 ("bunny stratified sampler", bunny, 256, 4,
                  {"sampler": "stratified"})), dev)
    print(f"phase 2f took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("2g gradient kernels vs plain")
    t0 = time.perf_counter()
    grads = grad_phase(
        cases + (("many-families", many_families_scene().to(dev), 256),
                 ("textured image", grad_scene("image").to(dev), 64),
                 ("textured checker", grad_scene("checker").to(dev), 64),
                 ("many-slots", many_slots_scene().to(dev), 64)),
        dev, smi.splitlines()[0], time_case="bunny")
    many_slots_grads(dev, smi.splitlines()[0])
    del cases
    print(f"phase 2g took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("3 wide kernel vs plain")
    wide = wide_route(bunny)
    print(f"bunny scene built in {bunny_s:.2f} s: "
          f"{bunny.meta.n_blas_tris[0]} BLAS rows, "
          f"{bunny.pack.inst_wide[0].bounds.shape[0]} wide nodes, depth "
          f"{bunny.pack.inst_wide[0].depth}; wide walk: "
          f"{wide_bvh.blocks_per_sm()} resident blocks per SM, "
          f"{wide_bvh.load_kernel().wide_bvh_walk_warps(0, 1, 0)} persistent "
          "warps", flush=True)
    if bunny.meta.wide_blas != (True,):
        raise AssertionError("the default bunny is not on the wide kernel")
    wide_err = max(
        compare_modes(wide, "wave", *wave_rays(bunny, 256, 5, dev)),
        compare_modes(wide, "targeted",
                      *targeted_rays(bunny, wide, 1 << 16, 6, dev)))
    wide_times = time_wide(bunny, wide, dev)
    wide_err = max(wide_err, wide_times["err"])

    phase("4 main path (wide route)")
    frame_launches = main_path(bunny, dev, "bunny")
    wide_launches = frame_launches["wide_bvh"]
    with plain_streams():
        # eager: a graph replays the streams it captured
        profile_wave(bunny, dev, "bunny, streams by the plain version,",
                     table=False, graph=False, draws=0)
    casts = wide_casts(bunny, dev)
    lights = sum(1 for lt in bunny.meta.lights if not lt.static_black)
    expected = n_waves(1024, 1024, 1, DEFAULT_CHUNK) * (6 + 5 * lights)
    if len(casts) != expected:
        raise AssertionError(f"one 1-spp wave made {len(casts)} wide casts, "
                             f"expected {expected}")
    casts_ms, casts_dev_ms = time_casts(casts)
    del casts

    phase("5 goldens")
    goldens(bunny, dev)

    phase("6 sweep kernel vs plain")
    print("sweep_bvh resident blocks per SM: "
          + ", ".join(f"{gp} groups {sweep_bvh.blocks_per_sm(gp)}"
                      for gp in (4096, sweep_bvh.max_groups())), flush=True)
    inst600, build_s = build_sweep_scene("bunny 600k instanced", dev,
                                         bunny_path=dense_obj(600_000))
    soup = build_sweep_scene("bunny 150k x4 soup", dev,
                             bunny_path=dense_obj(150_000),
                             instancing=False)[0]
    sweep_err = 0.0
    sweep_times = {}
    for label, scene in (("instanced", inst600), ("soup", soup)):
        route = sweep_route(scene)
        sweep_err = max(
            sweep_err,
            compare_modes(route, f"{label} wave",
                          *wave_rays(scene, 256, 5, dev)),
            compare_modes(route, f"{label} targeted",
                          *targeted_rays(scene, route, 1 << 16, 6, dev)))
        sweep_times[label] = time_sweep(scene, route, label, dev)
        sweep_err = max(sweep_err, sweep_times[label]["err"])
    del soup

    phase("7 main path (sweep route)")
    print(f"bunny 600k instanced: scene build {build_s:.2f} s", flush=True)
    vertex.update(vertex_phase((("bunny 600k", inst600, 1024),), dev,
                               smi.splitlines()[0]))
    rays.update(rays_phase((("bunny 600k", inst600, 1024),), dev,
                           smi.splitlines()[0]))
    glue.update(wave_phase((("bunny 600k", inst600, 1024),), dev,
                           smi.splitlines()[0]))
    sweep_frame = main_path(inst600, dev, "bunny 600k")
    sweep_launches = sweep_frame["sweep_bvh"]
    sort_effect(inst600, dev, "bunny 600k")

    phase("8 sweep primitives")
    prim = prims(dev)

    phase("9 wide-kernel primitives (K4)")
    probe_launches, probe_ns, probe_total, probe_by, probe_err = probes(dev)

    phase("10 command line")
    cli_phase(dev)

    phase("11 differentiable path")
    diff = diff_phase(dev, smi.splitlines()[0])
    print(json.dumps({"diff": diff}), flush=True)

    phase("12 sharded render and train (parallel/)")
    t0 = time.perf_counter()
    sharded = sharded_phase(dev, smi.splitlines()[0])
    sharded["phase_s"] = time.perf_counter() - t0
    print(f"phase 12 took {sharded['phase_s']:.1f} s", flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)

    phase("13 compiled wave")
    t0 = time.perf_counter()
    try:
        import triton
        triton_note = f"import triton works: triton {triton.__version__}"
    except Exception as e:  # recorded, not needed: no kernel uses Triton
        triton_note = f"import triton fails: {e!r}"
    print(f"{triton_note} (torch {torch.__version__})", flush=True)
    compiled = compiled_phase((("bunny", bunny, 1024, 4),
                               ("bunny 600k", inst600, 1024, 4),
                               ("cornell", cornell, 512, 16)),
                              dev, smi.splitlines()[0])
    compiled["phase_s"] = time.perf_counter() - t0
    compiled["triton"] = triton_note
    print(f"phase 13 took {compiled['phase_s']:.1f} s", flush=True)
    print(json.dumps({"graph": compiled}), flush=True)

    print(f"chip_smoke.py took {time.perf_counter() - _START:.1f} s",
          flush=True)
    k_ms, p_ms, p_rays = sweep_times["instanced"]["closest"]
    # no single PyTorch call computes any of these functions (BVH
    # traversal, K3's min-sum epilogue, K4's dependent recurrences, the
    # Threefry hash)
    print(json.dumps({"kernels": [
        {"name": "wide_bvh", "route": "cuda",
         "source": "jet_pbrt_tpu_torch/csrc/wide_bvh.cu",
         "replaces": "jet_pbrt_tpu/ops/wide_bvh.py:315",
         "launches": wide_launches, "max_abs_err": wide_err,
         "ms": wide_times["wave", "closest"][0],
         "plain_ms": wide_times["wave", "closest"][1],
         "bound_ms": wide_times["bound", "wave"][0],
         "bound_by": wide_times["bound", "wave"][1], "library_ms": None,
         "device_ms": wide_times["dev", "wave"],
         "targeted_ms": wide_times["targeted", "closest"][0],
         "targeted_bound_ms": wide_times["bound", "targeted"][0],
         "wave_casts_ms": casts_ms, "wave_casts_device_ms": casts_dev_ms,
         "sharded_launches": {k: v["wide_bvh"]
                              for k, v in sharded["launches"].items()}},
        {"name": "sweep_bvh", "route": "cuda",
         "source": "jet_pbrt_tpu_torch/csrc/sweep_bvh.cu",
         "replaces": "jet_pbrt_tpu/ops/sweep_bvh.py:192",
         "launches": sweep_launches, "max_abs_err": sweep_err,
         "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": sweep_times["instanced"]["bound"][0],
         "bound_by": sweep_times["instanced"]["bound"][1],
         "library_ms": None, "rays": 1 << 20, "plain_rays": p_rays},
        {"name": "sweep_prims", "route": "cuda",
         "source": "jet_pbrt_tpu_torch/csrc/sweep_prims.cu",
         "replaces": "scripts/sweep_prims.py:16",
         "launches": prim["launches"], "max_abs_err": prim["err"],
         "ms": prim["ms"], "plain_ms": prim["plain_ms"],
         "bound_ms": prim["bound"][0], "bound_by": prim["bound"][1],
         "library_ms": None, "device_ms": prim["device_ms"],
         "enqueue_ms": prim["enqueue_ms"]},
        {"name": "prim_micro", "route": "cuda",
         "source": "jet_pbrt_tpu_torch/csrc/prim_micro.cu",
         "replaces": "scripts/prim_micro.py:28",
         "launches": probe_launches, "max_abs_err": probe_err,
         "ms": probe_total["ms"], "plain_ms": probe_total["plain_ms"],
         "bound_ms": probe_total["bound_ms"], "bound_by": probe_by,
         "library_ms": None, "reps": prim_micro.REPS,
         "probes": probe_ns},
        {"name": "threefry", "route": "cuda",
         "source": "jet_pbrt_tpu_torch/csrc/threefry.cu",
         "replaces": "jax.random threefry (XLA; no Pallas kernel)",
         "launches": frame_launches["threefry"],
         "max_abs_err": streams["err"], "ms": streams["ms"],
         "plain_ms": streams["plain_ms"], "bound_ms": streams["bound"][0],
         "bound_by": streams["bound"][1], "library_ms": None,
         "device_ms": streams["device_ms"],
         "enqueue_ms": streams["enqueue_ms"],
         "lane_keys": {k: streams["lane_keys"][k] for k in (
             "ms", "device_ms", "enqueue_ms", "plain_ms")}
         | {"bound_ms": streams["lane_keys"]["bound"][0]},
         "lanes": 1 << 20, "s": rng_s,
         "sharded_launches": {k: v["threefry"]
                              for k, v in sharded["launches"].items()}}]
        + [{"name": name, "route": "cuda",
            "source": "jet_pbrt_tpu_torch/csrc/shade.cu",
            "replaces": "jet_pbrt_tpu/models/integrators.py:108 (li_path's "
                        "vertex under jax.jit(wave): XLA fusion, no Pallas "
                        "kernel)",
            "launches": frame_launches[name],
            "max_abs_err": max(v["max_abs_err"] for k, v in vertex.items()
                               if k != "times"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call computes a path vertex
            "library_ms": None, "device_ms": t["device_ms"],
            "device_cold_ms": t["device_cold_ms"],
            "enqueue_ms": t["enqueue_ms"], "bytes": t["bytes"],
            "flops": t["flops"], "lanes": t["lanes"], "bounce": t["bounce"],
            "sweep_launches": sweep_frame[name],
            "sharded_launches": {k: v[name]
                                 for k, v in sharded["launches"].items()}}
           for name, t in vertex["times"].items()]
        + [{"name": "brute_hits", "route": "cuda",
            "source": "jet_pbrt_tpu_torch/csrc/brute.cu",
            "replaces": "jet_pbrt_tpu/ops/intersect.py:72 (the brute-force "
                        "[M, N] shape tests, :72-215, under jax.jit(wave): "
                        "XLA fusion, no Pallas kernel)",
            "launches": frame_launches["brute_hits"],
            "max_abs_err": max(v["max_abs_err"] for k, v in
                               (*brute.items(), *edges.items())
                               if k != "times"),
            "ms": bt["ms"], "plain_ms": bt["plain_ms"],
            "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
            # no PyTorch call intersects rays with shapes
            "library_ms": None, "device_ms": bt["device_ms"],
            "device_cold_ms": bt["device_cold_ms"],
            "enqueue_ms": bt["enqueue_ms"], "bytes": bt["bytes"],
            "flops": bt["work"]["flops"], "lanes": bt["lanes"],
            "flop_bound_ms": bt["flop_bound_ms"],
            "shadow": {k: brute["times"]["shadow"][k] for k in (
                "ms", "device_ms", "device_cold_ms", "plain_ms", "bound_ms",
                "bound_by", "flop_bound_ms")},
            "sweep_launches": sweep_frame["brute_hits"],
            "sharded_launches": {k: v["brute_hits"]
                                 for k, v in sharded["launches"].items()}}
           for bt in (brute["times"]["closest"],)]
        + [{"name": name, "route": "cuda",
            "source": "jet_pbrt_tpu_torch/csrc/rays.cu",
            "replaces": RAYS_REPLACES[name],
            "launches": frame_launches[name],
            "max_abs_err": max(v["max_abs_err"] for k, v in
                               (*rays.items(), *rays_edge.items())
                               if k != "times"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": next((v["ms"] for v in t["library_ms"].values()),
                               None),
            "library": t["library_ms"], "device_ms": t["device_ms"],
            "device_cold_ms": t["device_cold_ms"],
            "enqueue_ms": t["enqueue_ms"], "bytes": t["bytes"],
            "lanes": t["lanes"],
            **({"bounce": {k: rays["times"]["shadow_key bounce"][k] for k in (
                "ms", "device_ms", "device_cold_ms", "plain_ms", "bound_ms",
                "bytes")}} if name == "shadow_key" else {}),
            "sweep_launches": sweep_frame[name],
            "sharded_launches": {k: v[name]
                                 for k, v in sharded["launches"].items()}}
           for name in RAYS for t in (rays["times"][name],)]
        + [{"name": name, "route": "cuda",
            "source": "jet_pbrt_tpu_torch/csrc/wave.cu",
            "replaces": WAVE_REPLACES[name],
            "launches": frame_launches[name],
            "max_abs_err": max(v["max_abs_err"] for k, v in glue.items()
                               if k != "times"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # the camera: no PyTorch call makes camera rays
            "library_ms": next((v["ms"] for k, v in t["library_ms"].items()
                                if k != "gathers"), None),
            "library": t["library_ms"], "device_ms": t["device_ms"],
            "device_cold_ms": t["device_cold_ms"],
            "enqueue_ms": t["enqueue_ms"], "bytes": t["bytes"],
            "lanes": t["lanes"], "sweep_launches": sweep_frame[name],
            "sharded_launches": {k: v[name]
                                 for k, v in sharded["launches"].items()}}
           for name in WAVE for t in (glue["times"][name],)]
        + [{"name": name, "route": "cuda", "source": GRAD_SOURCE[name],
            "replaces": GRAD_REPLACES[name],
            # the main path of the gradient: phase 11's backward of the
            # bunny's loss
            "launches": diff["runs"][0]["backward_launches"][name],
            "max_abs_err": max(v["max_abs_err"] for k, v in grads.items()
                               if k != "times"),
            "field_rel_err": max(v["field_rel"] for k, v in grads.items()
                                 if k != "times"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": next((v["ms"] for v in t["library_ms"].values()),
                               None),
            "library": t["library_ms"], "device_ms": t["device_ms"],
            "device_cold_ms": t["device_cold_ms"],
            "enqueue_ms": t["enqueue_ms"], "bytes": t["bytes"],
            "flops": t["flops"], "lanes": t["lanes"],
            "sharded_backward_launches": sharded["train_launches"][
                "backward"][name]}
           for name in GRAD for t in (grads["times"][name],)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
