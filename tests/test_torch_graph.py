"""The compiled wave's parts that run without a card (models/graph.py).

Capture safety: a CUDA graph captures only work that stays on the card, so
one wave of every configuration the frame runs is recorded op by op
(TorchDispatchMode) on the CPU, and no operation may read a value back to
the host (`_local_scalar_dense`: .item(), int(), bool()), make a shape
from data (`nonzero`, `masked_select`, `unique*`, indexing by a boolean
mask) or copy host data to the device (`lift_fresh`: torch.tensor,
new_tensor); the same wave under two seeds must run the same operations on
the same shapes. The plain traversals (the kernels' CPU stand-ins, which
use nonzero) are left out of the record. Cases: the Cornell box at 16^2,
depth 3, with each integrator, MIS and NEE on and off, the stratified
sampler and the ray sort; and a small scene with every material, light
and shape kind and an instanced mesh, on the wide route and forced onto
the sweep.

Then the cache key, the launch registry and its replay accounting (a
replay counts its graph's kernel nodes by device function, held against
what the wrappers counted while capturing), the cache's eviction, a key's
eager calls before its capture, the route render(graph=...) takes, and
the CPU guard. The graphed frame itself
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py phase 13).
JAX-free.
"""
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jet_pbrt_tpu_torch.models import graph as G
from jet_pbrt_tpu_torch.models import render as R
from jet_pbrt_tpu_torch.ops import brute as TB
from jet_pbrt_tpu_torch.ops import launches as L
from jet_pbrt_tpu_torch.ops import rays as TRAY
from jet_pbrt_tpu_torch.ops import wave as TWAVE
from jet_pbrt_tpu_torch.ops import rng as TR
from jet_pbrt_tpu_torch.ops import shade as TSH
from jet_pbrt_tpu_torch.ops import sweep_bvh as TS
from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from jet_pbrt_tpu_torch.scene import scenes as tscenes
from jet_pbrt_tpu_torch.scene.builder import SceneBuilder
from jet_pbrt_tpu_torch.scripts import prim_micro, sweep_prims

torch.set_num_threads(2)

RES = 16
DEPTH = 3
# what a captured wave may not do (see the module docstring)
FORBIDDEN = ("aten::_local_scalar_dense", "aten::nonzero",
             "aten::masked_select", "aten::lift_fresh", "aten::equal",
             "aten::is_nonzero")
INDEXING = ("aten::index", "aten::index_put", "aten::index_put_")


class OpRecord(TorchDispatchMode):
    """Every aten op dispatched while open: (name, output shapes, whether
    it indexes by a boolean mask), except while `paused`."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            name = func._schema.name
            masked = name in INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None)
            shapes = tuple(tuple(x.shape) for x in
                           (out if isinstance(out, (tuple, list)) else (out,))
                           if isinstance(x, torch.Tensor))
            self.ops.append((name, shapes, masked))
        return out


@pytest.fixture
def unrecorded_traversals(monkeypatch):
    """Pauses the record inside the plain traversals while it is set."""
    holder = {}

    def paused(fn):
        def call(*a, **kw):
            holder["mode"].paused += 1
            try:
                return fn(*a, **kw)
            finally:
                holder["mode"].paused -= 1
        return call

    monkeypatch.setattr(TW, "intersect_wide_plain",
                        paused(TW.intersect_wide_plain))
    monkeypatch.setattr(TS, "intersect_sweep_plain",
                        paused(TS.intersect_sweep_plain))
    return holder


def _every_kind(sweep: bool, monkeypatch):
    """Every material (matte, mirror, glass, plastic, metal, rough glass,
    phong), light (point, directional, area, env) and shape kind (rect,
    sphere, disk, triangle soup, instanced mesh); the instanced mesh on
    the wide route, or on the sweep with the wide budget set low."""
    if sweep:
        monkeypatch.setattr(TW, "_VMEM_BUDGET", 1024)
    rng = np.random.default_rng(5)
    b = SceneBuilder("every-kind")
    b.set_camera(lookfrom=(0, 1.5, 9), lookat=(0, 0, 0), vfov=55)
    b.add_rect_xz(-6, 6, -6, 6, -2, b.add_matte((0.7, 0.7, 0.7)))
    b.add_sphere((2.5, -0.8, 0.5), 1.0, b.add_glass(1.5))
    b.add_sphere((-2.5, -0.8, 0.5), 0.8, b.add_roughglass(1.4, 0.3))
    b.add_disk((0, -1.9, 2.5), (0, 1, 0), 0.8, b.add_mirror((0.9, 0.9, 0.9)))
    b.add_mesh(rng.uniform(-0.4, 0.4, (6, 3, 3)) + (0.0, 2.0, -1.0),
               b.add_phong((0.6, 0.6, 0.6), 20.0))
    metal = b.add_metal((0.2, 0.9, 1.1), (3.9, 2.4, 2.1), 0.25, 0.25)
    plastic = b.add_plastic((0.5, 0.3, 0.2), (0.4, 0.4, 0.4), 0.3)
    base = rng.uniform(-1, 1, (200, 1, 3))
    b.add_instanced_mesh(base + rng.uniform(-0.3, 0.3, (200, 3, 3)),
                         [((0, 0, 0), 1.0, plastic), ((0, 0, -2.5), 0.8,
                                                      metal)])
    b.add_area_light(b.add_rect_xz(-1, 1, -1, 1, 4, b.add_matte(
        (0.6, 0.6, 0.6)), flip_normal=True), (8.0, 8.0, 8.0))
    b.add_point_light((1, 3, 2), (5.0, 5.0, 5.0))
    b.add_directional_light((0.3, -1, 0.2), (0.5, 0.5, 0.5))
    b.add_env_light((0.1, 0.15, 0.2))
    scene = b.build()
    assert scene.meta.pallas_blas == (sweep,)
    assert scene.meta.wide_blas == (not sweep,)
    return scene


CORNELL_CASES = {
    "path": dict(),
    "path-mis": dict(mis=True),
    "path-no-nee": dict(nee=False),
    "path-mis-no-nee": dict(mis=True, nee=False),
    "path-stratified": dict(sampler="stratified", spp=4),
    "path-sorted": dict(sort_rays=True),
    "path-stats": dict(with_stats=True),
    "whitted": dict(integrator="whitted"),
    "debug": dict(integrator="debug"),
    "debug-sampler": dict(sampler="debug"),
}


def _record(scene, kw, seed, holder):
    _, pack, cam = R.setup(scene, RES, RES, "cpu")
    wave = R.wave_fn(scene.meta, RES, DEPTH, seed=seed, **kw)
    pixel = torch.arange(RES * RES)
    sample = torch.full_like(pixel, 3)
    mode = holder["mode"] = OpRecord()
    with torch.no_grad(), mode:
        wave(pack, cam, sample, pixel)
    return mode.ops


def _assert_capture_safe(scene, kw, holder):
    first = _record(scene, kw, 1, holder)
    bad = sorted({name for name, _, masked in first
                  if masked or name in FORBIDDEN or "unique" in name})
    assert not bad, bad
    assert first == _record(scene, kw, 2, holder)


@pytest.mark.parametrize("case", sorted(CORNELL_CASES))
def test_cornell_wave_is_capture_safe(case, unrecorded_traversals):
    _assert_capture_safe(tscenes.cornell_box(), CORNELL_CASES[case],
                         unrecorded_traversals)


@pytest.mark.parametrize("route", ["wide", "sweep"])
@pytest.mark.parametrize("kw", [dict(), dict(mis=True, with_stats=True),
                                dict(integrator="whitted")],
                         ids=["path", "path-mis-stats", "whitted"])
def test_kernel_routed_wave_is_capture_safe(route, kw, unrecorded_traversals,
                                            monkeypatch):
    scene = _every_kind(route == "sweep", monkeypatch)
    _assert_capture_safe(scene, kw, unrecorded_traversals)


def test_record_sees_what_capture_refuses():
    """The audit's own check: a host read, a data-made shape and a host
    copy are each recorded under a name it refuses."""
    x = torch.arange(8.0)
    mode = OpRecord()
    with mode:
        float(x.sum())
        x[x > 3]
        x.nonzero()
        x.new_tensor([1.0, 2.0])
    names = {n for n, _, masked in mode.ops if n in FORBIDDEN or masked}
    assert {"aten::_local_scalar_dense", "aten::nonzero",
            "aten::lift_fresh"} <= names
    assert any(masked for *_, masked in mode.ops)


def _static(meta, seed=0, **kw):
    args = dict(integrator="path", mis=False, nee=True, sampler="random",
                spp=None, seed=seed, sort_rays=None, with_stats=False) | kw
    return (meta, RES, DEPTH) + tuple(args.values())


def test_cache_key_distinguishes_what_the_wave_bakes_in(monkeypatch):
    """Two seeds, two lane counts, two metas and changed WideTables
    scalars each give their own key; the same shapes with other values
    (another material colour) share one."""
    cornell = tscenes.cornell_box()
    scene = _every_kind(False, monkeypatch)
    _, pack, cam = R.setup(scene, RES, RES, "cpu")
    pixel = torch.arange(RES * RES)
    sample = torch.zeros_like(pixel)
    key = lambda static, pk=pack, n=RES * RES: G.wave_key(
        static, pk, cam, sample[:n], pixel[:n])
    base = key(_static(scene.meta))
    wide = pack.inst_wide[0]
    others = [key(_static(scene.meta, seed=1)),
              key(_static(scene.meta), n=RES * RES // 2),
              key(_static(cornell.meta)),
              key(_static(scene.meta, with_stats=True)),
              key(_static(scene.meta), pk=pack._replace(
                  inst_wide=(wide._replace(blas_root=wide.blas_root + 1),))),
              key(_static(scene.meta), pk=pack._replace(
                  inst_wide=(wide._replace(depth=wide.depth + 1),)))]
    assert len({base, *others}) == len(others) + 1
    recoloured = pack._replace(mat_c0=pack.mat_c0 * 0.5)
    assert key(_static(scene.meta), pk=recoloured) == base
    assert hash(key(_static(scene.meta))) == hash(base)


def test_sweep_tables_scalars_are_in_the_key(monkeypatch):
    scene = _every_kind(True, monkeypatch)
    _, pack, cam = R.setup(scene, RES, RES, "cpu")
    pixel = torch.arange(RES * RES)
    sw = pack.inst_sweep[0]
    keys = {G.wave_key(_static(scene.meta), pk, cam, pixel, pixel)
            for pk in (pack, pack._replace(inst_sweep=(sw._replace(
                n_groups=sw.n_groups + 1),)), pack._replace(
                inst_sweep=(sw._replace(n_inst=sw.n_inst + 1),)))}
    assert len(keys) == 3


@pytest.fixture
def counters(monkeypatch):
    for mod, name in L.REGISTRY.values():
        monkeypatch.setattr(getattr(sys.modules[mod], name), "launches", 10)


def _wave_counts():
    return {k: v for k, v in L.counts().items() if k in WAVE_KERNELS}


WAVE_KERNELS = ("wide_walk_kernel", "sweep_bvh_kernel", "lane_keys_kernel",
                "uniforms_kernel")


def test_every_kernel_wrapper_is_registered():
    """Each kernel wrapper of the port counts its kernel's device function
    in the registry, through its own module."""
    assert L.REGISTRY == {
        "wide_walk_kernel": (TW.__name__, "intersect_wide"),
        "sweep_bvh_kernel": (TS.__name__, "intersect_sweep"),
        "lane_keys_kernel": (TR.__name__, "lane_keys"),
        "uniforms_kernel": (TR.__name__, "uniforms"),
        "sweep_prims_kernel": (sweep_prims.__name__, "sweep_prims"),
        "prim_micro_kernel": (prim_micro.__name__, "prim_micro"),
        "shade_vertex_kernel": (TSH.__name__, "shade_vertex"),
        "nee_accumulate_kernel": (TSH.__name__, "nee_accumulate"),
        "brute_hits_kernel": (TB.__name__, "brute_hits"),
        "shadow_key_kernel": (TRAY.__name__, "shadow_key"),
        "shadow_segments_kernel": (TRAY.__name__, "shadow_segments"),
        "occlusion_merge_kernel": (TRAY.__name__, "occlusion_merge"),
        "hit_reconstruct_kernel": (TRAY.__name__, "hit_reconstruct"),
        "camera_rays_kernel": (TWAVE.__name__, "camera_rays"),
        "permute_state_kernel": (TWAVE.__name__, "permute_state"),
        "unsort_guard_kernel": (TWAVE.__name__, "unsort_guard"),
        "vertex_backward_kernel": (TSH.__name__, "vertex_backward"),
        "grad_reduce_kernel": (TSH.__name__, "grad_reduce"),
        "permute_state_backward_kernel": (TWAVE.__name__,
                                          "permute_state_backward"),
        "unsort_guard_backward_kernel": (TWAVE.__name__,
                                         "unsort_guard_backward")}
    assert all(isinstance(v, int) for v in L.counts().values())


def test_launches_counted_apart_and_added_per_replay(counters):
    """What a capture counts is taken back (nothing ran) and each replay
    adds it: a wave of 3 wide casts and 2 uniforms draws, replayed twice,
    counts 6 and 4 launches."""
    def capture():
        TW.intersect_wide.launches += 3
        TR.uniforms.launches += 2
        return "outputs"

    out, delta = L.counted_apart(capture)
    assert out == "outputs"
    assert delta == dict.fromkeys(L.REGISTRY, 0) | {"wide_walk_kernel": 3,
                                                     "uniforms_kernel": 2}
    assert set(L.counts().values()) == {10}
    L.add(delta)
    L.add(delta)
    assert _wave_counts() == {"wide_walk_kernel": 16, "sweep_bvh_kernel": 10,
                              "lane_keys_kernel": 10, "uniforms_kernel": 14}
    assert (TW.intersect_wide.launches, TS.intersect_sweep.launches,
            TR.lane_keys.launches, TR.uniforms.launches) == (16, 10, 10, 14)


def test_failed_capture_takes_its_counts_back(counters):
    def capture():
        TS.intersect_sweep.launches += 5
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        L.counted_apart(capture)
    assert set(L.counts().values()) == {10}


def test_counts_follow_a_function_set_in_a_wrappers_place(counters,
                                                          monkeypatch):
    """A caller's wrapper set in the module (chip_smoke's recorders) is
    the counter a replay adds to; a stand-in that keeps no count (an A/B
    build's launcher) reads None and is left alone."""
    def stand_in(*a, **kw):
        return None

    def uncounted(*a, **kw):
        return None

    stand_in.launches = 0
    monkeypatch.setattr(TR, "lane_keys", stand_in)
    monkeypatch.setattr(TW, "intersect_wide", uncounted)
    assert _wave_counts() == {"wide_walk_kernel": None,
                              "sweep_bvh_kernel": 10, "lane_keys_kernel": 0,
                              "uniforms_kernel": 10}
    L.add({"lane_keys_kernel": 2, "wide_walk_kernel": 3})
    assert stand_in.launches == 2 and not hasattr(uncounted, "launches")
    _, delta = L.counted_apart(lambda: None)
    assert delta["wide_walk_kernel"] is None and delta["lane_keys_kernel"] == 0


# device function names as the CUDA driver API gives them for the port's kernels
# (templates mangled) and for kernels of PyTorch's, and a decoy whose name
# starts with a registered one's
NODE_NAMES = [
    "_Z16wide_cull_kernelILb0EEvPK6float4PK4int4PKfS7_S7_S7_iPiS8_Px",
    "_Z16wide_walk_kernelILb0ELb1ELb0EEvPK6float4PK4int4PKfS7_S7_S7_S7_iPfPiS9_S8_Px",
    "_Z16wide_walk_kernelILb1ELb1ELb0EEvPK6float4PK4int4PKfS7_S7_S7_S7_iPfPiS9_S8_Px",
    "_Z16lane_keys_kerneljPKxS0_ijPjS1_",
    "_Z15uniforms_kernelILi8EEvPKjS1_ijPf",
    "_Z15uniforms_kernelILi2EEvPKjS1_ijPf",
    "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEENS_6detail5ArrayIPcLi1EEEEEviT0_T1_",
    "_Z21wide_walk_kernel_tailv",
    "sweep_bvh_kernel",
    "_ZN12_GLOBAL__N_119shade_vertex_kernelE9ShadeArgs",
    "_ZN12_GLOBAL__N_121nee_accumulate_kernelEPKfPKhS3_S1_iiPf",
    "_ZN12_GLOBAL__N_117brute_hits_kernelILb0EEEvNS_4ArgsE",
    "_ZN12_GLOBAL__N_117brute_hits_kernelILb1EEEvNS_4ArgsE",
    "_ZN12_GLOBAL__N_117shadow_key_kernelILb0EEEv7KeyArgs",
    "_ZN12_GLOBAL__N_117shadow_key_kernelILb1EEEv7KeyArgs",
    "_ZN12_GLOBAL__N_122shadow_segments_kernelE7SegArgs",
    "_ZN12_GLOBAL__N_122occlusion_merge_kernelE9MergeArgs",
    "_ZN12_GLOBAL__N_122hit_reconstruct_kernelE7HitArgs",
    "_ZN12_GLOBAL__N_118camera_rays_kernelE10CameraArgs",
    "_ZN12_GLOBAL__N_120permute_state_kernelE11PermuteArgs",
    "_ZN12_GLOBAL__N_119unsort_guard_kernelE10UnsortArgs",
    "_ZN12_GLOBAL__N_122vertex_backward_kernelILi0EEEv8GradArgs",
    "_ZN12_GLOBAL__N_122vertex_backward_kernelILi2EEEv8GradArgs",
    "_ZN12_GLOBAL__N_118grad_reduce_kernelEPKfiiPf",
]


def test_graph_kernel_nodes_counted_by_device_function():
    assert L.kernel_nodes(NODE_NAMES) == {
        "wide_walk_kernel": 2, "sweep_bvh_kernel": 1, "lane_keys_kernel": 1,
        "uniforms_kernel": 2, "sweep_prims_kernel": 0, "prim_micro_kernel": 0,
        "shade_vertex_kernel": 1, "nee_accumulate_kernel": 1,
        "brute_hits_kernel": 2, "shadow_key_kernel": 2,
        "shadow_segments_kernel": 1, "occlusion_merge_kernel": 1,
        "hit_reconstruct_kernel": 1, "camera_rays_kernel": 1,
        "permute_state_kernel": 1, "unsort_guard_kernel": 1,
        "vertex_backward_kernel": 2, "grad_reduce_kernel": 1,
        "permute_state_backward_kernel": 0,
        "unsort_guard_backward_kernel": 0}
    assert not L.is_function("wide_walk_kernel_tail", "wide_walk_kernel")
    assert not L.is_function("x16wide_walk_kernel", "wide_walk_kernel")


def test_replay_counts_the_graph_and_holds_it_against_the_wrappers():
    """A replay counts the graph's kernel nodes; a wrapper that counted
    other launches while capturing makes the capture raise, one that keeps
    no count is not held."""
    nodes = {"wide_walk_kernel": 16, "uniforms_kernel": 6}
    assert G.replay_launches({"wide_walk_kernel": 16, "uniforms_kernel": 6},
                             nodes) == nodes
    assert G.replay_launches({"wide_walk_kernel": None, "uniforms_kernel": 6},
                             nodes) == nodes
    with pytest.raises(RuntimeError, match="kernel nodes differ"):
        G.replay_launches({"wide_walk_kernel": 16, "uniforms_kernel": 5},
                          nodes)


class _Entry:
    def __init__(self, name, released):
        self.name, self.released = name, released

    def release(self):
        self.released.append(self.name)


def test_cache_keeps_the_most_recent_entries():
    released = []
    cache = G.GraphCache(max_entries=2)
    for k in ("a", "b"):
        cache.put(k, _Entry(k, released))
    assert cache.get("a").name == "a"
    cache.put("c", _Entry("c", released))
    assert released == ["b"] and list(cache.entries) == ["a", "c"]
    assert cache.get("b") is None
    cache.clear()
    assert sorted(released) == ["a", "b", "c"] and not cache.entries


class _Capture:
    """A stand-in for CapturedWave: counts its captures and replays."""
    made = []

    def __init__(self, wave, inputs):
        self.wave, self.replays = wave, 0
        self.warmup_outputs = ("warm-up", wave(*inputs))
        _Capture.made.append(self)

    def __call__(self, inputs):
        self.replays += 1
        return ("replay", self.wave(*inputs))

    def release(self):
        pass


@pytest.mark.parametrize("capture_after", [0, 1, 4])
def test_a_key_runs_eagerly_before_its_capture(capture_after):
    """A key's first capture_after calls run the wave op by op, the next
    captures it and returns the warm-up wave's outputs, later calls
    replay; another key counts apart, and a capture forgets the count."""
    _Capture.made = []
    cache = G.GraphCache()
    wave = lambda x: x + 1
    got = [cache.run("k", wave, (i,), capture_after, _Capture)
           for i in range(capture_after + 3)]
    assert got == [i + 1 for i in range(capture_after)] + [
        ("warm-up", capture_after + 1), ("replay", capture_after + 2),
        ("replay", capture_after + 3)]
    assert len(_Capture.made) == 1 and _Capture.made[0].replays == 2
    assert "k" not in cache.eager_calls
    assert cache.run("other", wave, (0,), capture_after, _Capture) == (
        1 if capture_after else ("warm-up", 1))


def test_eager_counts_keep_the_latest_keys():
    cache = G.GraphCache()
    for k in range(G.MAX_COUNTED + 5):
        assert cache.count_eager(k) == 0
    assert cache.count_eager(G.MAX_COUNTED + 4) == 1
    assert len(cache.eager_calls) == G.MAX_COUNTED and 0 not in \
        cache.eager_calls


def test_frame_wave_takes_the_route_graph_names(monkeypatch):
    """On the card graph=None compiles with CAPTURE_AFTER eager calls and
    graph=True with none; graph=False and the CPU take the eager wave."""
    made = []
    monkeypatch.setattr(G, "compile_wave",
                        lambda wave, static, after: made.append(after) or wave)
    meta = tscenes.cornell_box().meta
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for dev, graph in ((cuda, None), (cuda, True), (cuda, False),
                       (cpu, None), (cpu, False)):
        R.frame_wave_fn(dev, graph, meta, RES, DEPTH)
    assert made == [G.CAPTURE_AFTER, 0]


def test_render_graph_guard_on_the_cpu():
    """graph=True off the card raises; the CPU default is the eager wave,
    equal bit for bit to graph=False; the compiled wave refuses CPU
    tensors and inputs that require grad."""
    scene = tscenes.cornell_box()
    with pytest.raises(ValueError, match="graph=True"):
        R.render(scene, 8, 8, 1, graph=True, device="cpu")
    img = R.render(scene, 8, 8, 2, max_depth=2, device="cpu")
    assert torch.equal(img, R.render(scene, 8, 8, 2, max_depth=2,
                                     device="cpu", graph=False))
    _, pack, cam = R.setup(scene, 8, 8, "cpu")
    wave = R.compiled_wave_fn(scene.meta, 8, 2)
    pixel = torch.arange(64)
    with pytest.raises(ValueError, match="on the card"):
        wave(pack, cam, torch.zeros_like(pixel), pixel)
    with pytest.raises(ValueError, match="tensors of sample"):
        wave(pack, cam, 0, pixel)
    grad_pack = pack._replace(mat_c0=pack.mat_c0.clone().requires_grad_())
    with pytest.raises(ValueError, match="requires grad"):
        wave(grad_pack, cam, torch.zeros_like(pixel), pixel)
