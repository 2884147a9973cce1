"""chip_smoke's count of a kernel's SASS instructions, which prices the
integer kernels (Threefry, K4 srt) on the card: each opcode on the pipe
NVIDIA documents for it, loops scaled by the slots they store, and the
bound the largest of the pipes, the issue rate and the bytes (the
brute-force casts' float operations at the issue rate); and how it
reads device time from the profiler, which now and then drops records. On
synthetic SASS and a stand-in profiler, so it runs without the CUDA
toolkit or a card."""
import numpy as np
import pytest
import torch

import chip_smoke


def _code(*ops, loop_from=None):
    """[(address, opcode, operands)], 16 bytes apart; a "BRA" branches back
    to the instruction at index loop_from."""
    return [(16 * i, op, f" 0x{16 * loop_from:x}" if op == "BRA" else "")
            for i, op in enumerate(ops)]


@pytest.mark.parametrize("op,pipe", [
    ("IADD3", 0), ("VIADD", 0), ("ISETP.GE.AND", 0), ("LOP3.LUT", 0),
    ("SHF.L.W.U32.HI", 0), ("LEA.HI.X", 0), ("VIMNMX", 0), ("VIADDMNMX", 0),
    ("IMAD", 1), ("IMAD.IADD", 1), ("IMAD.MOV.U32", 1), ("IMAD.WIDE", 1),
    ("IMUL", 1), ("UIADD3", None), ("ULOP3.LUT", None), ("FADD", None),
    ("STG.E", None), ("LDS.128", None)])
def test_each_opcode_counts_on_its_pipe(op, pipe):
    """The ALU pipe takes every integer instruction but IMAD and IMUL,
    which take the FMA-heavy pipe; uniform-datapath, float and memory
    instructions count only among all instructions."""
    alu, fma, total = chip_smoke.pipe_counts(_code(op, "EXIT"))
    assert (alu, fma, total) == (int(pipe == 0), int(pipe == 1), 2)


def test_slot_loop_scales_by_the_slots_it_stores():
    """A loop body storing one slot runs once per slot; straight-line code
    counts once; a rest of slots runs the code after the loop in
    proportion to its stores."""
    straight = _code("IMAD", "IADD3", "SHF", "STG.E", "EXIT")
    assert chip_smoke.sass_work(straight, 8) == (2.0, 1.0, 5.0)
    # pre: IMAD; body: IADD3 SHF STG BRA; after: ISETP STG EXIT
    loop = _code("IMAD", "IADD3", "SHF", "STG.E", "BRA", "ISETP", "STG.E",
                 "EXIT", loop_from=1)
    assert chip_smoke.sass_work(loop, 8) == (8 * 2 + 1, 1.0, 1 + 8 * 4 + 1)
    # two stores per body: 4 trips and 1 slot left, half the tail's 2 stores
    loop2 = _code("IMAD", "IADD3", "STG.E", "STG.E", "BRA", "ISETP",
                  "STG.E", "STG.E", "EXIT", loop_from=1)
    alu, fma, total = chip_smoke.sass_work(loop2, 9)
    assert (alu, fma) == (4 * 1 + 0.5 * 1, 1.0)
    assert total == 1 + 4 * 4 + 0.5 * 4


def test_bound_is_the_largest_pipe_issue_or_bytes(monkeypatch):
    """Per second: 64 ALU-pipe, 64 FMA-heavy-pipe and 128 issued thread
    instructions per SM clock; the bound takes the slowest, or the bytes
    at HBM_BW where those take longer."""
    monkeypatch.setattr(chip_smoke, "int_rates", lambda: (1e12, 1e12, 2e12))
    assert chip_smoke.bound(0, 0, (3e9, 1e9, 4e9)) == (3.0, "operations")
    assert chip_smoke.bound(0, 0, (1e9, 2.5e9, 4e9)) == (2.5, "operations")
    assert chip_smoke.bound(0, 0, (1e9, 1e9, 8e9)) == (4.0, "operations")
    ms, by = chip_smoke.bound(int(chip_smoke.HBM_BW * 1e-2), 0,
                              (1e9, 1e9, 2e9))
    assert by == "bytes" and ms == pytest.approx(10.0)


@pytest.mark.parametrize("s,alu,adds", [
    (2, 3 * 40 + 2 + 2 * 3, 3 * 31), (8, 9 * 40 + 2 + 8 * 3, 9 * 31),
    (13, 14 * 40 + 2 + 13 * 3, 14 * 31)])
def test_threefry_work_is_the_functions(s, alu, adds):
    """A uniforms call at width s needs 1 + s hashes (40 ALU-only
    instructions and 31 adds each), one schedule word per key and 3 ALU
    instructions and a float subtract per uniform; the adds fit on the
    FMA-heavy pipe, so the ALU pipe carries only what it alone runs."""
    work = chip_smoke.threefry_work(s)
    assert work["uniforms"] == (alu, adds, alu + adds + s)
    assert work["lane_keys"] == (2 * 40 + 1, 2 * 31, 2 * 40 + 1 + 2 * 31)


def test_threefry_bound_binds_on_the_alu_pipe(monkeypatch):
    """At 2^20 lanes and S = 8 the ALU-only work (386 per lane) outlasts
    the bytes (40 per lane) and the issue rate; lane_keys is bound by its
    bytes (24 per lane). Rates of an H100 SXM: 132 SMs at 1,980 MHz."""
    pipe = 64 * 132 * 1.98e9
    monkeypatch.setattr(chip_smoke, "int_rates", lambda: (pipe, pipe,
                                                          2 * pipe))
    n = 1 << 20
    (ms, by), (kms, kby) = chip_smoke.threefry_bounds(n, 8)
    assert by == "operations" and ms == pytest.approx(n * 386 / pipe * 1e3)
    assert kby == "bytes" and kms == pytest.approx(
        n * 24 / chip_smoke.HBM_BW * 1e3)


def test_brute_bound_prices_each_operation_as_an_issued_instruction(
        monkeypatch):
    """brute_bounds' "bound": brute_work's (lane, shape) tests x BRUTE_OPS,
    one issued instruction each at the issue rate (128 per SM clock: the
    kernel rounds each operation as the plain version does, so none is an
    FMA), binding over the same operations at F32_PEAK (an FMA counted
    twice) and over the bytes; "flop_bound" keeps the F32_PEAK price.
    Rates of an H100 SXM: 132 SMs at 1,980 MHz."""
    from jet_pbrt_tpu_torch.ops.intersect import BruteShapes
    issue = 128 * 132 * 1.98e9
    monkeypatch.setattr(chip_smoke, "int_rates",
                        lambda: (issue / 2, issue / 2, issue))
    g = np.random.default_rng(3)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    n, tris, sphs = 64, 100, 10
    o = f(g.uniform(-1, 1, (n, 3)))
    d = f(g.normal(size=(n, 3)))
    d = d / d.norm(dim=1, keepdim=True)
    tmin, tmax = torch.full((n,), 1e-3), torch.full((n,), float("inf"))
    tmin[::8], tmax[::8] = float("inf"), -1.0
    p0 = g.uniform(-2, 2, (tris, 3))
    shapes = BruteShapes(
        tri=(f(p0), f(p0 + g.uniform(-1, 1, (tris, 3))),
             f(p0 + g.uniform(-1, 1, (tris, 3)))),
        sph=(f(g.uniform(-2, 2, (sphs, 3))), f(g.uniform(0.1, 0.5, sphs))),
        rect=None, disk=None)
    b = chip_smoke.brute_bounds(o, d, tmin, tmax, shapes, False)
    live = n - n // 8
    ops = live * (tris * chip_smoke.BRUTE_OPS["tri"]
                  + sphs * chip_smoke.BRUTE_OPS["sph"])
    assert (b["work"]["live"], b["work"]["tri"], b["work"]["sph"]) == (
        live, live * tris, live * sphs)
    assert b["work"]["flops"] == ops
    assert b["bound"] == (pytest.approx(ops / issue * 1e3), "operations")
    assert b["flop_bound"] == (
        pytest.approx(ops / chip_smoke.F32_PEAK * 1e3), "operations")
    assert b["bound"][0] > 1.9 * b["flop_bound"][0]
    assert b["bytes"] / chip_smoke.HBM_BW * 1e3 < b["bound"][0]


class _Event:
    def __init__(self, key, count, us):
        self.key, self.count, self.self_device_time_total = key, count, us


def _fake_profiler(monkeypatch, runs):
    """torch.profiler.profile replaced by one that records runs[i] (a list
    of (name, count, device us)) on its i-th use; the card's calls and
    waits become no-ops. Returns the list of runs made."""
    made = []

    class Profile:
        def __init__(self, schedule, **_):
            self.schedule, self.step_num = schedule, 0

        def __enter__(self):
            return self

        def step(self):
            self.step_num += 1

        def __exit__(self, *_):
            # warm-up, then the one active step that is kept
            assert [self.schedule(k).name for k in range(3)] == [
                "WARMUP", "RECORD_AND_SAVE", "NONE"]
            assert self.step_num == 2
            made.append(len(made))

        def key_averages(self):
            return [_Event(*e) for e in runs[made[-1]]]

    monkeypatch.setattr("torch.profiler.profile", Profile)
    monkeypatch.setattr("torch.cuda.synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "PROFILER_WARMUP_S", 0.0)
    return made


WIDE = [("wide_cull_kernel", 5, 50.0), ("wide_walk_kernel", 5, 450.0),
        ("Memset (Device)", 5, 5.0), ("cudaLaunchKernel", 10, 0.0)]


@pytest.mark.parametrize("dropped", [
    [("Memset (Device)", 5, 5.0)],
    [],
    [("wide_cull_kernel", 5, 50.0), ("wide_walk_kernel", 4, 360.0),
     ("Memset (Device)", 5, 5.0)]])
def test_profiled_ms_makes_an_incomplete_run_again(monkeypatch, dropped):
    """A run whose records lack some calls of an operation every call
    launches (all kernels lost, everything lost, one walk lost) is made
    again; the complete run's device time per call is returned."""
    made = _fake_profiler(monkeypatch, [dropped, WIDE])
    out = chip_smoke.profiled_ms(lambda: None, 5, chip_smoke.WIDE_OPS)
    assert made == [0, 1]
    assert out == pytest.approx({"wide_cull_kernel": 0.01,
                                 "wide_walk_kernel": 0.09, "Memset": 0.001})


def test_profiled_ms_falls_back_to_queued_events(monkeypatch):
    """Where no run of PROFILER_TRIES is complete, the time is the events'
    behind a held stream, under its own key, never a partial sum."""
    made = _fake_profiler(monkeypatch, [[("Memset (Device)", 5, 5.0)]]
                          * chip_smoke.PROFILER_TRIES)
    monkeypatch.setattr(chip_smoke, "queued_events_ms", lambda fn, reps: 0.1)
    out = chip_smoke.profiled_ms(lambda: None, 5, chip_smoke.WIDE_OPS)
    assert len(made) == chip_smoke.PROFILER_TRIES
    assert out == {"queued events": 0.1}


def test_profiled_ms_each_names_what_every_call_launches(monkeypatch):
    """With each=() any recorded operation completes a run (a build that
    launches one of several names); with each naming an operation the
    calls do not launch, no run is complete."""
    pr4 = [("wide_bvh_kernel", 5, 400.0)]
    _fake_profiler(monkeypatch, [pr4])
    out = chip_smoke.profiled_ms(lambda: None, 5,
                                 chip_smoke.WIDE_OPS + ("wide_bvh_kernel",),
                                 each=())
    assert out["wide_bvh_kernel"] == pytest.approx(0.08)
    made = _fake_profiler(monkeypatch, [pr4] * chip_smoke.PROFILER_TRIES)
    monkeypatch.setattr(chip_smoke, "queued_events_ms", lambda fn, reps: 0.2)
    assert chip_smoke.profiled_ms(lambda: None, 5, ("wide_bvh_kernel",),
                                  each=("wide_cull_kernel",)) == {
        "queued events": 0.2}
    assert len(made) == chip_smoke.PROFILER_TRIES


def test_node_launches_count_the_fused_vertex():
    """A graph's kernel nodes by device function, as launch_counts names
    them: the fused vertex's two kernels, the brute-force casts',
    ops/rays.py's four, ops/wave.py's three and the gradient's four
    backward kernels beside the traversal and the streams."""
    from jet_pbrt_tpu_torch.ops.kernels import REGISTRY
    nodes = dict.fromkeys(REGISTRY, 0) | {
        "wide_walk_kernel": 16, "lane_keys_kernel": 1, "uniforms_kernel": 6,
        "shade_vertex_kernel": 6, "nee_accumulate_kernel": 5,
        "brute_hits_kernel": 16, "shadow_key_kernel": 7,
        "shadow_segments_kernel": 10, "occlusion_merge_kernel": 10,
        "hit_reconstruct_kernel": 6, "camera_rays_kernel": 1,
        "permute_state_kernel": 3, "unsort_guard_kernel": 1,
        "vertex_backward_kernel": 11, "grad_reduce_kernel": 6,
        "permute_state_backward_kernel": 3,
        "unsort_guard_backward_kernel": 1}
    assert chip_smoke.node_launches(nodes) == {
        "wide_bvh": 16, "sweep_bvh": 0, "threefry": 7, "shade_vertex": 6,
        "nee_accumulate": 5, "brute_hits": 16, "shadow_key": 7,
        "shadow_segments": 10, "occlusion_merge": 10, "hit_reconstruct": 6,
        "camera_rays": 1, "permute_state": 3, "unsort_guard": 1,
        "vertex_backward": 11, "grad_reduce": 6, "permute_state_backward": 3,
        "unsort_guard_backward": 1}
    assert set(chip_smoke.launch_counts()) == set(chip_smoke.TRACED_KERNELS)


@pytest.mark.parametrize("which", ["cornell", "bunny", "many-lights"])
def test_expected_launches_count_the_rays_kernels(which):
    """Per wave one hit_reconstruct per closest cast, one shadow_segments
    and one occlusion_merge per shadow cast, and, where a mesh is
    kernel-routed (the sorts' default), one shadow_key per sorted shadow
    cast (bounces 0 and 1) and per sort between bounces (bounces 0-2); at
    depth 1 one sorted bounce and one sort. Per rank of the sharded bunny
    frame the same, on the forward and the train step's film alike."""
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves
    from jet_pbrt_tpu_torch.scene import scenes
    meta = {"cornell": lambda: scenes.cornell_box(),
            "bunny": lambda: scenes.bunny_scene(),
            "many-lights": chip_smoke.many_lights_scene}[which]().meta
    lights = sum(1 for lt in meta.lights if not lt.static_black)
    waves = n_waves(512, 512, 16, DEFAULT_CHUNK)
    got = chip_smoke.expected_launches(meta, 512, 16, 5)
    keys = 2 * lights + 3 if meta.kernel_routed else 0
    assert {k: got[k] for k in chip_smoke.RAYS} == {
        "shadow_key": waves * keys, "shadow_segments": waves * 5 * lights,
        "occlusion_merge": waves * 5 * lights, "hit_reconstruct": waves * 6}
    assert (which == "cornell") != meta.kernel_routed
    one = chip_smoke.rays_launches(meta, 1, 1)
    assert one["shadow_key"] == (lights + 1 if meta.kernel_routed else 0)
    assert one["hit_reconstruct"] == 2
    for fused in (True, False):
        shard = chip_smoke.sharded_launches((2, 1), 2, fused=fused)
        local = chip_smoke.SHARD_SPP
        assert {k: shard[k] for k in chip_smoke.RAYS} == {
            "shadow_key": local * (2 * 2 + 3),
            "shadow_segments": local * chip_smoke.SHARD_DEPTH * 2,
            "occlusion_merge": local * chip_smoke.SHARD_DEPTH * 2,
            "hit_reconstruct": local * (chip_smoke.SHARD_DEPTH + 1)}


@pytest.mark.parametrize("fused", [True, False])
def test_expected_launches_count_one_vertex_per_bounce(fused):
    """Per wave, depth + 1 shade_vertex launches (the last the emission
    alone) and depth nee_accumulate launches on the fused route, none on
    the plain one (a path that differentiates); per rank of a sharded
    frame the same for each local sample."""
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves
    from jet_pbrt_tpu_torch.scene.scenes import cornell_box
    meta = cornell_box().meta
    waves = n_waves(64, 64, 4, DEFAULT_CHUNK)
    got = chip_smoke.expected_launches(meta, 64, 4, 5, fused=fused)
    assert (got["shade_vertex"], got["nee_accumulate"]) == (
        (6 * waves, 5 * waves) if fused else (0, 0))
    assert got["threefry"] == 7 * waves
    local = chip_smoke.SHARD_SPP // 2
    shard = chip_smoke.sharded_launches((2, 2), 2, fused=fused)
    assert (shard["shade_vertex"], shard["nee_accumulate"]) == (
        (local * (chip_smoke.SHARD_DEPTH + 1), local * chip_smoke.SHARD_DEPTH)
        if fused else (0, 0))


@pytest.mark.parametrize("which", ["cornell", "bunny", "cornell bvh"])
def test_expected_launches_count_one_brute_cast_per_cast(which):
    """One brute_hits per cast, (depth + 1) + depth x lights a wave, where
    the scene has a brute-force shape: the Cornell box's triangles, the
    bunny's two rects; none where every shape is in a BVH (the Cornell
    box built with use_bvh); per rank of the sharded bunny frame the
    same on the forward and the train step's film."""
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves
    from jet_pbrt_tpu_torch.scene import scenes
    meta = {"cornell": lambda: scenes.cornell_box(),
            "bunny": lambda: scenes.bunny_scene(),
            "cornell bvh": lambda: scenes.cornell_box(use_bvh=True)}[
        which]().meta
    lights = sum(1 for lt in meta.lights if not lt.static_black)
    waves = n_waves(512, 512, 16, DEFAULT_CHUNK)
    got = chip_smoke.expected_launches(meta, 512, 16, 5)
    casts = waves * (6 + 5 * lights)
    assert got["brute_hits"] == (0 if which == "cornell bvh" else casts)
    assert got["wide_bvh"] == (0 if which == "cornell" else casts)
    for fused in (True, False):
        shard = chip_smoke.sharded_launches((2, 1), 2, fused=fused)
        assert shard["brute_hits"] == shard["wide_bvh"] == (
            chip_smoke.SHARD_SPP * (chip_smoke.SHARD_DEPTH + 1
                                    + chip_smoke.SHARD_DEPTH * 2))


def test_replay_labels_follow_the_eager_waves_order():
    """A replay's operations take the ranges of the eager wave's in order;
    the replay call's input copies before them are "graph inputs"; a
    replay missing an eager operation is not split."""
    eager = ["fill", "walk", "shade", "walk"]
    labels = ["other", "li_path.intersect", "li_path.vertex",
              "li_path.occluded"]
    replay = ["Memcpy DtoD", "Memcpy DtoD", "fill", "walk", "shade", "walk"]
    from jet_pbrt_tpu_torch.scripts import wave_nodes
    assert wave_nodes.replay_labels(eager, labels, replay) == [
        "graph inputs", "graph inputs", "other", "li_path.intersect",
        "li_path.vertex", "li_path.occluded"]
    assert wave_nodes.replay_labels(eager, labels, replay[:-1]) is None


@pytest.mark.parametrize("which", ["cornell", "bunny"])
@pytest.mark.parametrize("fused", [True, False])
def test_expected_launches_count_the_wave_kernels(which, fused):
    """Per wave one camera_rays on every path; on the fused route one
    unsort_guard and, where the sorts default on (a kernel-routed scene),
    one permute_state per sort between bounces (bounces 0-2 below depth);
    none of the two on a path that differentiates. Per rank of the sharded
    bunny frame the same for each local sample."""
    from jet_pbrt_tpu_torch.models.render import DEFAULT_CHUNK, n_waves
    from jet_pbrt_tpu_torch.scene import scenes
    meta = {"cornell": lambda: scenes.cornell_box(),
            "bunny": lambda: scenes.bunny_scene()}[which]().meta
    waves = n_waves(512, 512, 16, DEFAULT_CHUNK)
    got = chip_smoke.expected_launches(meta, 512, 16, 5, fused=fused)
    sorts = 3 if meta.kernel_routed else 0
    assert {k: got[k] for k in chip_smoke.WAVE} == {
        "camera_rays": waves, "permute_state": waves * sorts if fused else 0,
        "unsort_guard": waves if fused else 0}
    assert chip_smoke.wave_launches(meta, 1, 2, fused)["permute_state"] == (
        (2 if meta.kernel_routed else 0) if fused else 0)
    local = chip_smoke.SHARD_SPP // 2
    shard = chip_smoke.sharded_launches((2, 2), 2, fused=fused)
    assert {k: shard[k] for k in chip_smoke.WAVE} == {
        "camera_rays": local,
        "permute_state": local * min(3, chip_smoke.SHARD_DEPTH) if fused
        else 0, "unsort_guard": local if fused else 0}


def test_wave_nodes_classes_and_ranges():
    """scripts/wave_nodes.py: an operation's class by its profiler name
    (the port's kernels by their registered device functions and the wide
    kernel's cull pass, CUB's radix-sort passes, memsets, copies, the
    rest); an eager operation's range by its start (li_path's ranges, the
    wave span's camera/init before them, end after them and between
    between them, render()'s frame outside the wave); and the counts and
    ms by range and class."""
    from jet_pbrt_tpu_torch.scripts import wave_nodes as WN
    names = {
        "(anonymous namespace)::camera_rays_kernel(CameraArgs)":
            "port kernel",
        "void wide_cull_kernel<false>(float4 const*)": "port kernel",
        "void cub::CUB_200700_900_NS::DeviceRadixSortOnesweepKernel<int>()":
            "argsort",
        "Memset (Device)": "memset", "Memcpy DtoD (Device -> Device)": "copy",
        "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()":
            "other"}
    assert {n: WN.node_class(n) for n in names} == names
    spans = [("render.wave", 10, 100), ("li_path.intersect", 20, 30),
             ("li_path.sort", 40, 50)]
    starts = [5, 12, 25, 35, 45, 60, 120]
    assert WN.op_labels(starts, spans) == [
        "frame", "camera/init", "li_path.intersect", "between",
        "li_path.sort", "end", "frame"]
    assert WN.op_labels([1, 2], spans[1:])[0] == "frame"
    nodes, ms, other = WN.by_class(list(names), [1.0] * 6, [
        "camera/init", "li_path.intersect", "li_path.sort", "li_path.sort",
        "graph inputs", "end"])
    assert nodes["li_path.sort"] == {"port kernel": 0, "argsort": 1,
                                     "memset": 1, "copy": 0, "other": 0}
    assert ms["camera/init"]["port kernel"] == 1.0
    assert other == {"end: void at::native::vectorized_elementwise_kernel"
                     "<4, FillFunctor>()": 1}


@pytest.mark.parametrize("which", ["cornell", "bunny"])
def test_grad_launches_count_one_backward_per_vertex(which):
    """A differentiated wave's backward: one vertex_backward per tangent
    set (two in both scenes: matte, and metal with plastic and glass) at
    each vertex below max_depth and one on the last, one grad_reduce per
    vertex, one permute_state_backward per sort (a kernel-routed scene's
    bounces 0 to 2) and one unsort_guard_backward; the train step's
    backward the same per local sample; a forward launches none of
    them."""
    from jet_pbrt_tpu_torch.scene import scenes
    meta = (scenes.cornell_box() if which == "cornell"
            else scenes.bunny_scene()).meta
    sorts = 3 if meta.kernel_routed else 0
    assert chip_smoke.shade_ops.backward_sets(meta) == (0, 2)
    assert chip_smoke.grad_launches(meta, 2, 5) == {
        "vertex_backward": 22, "grad_reduce": 12,
        "permute_state_backward": 2 * sorts, "unsort_guard_backward": 2}
    assert chip_smoke.grad_launches(meta, 1, 1)["permute_state_backward"] \
        == (1 if meta.kernel_routed else 0)
    assert all(chip_smoke.expected_launches(meta, 64, 4, 5)[k] == 0
               for k in chip_smoke.GRAD)
    if which == "bunny":
        assert chip_smoke.sharded_grad((2, 2)) == chip_smoke.grad_launches(
            meta, chip_smoke.SHARD_SPP // 2, chip_smoke.SHARD_DEPTH)

