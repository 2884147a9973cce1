"""The port's multi-host machinery (jet_pbrt_tpu_torch/parallel/multihost.py)
after tests/test_multihost.py: initialize (a no-op unless opted in; an
opted-in init runs before anything reads the world size; the tcp and env
rendezvous forms; a failed init raises), host-aware meshes and the
scaling harness, over a spawned 4-rank gloo world on the CPU.

This module imports no JAX: the spawned ranks import it (or
test_torch_parallel, which imports JAX only inside a fixture) to find
their work, and `run_world` here starts them. It also runs where JAX is
absent (with --noconftest). Every world has a deadline: a hung rendezvous
or collective fails its test rather than stalling the run.
"""
import datetime
import os
import sys

import pytest
import torch
import torch.distributed as dist

from jet_pbrt_tpu_torch.parallel import multihost as MH
from jet_pbrt_tpu_torch.parallel.mesh import make_mesh
from jet_pbrt_tpu_torch.parallel.render import render_sharded
from jet_pbrt_tpu_torch.scene.scenes import cornell_box

# seconds a spawned world may take, start-up included, and a rank's
# process-group timeout
WORLD_DEADLINE = 240.0
RANK_TIMEOUT = datetime.timedelta(seconds=120)


def _checked(rank, fn, args):
    """fn(rank, *args) in a rank that imported no JAX."""
    torch.set_num_threads(1)
    jax = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "jet_pbrt_tpu"))
    if jax:
        raise AssertionError(f"a rank imported {jax}")
    return fn(rank, *args)


def run_world(fn, world: int, *args, backend: str = "gloo",
              env=None) -> list:
    """fn(rank, *args) in each of `world` spawned ranks of one process group
    (multihost.spawn: a file:// rendezvous in a temporary directory),
    returns the ranks' results in rank order. fn must live in a JAX-free
    module, and each rank checks it imported no JAX. Raises if a rank
    raises or the world outlives WORLD_DEADLINE (its ranks killed). env:
    variables the ranks start with, restored here after the world."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        return MH.spawn(_checked, world, fn, args, backend=backend,
                        deadline_s=WORLD_DEADLINE, timeout=RANK_TIMEOUT)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _lambert():
    return cornell_box(lambert_only=True, use_bvh=False)


def _rank_multihost(rank, scene):
    """Host-aware meshes (LOCAL_WORLD_SIZE = 2, as the world was started),
    their images against make_mesh's, and the scaling report."""
    out = {"hosts2": MH.make_multihost_mesh(device="cpu").mesh.tolist()}
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    out["one_host"] = MH.make_multihost_mesh(device="cpu").mesh.tolist()
    out["spp1"] = MH.make_multihost_mesh(spp=1, device="cpu").mesh.tolist()
    with pytest.raises(ValueError):
        MH.make_multihost_mesh(spp=3, device="cpu")
    out["img_multihost"] = render_sharded(
        scene, 16, 16, 8, MH.make_multihost_mesh(spp=2, device="cpu"),
        seed=2, clamp=False, device="cpu")
    out["img_mesh"] = render_sharded(
        scene, 16, 16, 8, make_mesh(px=2, spp=2, device="cpu"), seed=2,
        clamp=False, device="cpu")
    out["rows"] = MH.scaling_report(scene, 16, 16, 4, rank_counts=[1, 2, 4],
                                    max_depth=2, n_reps=1, device="cpu")
    return out


@pytest.fixture(scope="module")
def world():
    return run_world(_rank_multihost, 4, _lambert(),
                     env={"LOCAL_WORLD_SIZE": "2"})


def test_initialize_single_process_noop(monkeypatch):
    for k in ("JET_MULTIHOST", "JAX_COORDINATOR_ADDRESS",
              "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert MH.initialize() == 1
    assert not dist.is_initialized()


def _fake_dist(monkeypatch, calls, world=1):
    monkeypatch.setattr(MH.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(MH.dist, "init_process_group",
                        lambda *a, **k: calls.append(("init", a, k)))
    monkeypatch.setattr(MH.dist, "get_world_size",
                        lambda: calls.append("size") or world)


def test_initialize_runs_init_before_world_size(monkeypatch):
    """An opted-in run (JET_MULTIHOST=1) joins the group through env://
    (torchrun's variables) before anything reads the world size."""
    calls = []
    monkeypatch.setenv("JET_MULTIHOST", "1")
    _fake_dist(monkeypatch, calls)
    assert MH.initialize(device="cpu") == 1
    assert calls[0][0] == "init" and calls[1:] == ["size"]
    _, a, k = calls[0]
    assert a == ("gloo",) and k["init_method"] == "env://"
    assert k["timeout"] == MH.DEFAULT_TIMEOUT


def test_initialize_explicit_coordinator(monkeypatch):
    calls = []
    _fake_dist(monkeypatch, calls, world=2)
    assert MH.initialize("host0:1234", 2, 0, device="cpu") == 2
    _, a, k = calls[0]
    assert a == ("gloo",)
    assert (k["init_method"], k["world_size"], k["rank"]) == (
        "tcp://host0:1234", 2, 0)


def test_initialize_reference_coordinator_env(monkeypatch):
    """The reference's JAX_COORDINATOR_ADDRESS opts in over tcp, world size
    and rank from WORLD_SIZE and RANK; a named backend is kept."""
    calls = []
    monkeypatch.delenv("JET_MULTIHOST", raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    _fake_dist(monkeypatch, calls, world=4)
    assert MH.initialize(backend="gloo", device="cpu") == 4
    _, a, k = calls[0]
    assert a == ("gloo",)
    assert (k["init_method"], k["world_size"], k["rank"]) == (
        "tcp://10.0.0.1:8476", 4, 3)


def test_initialize_failure_raises(monkeypatch):
    """Opted in with no rendezvous to reach (env:// without MASTER_ADDR),
    initialize raises and leaves no group: it never carries on as a single
    process."""
    monkeypatch.setenv("JET_MULTIHOST", "1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        MH.initialize(device="cpu", timeout=datetime.timedelta(seconds=5))
    assert not dist.is_initialized()


def test_initialize_defaults_to_the_card(monkeypatch):
    """With no device an opted-in init asks for the card, and raises where
    there is none before it joins any group."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _fake_dist(monkeypatch, calls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.initialize("host0:1234", 2, 0)
    assert calls == []


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device the sharded entry points ask for the card and raise
    where there is none, before any collective: nothing falls back to the
    CPU."""
    from jet_pbrt_tpu_torch.parallel.train import build_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _lambert()
    for call in (lambda: make_mesh(ranks=[0]),
                 lambda: render_sharded(scene, 4, 4, 1, mesh=None),
                 lambda: build_train_step(scene, None, 4, 4, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_make_multihost_mesh_shapes(world):
    """Ranks are host-major: with LOCAL_WORLD_SIZE=2 the 4 ranks are two
    hosts, px across them and spp inside each, (2, 2); on one host of 4,
    spp takes every rank by default, (1, 4), or spp=1 gives (4, 1); every
    rank appears once."""
    for got in world:
        assert got["hosts2"] == [[0, 1], [2, 3]]
        assert got["one_host"] == [[0, 1, 2, 3]]
        assert got["spp1"] == [[0], [1], [2], [3]]


def test_multihost_mesh_renders_same_image(world):
    """The host-aware mesh and make_mesh's (2, 2) give the same frame on
    every rank."""
    a = world[0]["img_mesh"]
    assert a.shape == (16, 16, 3) and float(a.mean()) > 0.01
    for got in world:
        assert torch.equal(got["img_multihost"], a)
        assert torch.equal(got["img_mesh"], a)


def test_scaling_report_runs(world):
    rows = world[0]["rows"]
    assert [r["ranks"] for r in rows] == [1, 2, 4]
    assert all(r["seconds"] > 0 for r in rows)
    assert abs(rows[0]["efficiency"] - 1.0) < 1e-6
    assert all(got["rows"] == rows for got in world)
    table = MH.format_scaling_table(rows)
    print(table)
    assert table.count("|") > 10 and table.splitlines()[0].startswith(
        "| ranks |")
