"""Multi-host rendering: process-group initialization, host-aware meshes,
a scaling-efficiency harness and a spawner of a world of local ranks.

PyTorch counterpart of jet_pbrt_tpu/parallel/multihost.py. One process
per device: the *pixel* axis spans hosts (film blocks never need a
cross-host collective until the image is gathered) and the *sample* axis
stays inside a host, so the film sum and the gradient all-reduce ride the
host's NVLink. Streams are keyed by global ids (ops/rng.py), so the image
does not depend on the host count.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from ..models.render import setup
from .mesh import make_mesh, rank_device
from .render import build_sharded_render

# how long a rendezvous or a collective may wait before it fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
# how long a spawned world may take, start-up included
SPAWN_DEADLINE_S = 600.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device=None, timeout=DEFAULT_TIMEOUT) -> int:
    """Bring up torch.distributed for a multi-process run; returns the
    world size (1 when not opted in and no group exists).

    Opt-in is explicit: pass a coordinator address ("host:port", joined
    as init_method "tcp://host:port" with world size num_processes and
    rank process_id, by default WORLD_SIZE and RANK), or set
    JET_MULTIHOST=1 (init_method "env://": torchrun's MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE), or export the reference's
    JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS (joined over tcp as an
    explicit address is). Anything else leaves the process alone. A group
    that already exists is kept. The backend is NCCL on the card (this
    rank's card made current first, mesh.rank_device) and gloo on the CPU
    (device="cpu"), unless named. A failed init raises."""
    env_address = (os.environ.get("JAX_COORDINATOR_ADDRESS")
                   or os.environ.get("COORDINATOR_ADDRESS"))
    multihost = os.environ.get("JET_MULTIHOST") == "1"
    opted_in = coordinator_address is not None or multihost or bool(
        env_address)
    if opted_in and not dist.is_initialized():
        device = rank_device(device)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(device)
        if coordinator_address is None and multihost:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
        else:
            address = coordinator_address or env_address
            world = (num_processes if num_processes is not None
                     else int(os.environ.get("WORLD_SIZE", -1)))
            rank = (process_id if process_id is not None
                    else int(os.environ.get("RANK", -1)))
            dist.init_process_group(backend, init_method=f"tcp://{address}",
                                    world_size=world, rank=rank,
                                    timeout=timeout)
        return dist.get_world_size()
    return dist.get_world_size() if dist.is_initialized() else 1


def make_multihost_mesh(spp: int | None = None, ranks=None, device=None):
    """(px, spp) mesh with px spanning hosts and spp inside each host.

    Ranks are numbered host-major, as torchrun numbers them, and a host
    holds LOCAL_WORLD_SIZE of them (default: all, one host). spp: ranks
    per host on the sample axis (default: all of a host's, so px is the
    host count). Every rank of the world calls it (make_mesh)."""
    ranks = sorted(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host < 1 or n % per_host:
        raise ValueError(f"{n} ranks do not fill hosts of {per_host}")
    if spp is None:
        spp = per_host
    if spp < 1 or per_host % spp:
        raise ValueError(f"spp = {spp} does not divide a host's "
                         f"{per_host} ranks")
    return make_mesh(px=n // spp, spp=spp, ranks=ranks, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_report(scene, width: int, height: int, spp: int,
                   rank_counts=None, seed: int = 0, max_depth: int = 3,
                   n_reps: int = 2, device=None) -> list[dict]:
    """A fixed frame rendered on growing meshes, (c, 1) over the first c
    ranks for each c of rank_counts (default 1, 2, 4, 8 up to the world
    size): wall seconds per frame (the slowest rank's, after one warm-up
    frame) and the speedup and scaling efficiency against the first mesh
    (strong scaling). Every rank of the world calls it and gets the same
    rows; ranks outside a mesh idle during its frames.

    Ranks that share one card (the gloo ranks of a one-card machine) or
    one CPU check the machinery, not hardware scaling."""
    world = dist.get_world_size()
    if rank_counts is None:
        rank_counts = [c for c in (1, 2, 4, 8) if c <= world]
    device, pack, cam = setup(scene, width, height, rank_device(device))
    rows = []
    for c in rank_counts:
        mesh = make_mesh(px=c, spp=1, ranks=range(c), device=device)
        if dist.get_rank() >= c:
            continue
        fn = build_sharded_render(scene.meta, mesh, width, height, spp,
                                  seed=seed, max_depth=max_depth,
                                  device=device)
        fn(pack, cam)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_reps):
            fn(pack, cam)
        _sync(device)
        secs = torch.tensor([(time.perf_counter() - t0) / n_reps],
                            dtype=torch.float64, device=device)
        dist.all_reduce(secs, op=dist.ReduceOp.MAX, group=fn.px_group)
        rows.append({"ranks": c, "seconds": float(secs)})
    got = [rows]
    dist.broadcast_object_list(got, src=0)
    rows = got[0]
    # rank-seconds of the first mesh are the "1x" unit of work
    base = rows[0]["seconds"] * rows[0]["ranks"]
    for r in rows:
        r["speedup"] = rows[0]["seconds"] / r["seconds"]
        r["efficiency"] = base / (r["seconds"] * r["ranks"])
    return rows


def format_scaling_table(rows: list[dict]) -> str:
    lines = ["| ranks | seconds | speedup | efficiency |",
             "|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['ranks']} | {r['seconds']:.3f} | "
            f"{r['speedup']:.2f}x | {100 * r['efficiency']:.0f}% |"
        )
    return "\n".join(lines)


def _spawned_rank(rank, world, path, backend, timeout, fn, args):
    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=f"file://{path}/init",
                            world_size=world, rank=rank, timeout=timeout)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))


def spawn(fn, world: int, *args, backend: str = "gloo",
          deadline_s: float = SPAWN_DEADLINE_S,
          timeout=DEFAULT_TIMEOUT) -> list:
    """fn(rank, *args) in each of `world` spawned processes of one process
    group (`backend`; a file:// rendezvous in a temporary directory; each
    rank's LOCAL_RANK set, so mesh.rank_device gives it card rank % count
    on the card); returns the ranks' results in rank order. fn must be a
    module-level function of a module the ranks can import. Raises if a
    rank raises or the world outlives deadline_s (its ranks killed)."""
    with tempfile.TemporaryDirectory() as path:
        ctx = tmp.start_processes(
            _spawned_rank, args=(world, path, backend, timeout, fn, args),
            nprocs=world, join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"a {world}-rank world outlived "
                                       f"{deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
        return [torch.load(os.path.join(path, f"rank{r}.pt"))
                for r in range(world)]
