"""Process groups laid out as a device mesh, and starting the ranks.

Counterpart of dagnn_tpu/parallel/mesh.py. JAX builds one SPMD program
over a Mesh of devices; here every rank is a process, and a mesh is the
set of torch.distributed groups of each axis:

  * init_distributed: the process group, with its arguments read from the
    standard environment (MASTER_ADDR / MASTER_PORT with RANK and
    WORLD_SIZE, torch's env:// rendezvous) where the caller gives none,
    as the JAX package reads JAX_COORDINATOR_ADDRESS and its kin;
  * make_mesh / make_hybrid_mesh: a Mesh of the world's ranks in row-major
    order, so the last axis ('ep' of (dp, ep)) is consecutive ranks (the
    ranks of one host, whose per-row exchanges ride NVLink) and the first
    ('dp') is strided, as the JAX package lays out its hybrid mesh;
  * spawn: starts `world` ranks with the spawn start method on one host,
    each with a file:// store, a collective timeout and a device, runs a
    function on each, and returns what each rank returned.

Both run on the CUDA device unless the caller asks for the CPU
(device="cpu"), and raise when no card is present (resolve_device).

default_backend picks NCCL when every rank has a card of its own and gloo
otherwise (ranks that share a card, or the CPU): NCCL refuses two ranks on
one GPU. The rule reads the device count; it never tries one backend and
falls back to the other.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import queue
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dagnn_tpu_torch import resolve_device


def default_backend(world: int, device: str) -> str:
    """"nccl" when `device` is cuda and each of the `world` ranks has a
    card of its own, else "gloo"."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str) -> torch.device:
    """The device rank `rank` computes on: the CPU, or card rank % count
    (every rank on card 0 when the host has one)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: float = 300.0, device: str = "cuda") -> None:
    """Initialise the default process group for ranks on `device` ("cuda",
    the default, raises without a card; "cpu" asks for the CPU).
    Arguments left None come from the environment: RANK and WORLD_SIZE,
    and env:// (MASTER_ADDR, MASTER_PORT) unless init_method names a store
    (tcp://host:port, file:///path). The backend defaults to
    default_backend for the device."""
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if backend is None:
        backend = default_backend(world_size, dev.type)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


@dataclasses.dataclass
class Mesh:
    """The world's ranks as an array of `shape`, named by `axis_names`:
    `groups[axis]` is this rank's group along that axis (the ranks that
    differ from it only in that coordinate), `coords[axis]` its index
    there. `group` spans every rank of the mesh."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    groups: Dict[str, object]
    coords: Dict[str, int]
    group: object


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """A Mesh over every rank of the default group, row-major: `shape`
    defaults to (world,) for one axis. Every rank calls it (it creates
    each axis's groups collectively, in one order on every rank)."""
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks, "
                         f"the world has {world}")
    me = dist.get_rank()
    ranks = np.arange(world).reshape(shape)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(me, shape))))
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = g
    return Mesh(shape, tuple(axis_names), groups, coords, dist.group.WORLD)


def make_hybrid_mesh(dp: int, ep: int,
                     axis_names: Sequence[str] = ("dp", "ep")) -> Mesh:
    """The (dp, ep) mesh: 'ep' consecutive ranks, 'dp' strided."""
    return make_mesh((dp, ep), axis_names)


def release_graphs():
    """Free the CUDA graphs of captured steps that are no longer
    referenced (a step and its CapturedStep refer to each other, so only
    the cycle collector frees them), and wait for the device, before the
    process group's communicators are destroyed: a graph holds the NCCL
    work it captured."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _worker(fn, rank, world, backend, device, store, timeout, args, results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed(backend, f"file://{store}", rank, world, timeout, device)
        try:
            out = fn(dev, *args)
        finally:
            release_graphs()
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:      # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, backend: Optional[str] = None,
          device: str = "cuda", store_dir: Optional[str] = None,
          timeout: float = 300.0, args: tuple = ()) -> list:
    """Run fn(device, *args) on `world` new ranks (spawn start method) on
    `device` ("cuda", the default, raises without a card; "cpu" asks for
    the CPU), each in the default process group (a file:// store under
    store_dir, or under a directory of the temp dir removed after;
    `timeout` seconds for each collective). fn must be importable by name; its return value is
    pickled back. Returns the ranks' results in rank order. A rank that
    raises, dies or outlives `timeout` ends them all, and spawn raises."""
    import multiprocessing as mp
    device = resolve_device(device).type
    backend = backend or default_backend(world, device)
    own_dir = None if store_dir else tempfile.mkdtemp(prefix="dagnn_dist_")
    store = os.path.join(store_dir or own_dir, f"store-{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world, backend, device, store, timeout,
                               args, results)) for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world} ranks outlived {timeout} s")
            try:
                r, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in out]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {r} failed:\n{payload}")
            out[r] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        if own_dir:
            shutil.rmtree(own_dir, ignore_errors=True)
    return [out[r] for r in range(world)]
