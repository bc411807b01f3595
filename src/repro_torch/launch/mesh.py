"""Mesh factories, the port of the JAX package's ``launch/mesh.py``, and the
spawner of small local worlds.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, with the JAX package's axis names (``data``,
``model``, ``pod``). A JAX program under a mesh is one controller; its
counterpart here is SPMD, one process per rank, each calling the same
functions with the same arguments (`run_sweep`, `SweepService.flush`,
`bounded_staleness_epoch` are collective under a mesh).

Each factory takes ``device_type="cuda"`` (the card) and the CPU only when
asked. A rank's device is ``cuda:(rank % device_count)``, so ranks share a
card only where there are fewer cards than ranks (NCCL refuses that; a
``gloo`` world accepts it). A world of one is made in memory where no
process group exists (``nccl`` for ``cuda``, ``gloo`` for ``cpu``); a
larger world is never made here: the factory raises with the ``torchrun``
command that makes it.

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import multiprocessing
import queue as queue_mod
import time
import traceback
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world(size: int, device_type: str, what: str) -> None:
    """Make sure a world of at least ``size`` ranks exists (making a world of
    one in memory if none does) and bind this rank to its device."""
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(_BACKENDS)}, "
                         f"got {device_type!r}")
    # a fake world (the dry-run's: `launch.dryrun.fake_world`) holds fake
    # tensors only, so it needs no card
    fake = dist.is_initialized() and dist.get_backend() == "fake"
    if device_type == "cuda" and not fake and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass device_type='cpu' "
                           "to build the mesh on the CPU")
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"{what} needs a world of {size} processes and no process "
                f"group is initialised: launch it with `torchrun "
                f"--nproc-per-node {size} <script>` and call "
                f"`torch.distributed.init_process_group"
                f"({_BACKENDS[device_type]!r})` first")
        dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() < size:
        raise RuntimeError(f"{what} needs {size} ranks; the world has "
                           f"{dist.get_world_size()}")
    if device_type == "cuda" and not fake:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")`` over 256 ranks, or (2, 16, 16)
    ``("pod", "data", "model")`` over 512. Raises, naming the world size it
    needs, in any other world. The same axis names scale to N pods: ``pod``
    composes with ``data`` in the sharding rules."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 512 if multi_pod else 256
    _world(size, device_type, "make_production_mesh")
    if dist.get_world_size() != size:
        raise RuntimeError(f"make_production_mesh needs a world of {size} "
                           f"ranks; this one has {dist.get_world_size()}")
    return _mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """(1, 1) ``("data", "model")`` on a world of one (made in memory when no
    process group exists)."""
    _world(1, device_type, "make_host_mesh")
    return _mesh((1, 1), ("data", "model"), device_type)


_SWEEP_MESHES: Dict[Tuple[int, str], Tuple[object, DeviceMesh]] = {}


def make_sweep_mesh(num_devices: int | None = None,
                    device_type: str = "cuda") -> DeviceMesh:
    """1-D ``("data",)`` mesh over ranks ``0..n-1`` (n: ``num_devices``, else
    the world's size, else 1), for config-row sharding:
    `repro_torch.core.sweep.run_sweep` shards each group's rows over the
    ``data`` axis of the mesh it is given or of the ambient one.

    Memoised per count and device type within one world: repeated calls
    return the same mesh, and a new world gets a new one."""
    n = num_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    _world(n, device_type, "make_sweep_mesh")
    world = dist.group.WORLD
    hit = _SWEEP_MESHES.get((n, device_type))
    if hit is not None and hit[0] is world:
        return hit[1]
    mesh = _mesh((n,), ("data",), device_type)
    _SWEEP_MESHES[(n, device_type)] = (world, mesh)
    return mesh


# ---------------------------------------------------------------------------
# Local worlds: one spawned process per rank, joined under a deadline
# ---------------------------------------------------------------------------

WORLD_DEADLINE_S = 120.0   # a spawned world's whole run, start to join


def _rank_main(fn, rank: int, world_size: int, backend: str, init_file: str,
               results) -> None:
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
        try:
            out = fn(rank, world_size)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, *, backend: str,
              init_file: str) -> list:
    """Run ``fn(rank, world_size)`` in ``world_size`` spawned processes
    joined into one process group (``backend``, rendezvous through the
    file ``init_file``, which must not exist yet); returns their results
    by rank. ``fn`` and its results are pickled, so ``fn``
    is a module-level function (or a `functools.partial` of one).

    A rank that raises fails the world with its traceback; a rank that
    dies, or a world still running after ``WORLD_DEADLINE_S`` seconds,
    fails it too. Every rank left running is killed before this returns or
    raises (a rank blocked in a collective with a failed peer would wait
    forever)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, backend, init_file,
                               results))
             for rank in range(world_size)]
    deadline = time.monotonic() + WORLD_DEADLINE_S
    done: Dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world_size} still running after "
                    f"{WORLD_DEADLINE_S} s (ranks done: {sorted(done)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
            done[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.pid is None:                    # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(10)
        results.close()
    return [done[r] for r in range(world_size)]
