"""Host meshes over ``torch.distributed`` and the collectives of the
distributed aggregation paths (port of ``repro/launch/mesh.py`` and of the
parts of ``repro/compat`` those paths call).

A :class:`Mesh` names the axes of a process grid: ``("data", "model")``,
or ``("pod", "data", "model")`` with worker axes ``("pod", "data")``.  Each
rank is one process; ranks are laid out row-major over the axes, as
``init_device_mesh`` lays them out.  The workers of the robust federation
are the indices along the worker axes (:func:`worker_axes`), pod-major:
the global worker id is the row-major index over those axes, the order
every collective below stacks them in.  Each worker owns the ``model``
ranks that share its worker coordinates.

:meth:`Mesh.axes` gives the handle the engines take as ``axis_names`` /
``sync_axes``: the ranks that differ from this one only along the named
axes, their process group, this rank's index among them and their count.
The empty handle (or ``()``) means no collective at all, so an engine
called without one runs the single-process program it ran before.

The collectives over those handles are in
:mod:`repro_torch.collectives`.

:func:`spawn_mesh` runs a function on every rank of a local world: one
process a rank, a ``gloo`` process group with an explicit address, a time
limit for the whole world.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.collectives import Axes

WORKER_AXIS_NAMES = ("pod", "data")


class Mesh:
    """A process grid with named axes over an initialized default process
    group; build it with :func:`make_host_mesh`."""

    def __init__(self, device_mesh, groups: dict[tuple[str, ...], Any]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = tuple(device_mesh.mesh.shape)
        self.coordinate = tuple(device_mesh.get_coordinate())
        self._groups = groups

    def axes(self, *names: str) -> Axes:
        """The handle of ``names`` (a subset of the mesh's axes, in mesh
        order) for this rank."""
        order = [self.axis_names.index(n) for n in names]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {names} must be distinct axes of "
                             f"{self.axis_names}, in mesh order")
        sizes = [self.shape[i] for i in order]
        index = 0
        for i, n in zip(order, sizes):
            index = index * n + self.coordinate[i]
        return Axes(tuple(names), math.prod(sizes), index,
                    self._groups.get(tuple(names)))


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The mesh of ``shape`` named ``axes`` over the default process group
    (``torch.distributed.init_process_group`` first; world size
    ``prod(shape)``).  Every rank builds the process group of every subset
    of the axes, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    device_mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    ranks = device_mesh.mesh
    groups = {}
    for r in range(1, len(axes) + 1):
        for subset in itertools.combinations(range(len(axes)), r):
            names = tuple(axes[i] for i in subset)
            if r == 1:
                groups[names] = device_mesh.get_group(names[0])
                continue
            # One group per setting of the other axes, its ranks row-major
            # over the subset.
            rest = [i for i in range(len(axes)) if i not in subset]
            perm = ranks.permute(*rest, *subset).reshape(
                -1, math.prod(shape[i] for i in subset))
            groups[names], _ = dist.new_subgroups_by_enumeration(
                [row.tolist() for row in perm])
    return Mesh(device_mesh, groups)


def worker_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in WORKER_AXIS_NAMES)


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_workers(mesh: Mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in worker_axes(mesh))


# -- local worlds -------------------------------------------------------------


def _rank_main(rank: int, world: int, address: str, shape, axes, timeout,
               fn, args, results) -> None:
    # The boundary of a rank: whatever fn raises goes back to the parent
    # as a traceback, which fails the whole world.
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=address, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout))
        out = fn(make_host_mesh(shape, axes), *args)
        dist.barrier()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn: Callable, shape: Sequence[int], axes: Sequence[str], *,
               args: tuple = (), timeout: float = 120.0,
               address: Optional[str] = None) -> list:
    """``fn(mesh, *args)`` on every rank of a local ``gloo`` world laid out
    as ``shape`` with axis names ``axes``, one spawned process a rank ->
    each rank's return value, in rank order.  ``fn`` must be importable
    (a module-level function) and its results picklable.  A rank that
    raises, dies, or leaves the world unfinished after ``timeout`` seconds
    fails it: every process is ended and RuntimeError names the rank.
    ``address``: the rendezvous (default: a file in a new temporary
    directory, removed when the world ends; a file needs no port, so no
    other process can take it between choosing and binding)."""
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = None
    if address is None:
        store_dir = tempfile.mkdtemp(prefix="mesh_")
        address = "file://" + os.path.join(store_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, address, tuple(shape), tuple(axes),
                               timeout, fn, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"mesh {tuple(shape)}: ranks {sorted(set(range(world)) - set(out))} "
                    f"unfinished after {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"mesh {tuple(shape)}: rank {dead[0]} "
                                       f"exited {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"mesh {tuple(shape)}: rank {rank} "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world)]
