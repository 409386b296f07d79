"""Meshes (port of ``repro.launch.mesh``).

An abstract mesh is a shape over named axes and nothing more: the sharding
rules of ``repro_torch.parallel.sharding`` read it, and building one starts
no process. A rank mesh is an abstract mesh seen from one process of a
``torch.distributed`` job: it adds this rank's coordinate on every axis and
one process group per axis (the ranks that differ only on that axis), and
one for the data-parallel tuple ``("pod", "data")`` of a three-axis mesh
(the FSDP axis of ``parallel.sharding.make_dist``), over which
``repro_torch.parallel.collectives`` reduce and gather. A mesh spans every
rank of its job; :func:`remesh` gives the same ranks another shape.

Backends: ranks that share one device use ``gloo`` (NCCL refuses two ranks
on one GPU, and gloo moves CUDA tensors through host memory); ranks with a
device each use ``nccl``. ``host_group`` is a gloo group over the whole
mesh in either case, for agreeing on host-side decisions (CPU tensors).
"""
from __future__ import annotations

import math
import pickle
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import torch


class AbstractMesh:
    """Named axes and their sizes (``shape`` maps axis -> size, in order),
    with no processes behind them."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             "in length")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        inner = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"{type(self).__name__}({inner})"


class RankMesh(AbstractMesh):
    """The mesh as one rank sees it: ``rank`` in row-major order over the
    axes, ``coords`` (axis -> this rank's index), ``groups`` (axis, or the
    data-parallel tuple of axes -> the process group of the ranks sharing
    every other coordinate, in the axis index order; None on an axis of
    size 1), ``mesh_group`` (every rank, the job's backend) and
    ``host_group`` (gloo, every rank)."""

    def __init__(self, shape, axes, rank: int, groups, host_group,
                 backend: str, mesh_group=None):
        super().__init__(shape, axes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.backend = backend
        idx = rank
        coords = {}
        for a in reversed(self.axis_names):
            coords[a] = idx % self.shape[a]
            idx //= self.shape[a]
        self.coords = {a: coords[a] for a in self.axis_names}
        self.groups = groups
        self.host_group = host_group
        self.mesh_group = mesh_group

    def index(self, axis) -> int:
        """This rank's index along ``axis`` (a name or a tuple of names,
        row-major over the tuple)."""
        names = axis if isinstance(axis, tuple) else (axis,)
        i = 0
        for a in names:
            i = i * self.shape[a] + self.coords[a]
        return i


def make_mesh_from_spec(spec: str) -> AbstractMesh:
    """e.g. "8x16" -> (data=8, model=16); "2x8x16" -> (pod, data, model)."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 2:
        axes = ("data", "model")
    elif len(dims) == 3:
        axes = ("pod", "data", "model")
    else:
        raise ValueError(f"bad mesh spec {spec!r}")
    return AbstractMesh(dims, axes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2x16x16 =
    512 chips (pod, data, model)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def init_rank_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], rank: int,
                   world: int, backend: str = "gloo",
                   init_method: Optional[str] = None,
                   timeout_s: float = 300.0) -> RankMesh:
    """Join a ``torch.distributed`` job of ``world`` ranks (``init_method``:
    e.g. ``tcp://localhost:<port>``) and build this rank's view of a mesh
    of ``shape`` over ``axes``. Every rank must call it with the same
    arguments but its own ``rank``; the groups are made in one order on
    every rank, as ``new_group`` requires. Undo with
    :func:`destroy_rank_mesh`."""
    import datetime

    import torch.distributed as tdist
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, the "
                         f"job {world}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world, timeout=timeout)
    host_group = (tdist.new_group(backend="gloo", timeout=timeout)
                  if backend != "gloo" else tdist.group.WORLD)
    return RankMesh(shape, axes, rank, _axis_groups(shape, axes, rank,
                                                    timeout),
                    host_group, backend, tdist.group.WORLD)


def _axis_groups(shape, axes, rank: int, timeout) -> dict:
    """This rank's process group on every axis of size > 1 (None on the
    others) and on the ``("pod", "data")`` tuple of a mesh with both; the
    groups of every line are made in one order on every rank, as
    ``new_group`` requires. A line's ranks ascend with its axis index (the
    mesh is row-major), so a group's rank order is the index order."""
    import torch.distributed as tdist
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    keyed = [(a, (i,)) for i, a in enumerate(axes)]
    dp = tuple(a for a in ("pod", "data") if a in axes)
    if len(dp) > 1:
        keyed.append((dp, tuple(axes.index(a) for a in dp)))
    groups = {}
    for key, dims in keyed:
        size = math.prod(shape[d] for d in dims)
        mine = None
        if size > 1:
            rest = [d for d in range(len(shape)) if d not in dims]
            lines = ranks.permute(rest + list(dims)).reshape(-1, size)
            for line in lines.tolist():
                g = tdist.new_group(line, timeout=timeout)
                if rank in line:
                    mine = g
        groups[key] = mine
    return groups


def remesh(mesh: RankMesh, shape: Tuple[int, ...],
           axes: Tuple[str, ...] = ("data", "model"),
           timeout_s: float = 300.0) -> RankMesh:
    """The ranks of ``mesh`` as a mesh of another ``shape`` over ``axes``
    (the same job: the sizes multiply to its world): its groups are made
    here, so every rank must call it, in one order."""
    import datetime
    if math.prod(shape) != mesh.size:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, the "
                         f"job {mesh.size}")
    timeout = datetime.timedelta(seconds=timeout_s)
    return RankMesh(shape, axes, mesh.rank,
                    _axis_groups(tuple(shape), tuple(axes), mesh.rank,
                                 timeout),
                    mesh.host_group, mesh.backend, mesh.mesh_group)


def destroy_rank_mesh() -> None:
    """Leave the ``torch.distributed`` job (every group with it)."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        tdist.destroy_process_group()


def rank_devices(world: int, device=None):
    """Each rank's device and the backend: ``cpu`` for every rank when
    ``device`` is the CPU (gloo); on CUDA, ``cuda:rank`` with NCCL where the
    host has a card per rank, else ``cuda:0`` for every rank with gloo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * world, "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no ranks on a {dev.type} device")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    if torch.cuda.device_count() >= world:
        return [torch.device("cuda", r) for r in range(world)], "nccl"
    return [torch.device("cuda", 0)] * world, "gloo"


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_entry(rank: int, world: int, fn: Callable, args, device,
                init_method: str, threads: int, results, shape,
                axes) -> None:
    """A spawned rank of :func:`run_ranks`: join the mesh, call
    ``fn(dist, device, *args)`` and put (rank, error or None, result) on
    ``results``; an error is raised again after it is reported."""
    from repro_torch.parallel.sharding import make_dist
    torch.set_num_threads(threads)
    devices, backend = rank_devices(world, device)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        mesh = init_rank_mesh(shape, axes, rank, world, backend, init_method)
        ret = fn(make_dist(mesh), dev, *args)
        # by value: tensors the queue would share by handle die with the rank
        results.put((rank, None, pickle.dumps(ret)))
    except BaseException as e:      # noqa: BLE001 — reported, then raised
        code = e.code if isinstance(e, SystemExit) else None
        results.put((rank, (type(e).__name__, str(e), code,
                            traceback.format_exc()), None))
        raise
    finally:
        destroy_rank_mesh()


def run_ranks(fn: Callable, world: int, args=(), *, device=None,
              threads: Optional[int] = None,
              shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data", "model")) -> list:
    """``fn(dist, device, *args)`` on ``world`` spawned ranks (start method
    ``spawn``: ``fn`` and ``args`` are pickled, ``fn`` by its import path)
    joined over ``localhost`` into one mesh of ``shape`` over ``axes``
    (default (1, world) over (data, model), the serving mesh), ``dist``
    ``parallel.sharding.make_dist`` of it and ``device`` each rank's
    (:func:`rank_devices`); returns the ranks' results in rank order. The
    CUDA kernels are built here first, so the ranks only load them. Each
    rank runs ``threads`` intra-op threads (default: this process's
    share). A rank that fails stops every other: its ``SystemExit`` is
    raised here with its code, any other error as a RuntimeError that
    carries the rank's traceback."""
    import torch.multiprocessing as mp
    shape = (1, world) if shape is None else tuple(shape)
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"a mesh {shape} over {axes} for {world} ranks")
    devices, _ = rank_devices(world, device)
    if devices[0].type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(r, world, fn, args, device, init_method,
                               threads, results, shape, tuple(axes)))
             for r in range(world)]
    for p in procs:
        p.start()
    got, failure = {}, None
    try:
        while len(got) < world and failure is None:
            if not results.empty():
                rank, err, ret = results.get()
                got[rank] = None if ret is None else pickle.loads(ret)
                if err is not None:
                    failure = (rank, err)
                continue
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)]
            if dead and results.empty():
                failure = (dead[0], ("exit", f"exited with code "
                                     f"{procs[dead[0]].exitcode} and no "
                                     "report", None, ""))
            time.sleep(0.01)
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join()
    if failure is not None:
        rank, (kind, msg, code, tb) = failure
        if kind == "SystemExit":
            raise SystemExit(code if code not in (None, 0) else
                             f"rank {rank}: {msg}")
        raise RuntimeError(f"rank {rank} failed: {kind}: {msg}\n{tb}")
    return [got[r] for r in range(world)]


__all__ = ["AbstractMesh", "RankMesh", "make_mesh_from_spec",
           "make_production_mesh", "init_rank_mesh", "destroy_rank_mesh",
           "remesh", "rank_devices", "run_ranks"]
