"""Collectives over the ``model`` axis of a rank mesh (the port's own: the
reference's GSPMD inserts them from the placement).

Each one is the identity when ``dist`` is None or the axis has size 1, so
the model code calls them unconditionally. A sum the unsharded model
computes in f32 is reduced in f32: :func:`all_reduce_sum` widens its
input, reduces and hands back the input's type. :func:`all_gather`
gathers the bytes of each rank's slice (a uint8 view), so any dtype
crosses exactly, int8 and bf16 included, whatever the backend supports.

With ranks that share a device the backend is gloo, which copies CUDA
tensors through host memory: that copy is gloo's own transport, not a
computation moved to the CPU. ``seconds`` accumulates the host time spent
inside these calls (reset it to 0 before a window; read it after).
"""
from __future__ import annotations

import time
from typing import List

import torch

seconds = 0.0       # host time inside the collectives of this process


def tp_size(dist) -> int:
    """The ``model`` axis size, 1 without ``dist``."""
    return 1 if dist is None else dist.mesh.shape[dist.tp_axis]


def tp_index(dist) -> int:
    """This rank's index on the ``model`` axis (0 without ``dist``)."""
    return 0 if dist is None else dist.mesh.coords[dist.tp_axis]


def _group(dist):
    group = getattr(dist.mesh, "groups", {}).get(dist.tp_axis)
    if group is None:
        raise RuntimeError(f"{dist.mesh!r} has no process group on "
                           f"{dist.tp_axis!r} (an abstract mesh?)")
    return group


def _timed(fn):
    def wrapper(*args, **kw):
        global seconds
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            seconds += time.perf_counter() - t0
    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


@_timed
def all_reduce_sum(x: torch.Tensor, dist) -> torch.Tensor:
    """The sum of ``x`` over the ``model`` axis, reduced in f32 and
    returned in ``x``'s dtype (``x`` itself is left as it was)."""
    if tp_size(dist) == 1:
        return x
    import torch.distributed as tdist
    y = x.to(torch.float32, copy=True).contiguous()
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM, group=_group(dist))
    return y.to(x.dtype)


@_timed
def all_gather(x: torch.Tensor, dist, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in ``model`` index
    order, bit for bit (the bytes of each slice are gathered)."""
    n = tp_size(dist)
    if n == 1:
        return x
    import torch.distributed as tdist
    xc = x.contiguous()
    flat = xc.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    tdist.all_gather(parts, flat, group=_group(dist))
    return torch.cat([p.view(x.dtype).reshape(xc.shape) for p in parts],
                     dim=dim)


@_timed
def broadcast(x: torch.Tensor, dist, src: int = 0) -> torch.Tensor:
    """``x`` of the rank at ``model`` index ``src`` on every rank (a new
    tensor; ``x`` is left as it was)."""
    if tp_size(dist) == 1:
        return x
    import torch.distributed as tdist
    group = _group(dist)
    y = x.contiguous().clone()
    flat = y.reshape(-1).view(torch.uint8)
    tdist.broadcast(flat, group=group,
                    src=tdist.get_global_rank(group, src))
    return y


def agree_max(values: List[int], dist) -> List[int]:
    """The element-wise max of host integers over every rank of the mesh
    (its gloo host group): how ranks settle a host decision that arrives
    at each of them at its own time (``runtime.async_serve``)."""
    if dist is None or dist.mesh.size == 1:
        return list(values)
    import torch.distributed as tdist
    t = torch.tensor(values, dtype=torch.int64)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=dist.mesh.host_group)
    return t.tolist()

