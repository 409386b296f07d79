"""Collectives over the axes of a rank mesh (the port's own: the
reference's GSPMD inserts them from the placement).

Each one is the identity when ``dist`` is None or the axis has size 1, so
the model code calls them unconditionally. ``axis`` is a mesh axis name or
a tuple of them (the ``("pod", "data")`` FSDP axis of a three-axis mesh);
it defaults to ``dist.tp_axis``. A sum the unsharded model computes in f32
is reduced in f32: :func:`all_reduce_sum` and :func:`reduce_scatter_sum`
widen their input, reduce and hand back the input's type.
:func:`all_gather` gathers the bytes of each rank's slice (a uint8 view),
so any dtype crosses exactly, int8 and bf16 included, whatever the backend
supports.

The training forward differentiates through them (Megatron's f and g
pairs; a replicated tensor's gradient is whole on every rank):

* :func:`sum_over`: a row-parallel sum, all-reduce forward, identity
  backward;
* :func:`copy_to`: a replicated input entering a column-parallel product,
  identity forward, all-reduce backward;
* :func:`gather_from`: an activation gathered whole, the rank's slice of
  the gradient backward;
* :func:`fsdp_gather`: a weight gathered over the FSDP axis, whose ranks
  hold other tokens: a reduce-scatter sum backward
  (:func:`gather_weight` on any axis);
* :func:`max_over` / :func:`min_over`: a range reduced over the ranks'
  slices of a tensor, the gradients summed back to the ranks holding the
  extreme.

Without autograd (serving) they move the bytes of the plain collectives.

With ranks that share a device the backend is gloo, which copies CUDA
tensors through host memory: that copy is gloo's own transport, not a
computation moved to the CPU. ``seconds`` accumulates the host time spent
inside these calls and ``nbytes`` the bytes each kind moved (the
gathered result, the f32 input of a reduction); reset both before a
window, read them after.
"""
from __future__ import annotations

import collections
import math
import time
from typing import List

import torch

seconds = 0.0       # host time inside the collectives of this process
calls: collections.Counter = collections.Counter()    # kind -> calls
nbytes: collections.Counter = collections.Counter()   # kind -> bytes


def _count(kind: str, n: int) -> None:
    calls[kind] += 1
    nbytes[kind] += n


def _axis(dist, axis):
    return dist.tp_axis if axis is None else axis


def size(dist, axis=None) -> int:
    """The size of ``axis`` (default the ``model`` axis), 1 without
    ``dist``."""
    if dist is None:
        return 1
    names = _axis(dist, axis)
    names = names if isinstance(names, tuple) else (names,)
    return math.prod(dist.mesh.shape[a] for a in names)


def index(dist, axis=None) -> int:
    """This rank's index on ``axis`` (row-major over a tuple; 0 without
    ``dist``)."""
    return 0 if dist is None else dist.mesh.index(_axis(dist, axis))


def tp_size(dist) -> int:
    """The ``model`` axis size, 1 without ``dist``."""
    return size(dist)


def tp_index(dist) -> int:
    """This rank's index on the ``model`` axis (0 without ``dist``)."""
    return index(dist)


def _group(dist, axis=None):
    key = _axis(dist, axis)
    if isinstance(key, tuple) and len(key) == 1:
        key = key[0]
    group = getattr(dist.mesh, "groups", {}).get(key)
    if group is None:
        raise RuntimeError(f"{dist.mesh!r} has no process group on "
                           f"{key!r} (an abstract mesh?)")
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
def all_reduce_sum(x: torch.Tensor, dist, axis=None) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, reduced in f32 and returned in
    ``x``'s dtype (``x`` itself is left as it was)."""
    if size(dist, axis) == 1:
        return x
    import torch.distributed as tdist
    y = x.to(torch.float32, copy=True).contiguous()
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM, group=_group(dist, axis))
    _count("all_reduce", y.numel() * 4)
    return y.to(x.dtype)


@_timed
def all_reduce_max(x: torch.Tensor, dist, axis=None) -> torch.Tensor:
    """The element-wise max of ``x`` over ``axis`` (a new tensor, exact in
    any dtype)."""
    if size(dist, axis) == 1:
        return x
    import torch.distributed as tdist
    y = x.detach().clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(y, op=tdist.ReduceOp.MAX, group=_group(dist, axis))
    _count("all_reduce", y.numel() * y.element_size())
    return y


@_timed
def all_gather(x: torch.Tensor, dist, dim: int = -1,
               axis=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in ``axis`` index
    order, bit for bit (the bytes of each slice are gathered)."""
    n = size(dist, axis)
    if n == 1:
        return x
    import torch.distributed as tdist
    xc = x.contiguous()
    flat = xc.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    tdist.all_gather(parts, flat, group=_group(dist, axis))
    _count("all_gather", n * flat.numel())
    return torch.cat([p.view(x.dtype).reshape(xc.shape) for p in parts],
                     dim=dim)


@_timed
def reduce_scatter_sum(x: torch.Tensor, dist, dim: int,
                       axis=None) -> torch.Tensor:
    """This rank's block along ``dim`` (in ``axis`` index order) of the
    sum of ``x`` over ``axis``, reduced in f32 and returned in ``x``'s
    dtype."""
    n = size(dist, axis)
    if n == 1:
        return x
    import torch.distributed as tdist
    dim = dim % x.dim()
    y = x.to(torch.float32).movedim(dim, 0).contiguous()
    out = torch.empty((y.shape[0] // n, *y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    tdist.reduce_scatter_tensor(out, y, op=tdist.ReduceOp.SUM,
                                group=_group(dist, axis))
    _count("reduce_scatter", y.numel() * 4)
    return out.movedim(0, dim).to(x.dtype)


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


@_timed
def mesh_sum(x: torch.Tensor, dist) -> torch.Tensor:
    """The sum of the f32 tensor ``x`` over every rank of the mesh."""
    if dist is None or dist.mesh.size == 1:
        return x
    import torch.distributed as tdist
    y = x.to(torch.float32, copy=True).contiguous()
    tdist.all_reduce(y, op=tdist.ReduceOp.SUM, group=dist.mesh.mesh_group)
    _count("all_reduce", y.numel() * 4)
    return y


def agree_max(values: List[int], dist) -> List[int]:
    """The element-wise max of host integers over every rank of the mesh
    (its gloo host group; ``dist`` a ``DistContext`` or its mesh): how
    ranks settle a host decision that arrives at each of them at its own
    time (``runtime.async_serve``, ``runtime.train_loop``)."""
    mesh = getattr(dist, "mesh", dist)
    if mesh is None or mesh.size == 1:
        return list(values)
    import torch.distributed as tdist
    t = torch.tensor(values, dtype=torch.int64)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=mesh.host_group)
    return t.tolist()


def barrier(dist) -> None:
    """Wait for every rank of the mesh (its gloo host group)."""
    mesh = getattr(dist, "mesh", dist)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as tdist
        tdist.barrier(group=mesh.host_group)


# ---------------------------------------------------------------------------
# Differentiable forms (the training forward)
# ---------------------------------------------------------------------------

class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis):
        return all_reduce_sum(x, dist, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis):
        ctx.dist, ctx.axis = dist, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.dist, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, dim, axis):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.start = index(dist, axis) * ctx.width
        return all_gather(x, dist, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.width), None, None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dist, dim, axis):
        ctx.dist, ctx.dim, ctx.axis = dist, dim, axis
        return all_gather(w, dist, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_sum(g, ctx.dist, ctx.dim, ctx.axis), None,
                None, None)


class _MaxOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis):
        y = all_reduce_max(x, dist, axis)
        ctx.save_for_backward(x == y)
        ctx.dist, ctx.axis = dist, axis
        return y

    @staticmethod
    def backward(ctx, g):
        held, = ctx.saved_tensors
        # the ranks' parts of the gradient and how many ranks hold the max
        both = all_reduce_sum(torch.stack([g.float(), held.float()]),
                              ctx.dist, ctx.axis)
        share = both[0] / both[1].clamp_min(1.0)
        return torch.where(held, share, 0.0).to(g.dtype), None, None


def sum_over(x: torch.Tensor, dist, axis=None) -> torch.Tensor:
    """:func:`all_reduce_sum`, whose gradient passes through unchanged: a
    row-parallel sum (each rank's partial gets the whole gradient)."""
    if size(dist, axis) == 1:
        return x
    return _SumOver.apply(x, dist, axis)


def copy_to(x: torch.Tensor, dist, axis=None) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``axis``: a replicated
    input of a column-parallel product (each rank's product gives a
    partial gradient)."""
    if size(dist, axis) == 1 or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, dist, axis)


def gather_from(x: torch.Tensor, dist, dim: int = -1,
                axis=None) -> torch.Tensor:
    """:func:`all_gather`, whose gradient is the rank's slice of the
    gathered tensor's (every rank holds the whole gradient)."""
    if size(dist, axis) == 1:
        return x
    return _GatherFrom.apply(x, dist, dim, axis)


def gather_weight(w: torch.Tensor, dist, dim: int,
                  axis=None) -> torch.Tensor:
    """The whole ``dim`` of a weight cut over ``axis`` (default ``model``),
    for a computation that each rank of the axis makes on it: each rank's
    gradient of the whole is its part, so the parts are summed over the
    axis (in f32) and cut back to this rank's block (a reduce-scatter)."""
    if size(dist, axis) == 1:
        return w
    return _GatherWeight.apply(w, dist, dim, _axis(dist, axis))


def fsdp_gather(w: torch.Tensor, dist, dim: int) -> torch.Tensor:
    """The whole ``dim`` of a weight placed on the FSDP axis; its gradient
    is reduce-scattered (summed over the ranks' tokens, in f32) back to
    this rank's block."""
    return gather_weight(w, dist, dim, dist.fsdp_axis)


def max_over(x: torch.Tensor, dist, axis=None) -> torch.Tensor:
    """The element-wise max of ``x`` over ``axis`` (default ``model``),
    where each rank's ``x`` reduces its slice of a tensor and each uses the
    max on its slice: the ranks' gradients are summed and go to the ranks
    whose ``x`` is the max (split evenly on a tie, as a max over the whole
    tensor splits it)."""
    if size(dist, axis) == 1:
        return x
    return _MaxOver.apply(x, dist, _axis(dist, axis))


def min_over(x: torch.Tensor, dist, axis=None) -> torch.Tensor:
    """The element-wise min counterpart of :func:`max_over`."""
    return -max_over(-x, dist, axis)
