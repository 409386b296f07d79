"""8-bit Adam — the paper's grouped quantization applied to optimizer
state (port of ``repro.optim.quantized_adam``; cf. Dettmers et al.'s
block-wise 8-bit optimizers).

Large parameter leaves store their Adam moments as int8 with one f32 scale
per row of the last dim. First moment: symmetric int8; second moment
(non-negative): the [0, 127] grid. Small leaves (norms, biases) keep plain
f32 moments: their memory is negligible and their dynamics matter. Memory
per big-leaf parameter: 2 x (1 + 4 / last_dim) bytes instead of 8.

The arithmetic is the jitted reference's: XLA computes ``amax / 127.0`` as
``amax * f32(1/127)`` (see ``_quant``), and ``torch.round`` rounds half to
even as ``jnp.round`` does.

Under a rank mesh (``runtime.steps.make_train_step(dist=)``) each rank
updates its slices: which leaves are quantized is decided on their
logical (whole) shapes (``qadam_init(logical=)``), and a row whose last
dim is sharded takes the max of its slices' amax over that dim's axes, so
the int8 codes are the unsharded ones (``qadam_update(shardings=)``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.optim.adam import _select
from repro_torch.optim.tree import tree_leaves, tree_map

QUANT_MIN_ELEMS = 1 << 20       # leaves smaller than this keep f32 moments
QUANT_MIN_LASTDIM = 256
# the jitted reference divides by the constant 127 as a product with its
# f32 reciprocal, which differs from the quotient in the last bit for
# about half the inputs
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


class QAdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any     # per leaf: {"q": int8 param-shaped, "s": f32 rows} or f32
    nu: Any


def _is_mdict(x) -> bool:
    return isinstance(x, dict) and "q" in x


def _quantizable(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.numel() >= QUANT_MIN_ELEMS and \
        p.shape[-1] >= QUANT_MIN_LASTDIM


def _quant(x: torch.Tensor, *, symmetric: bool, dist=None,
           row_axis=None) -> dict:
    amax = torch.amax(x.abs() if symmetric else x, dim=-1)
    if row_axis is not None:
        from repro_torch.parallel import collectives as coll
        amax = coll.all_reduce_max(amax, dist, row_axis)
    s = torch.clamp_min(amax * _INV_127, 1e-20)
    q = torch.round(x / s[..., None])
    q = torch.clamp(q, -127 if symmetric else 0, 127).to(torch.int8)
    return {"q": q, "s": s}


def _dequant(m: dict) -> torch.Tensor:
    return m["q"].float() * m["s"][..., None]


def qadam_init(params, logical=None) -> QAdamState:
    """Zero moments for ``params``; ``logical`` (a tree of the same
    structure: the whole leaves, or meta tensors of their shapes) decides
    which leaves are quantized where ``params`` holds a rank's slices."""
    def z(p, whole=None):
        if _quantizable(p if whole is None else whole):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.full(p.shape[:-1], 1e-20,
                                    dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    rest = () if logical is None else (logical,)
    return QAdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(z, params, *rest),
                      nu=tree_map(z, params, *rest))


@torch.no_grad()
def qadam_update(grads, state: QAdamState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_scale=None,
                 inplace: bool = False, shardings=None):
    """Same contract as ``adam_update``, int8 moment storage for big
    leaves. ``inplace``: the new moments (payloads and row scales)
    overwrite ``state``'s tensors leaf by leaf. ``shardings``: the
    params' ``NamedSharding`` tree when ``params`` are a rank's slices
    (a sharded last dim's row amax is reduced over its axes)."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    stepf = step.float()
    b1t = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    b2t = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)

    def store(old, new):
        if not inplace:
            return new
        if _is_mdict(old):
            old["q"].copy_(new["q"])
            old["s"].copy_(new["s"])
            return old
        return old.copy_(new)

    def leaf(g, m, v, p, sh=None):
        g = g.float()
        if grad_scale is not None:
            g = g * grad_scale
        m_f = _dequant(m) if _is_mdict(m) else m
        v_f = _dequant(v) if _is_mdict(v) else v
        m2 = b1 * m_f + (1 - b1) * g
        v2 = b2 * v_f + (1 - b2) * torch.square(g)
        u = (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
        kw = {}
        if sh is not None and len(sh.spec) == p.dim() and sh.spec[-1]:
            from repro_torch.models.transformer import DistContext
            kw = dict(dist=DistContext(mesh=sh.mesh), row_axis=sh.spec[-1])
        m_out = _quant(m2, symmetric=True, **kw) if _is_mdict(m) else m2
        v_out = _quant(v2, symmetric=False, **kw) if _is_mdict(v) else v2
        return store(m, m_out), store(v, v_out), (-lr_t * u).to(p.dtype)

    rest = () if shardings is None else (shardings,)
    out = tree_map(leaf, grads, state.mu, state.nu, params, *rest)
    pick = lambda i: _select(out, grads, i)     # noqa: E731
    return pick(2), QAdamState(step=step, mu=pick(0), nu=pick(1))


def qadam_shardings(param_shardings):
    """The reference's rule for an 8-bit moment's shardings: a function
    of a param's ``NamedSharding`` giving the moment's ``{"q": payload,
    "s": row scales}``, the payload as the param and the scales its spec
    without the last entry. ``ndim`` (the param's) pads a spec whose
    trailing replicated dims were trimmed before dropping the entry of
    the last dim; the reference drops the last entry left, which is a
    sharded dim's where the last dims are replicated."""
    from repro_torch.parallel.sharding import NamedSharding, _finish

    def for_leaf(sh, ndim=None):
        spec = tuple(sh.spec)
        if ndim is not None:
            spec = spec + (None,) * (ndim - len(spec))
        return {"q": sh, "s": NamedSharding(sh.mesh, _finish(spec[:-1]))}
    return for_leaf
