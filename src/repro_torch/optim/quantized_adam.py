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
even as ``jnp.round`` does. The reference's ``qadam_shardings`` waits for
multi-device training (ROADMAP Queue 1 item 6).
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


def _quant(x: torch.Tensor, *, symmetric: bool) -> dict:
    amax = torch.amax(x.abs() if symmetric else x, dim=-1)
    s = torch.clamp_min(amax * _INV_127, 1e-20)
    q = torch.round(x / s[..., None])
    q = torch.clamp(q, -127 if symmetric else 0, 127).to(torch.int8)
    return {"q": q, "s": s}


def _dequant(m: dict) -> torch.Tensor:
    return m["q"].float() * m["s"][..., None]


def qadam_init(params) -> QAdamState:
    def z(p):
        if _quantizable(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.full(p.shape[:-1], 1e-20,
                                    dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return QAdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(z, params), nu=tree_map(z, params))


@torch.no_grad()
def qadam_update(grads, state: QAdamState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_scale=None,
                 inplace: bool = False):
    """Same contract as ``adam_update``, int8 moment storage for big
    leaves. ``inplace``: the new moments (payloads and row scales)
    overwrite ``state``'s tensors leaf by leaf."""
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

    def leaf(g, m, v, p):
        g = g.float()
        if grad_scale is not None:
            g = g * grad_scale
        m_f = _dequant(m) if _is_mdict(m) else m
        v_f = _dequant(v) if _is_mdict(v) else v
        m2 = b1 * m_f + (1 - b1) * g
        v2 = b2 * v_f + (1 - b2) * torch.square(g)
        u = (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
        m_out = _quant(m2, symmetric=True) if _is_mdict(m) else m2
        v_out = _quant(v2, symmetric=False) if _is_mdict(v) else v2
        return store(m, m_out), store(v, v_out), (-lr_t * u).to(p.dtype)

    out = tree_map(leaf, grads, state.mu, state.nu, params)
    pick = lambda i: _select(out, grads, i)     # noqa: E731
    return pick(2), QAdamState(step=step, mu=pick(0), nu=pick(1))
