"""Adam / AdamW as plain functions over parameter trees (port of
``repro.optim.adam``; the paper's fine-tuning setup, App. B.1).

The moments are f32 trees shaped like the parameters; ``step`` is a 0-d
int32 tensor on the parameters' device, so an update reads nothing back to
the host. The update follows the reference's order of operations, which
``torch.optim.Adam`` does not. The reference's ``chunked`` option (an XLA
memory workaround for huge stacked leaves) is not ported.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any                 # first moment, a tree like params
    nu: Any                 # second moment, a tree like params


def adam_init(params) -> AdamState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


adamw_init = adam_init


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, grad_scale=None):
    """Returns (updates, new_state). ``lr`` may be a scalar or a callable
    step -> scalar (schedule). ``weight_decay`` is decoupled (AdamW).
    ``grad_scale`` (e.g. a global-norm clip factor) multiplies each gradient
    inside the moment update."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    stepf = step.float()
    b1t = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    b2t = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)

    def leaf(g, m, v, p):
        g = g.float()
        if grad_scale is not None:
            g = g * grad_scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        u = (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return m2, v2, (-lr_t * u).to(p.dtype)

    out = tree_map(leaf, grads, state.mu, state.nu, params)
    pick = lambda i: _select(out, grads, i)     # noqa: E731
    return pick(2), AdamState(step=step, mu=pick(0), nu=pick(1))


def _select(out, template, i):
    """Component ``i`` of the (m, v, update) triples that ``tree_map`` put
    at the leaves of ``template``'s structure."""
    if isinstance(template, dict):
        return {k: _select(out[k], template[k], i) for k in template}
    if isinstance(template, (list, tuple)):
        parts = [_select(o, t, i) for o, t in zip(out, template)]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else type(template)(parts)
    return out[i]


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to at most ``max_norm`` in global L2 norm, the norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp_max(max_norm / (gnorm + 1e-12), 1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm
