"""Mixture-of-Experts with top-k routing and capacity-based, sort-ordered
dispatch (port of ``repro.models.moe``).

Two execution paths share the routing math:

  * ``moe_apply`` routes each token to its top-k experts, scatters the
    routed rows into an (E, C, D) buffer in expert-sorted order (rows past
    an expert's capacity C go to a trash row: dropped), runs the batched
    expert matmuls and combines the outputs weighted by the router's
    probabilities.
  * ``moe_apply_sharded`` is the reference's expert-parallel body (run
    inside ``shard_map`` there) on one rank of the ``model`` axis: every
    rank holds every token, routes all of them and dispatches over the
    full expert range, then keeps the rows of its own E/N experts; the sum
    over ``model`` (``collectives.all_reduce_sum``, in f32) adds the
    ranks' disjoint outputs, so no all-to-all is needed. In hybrid mode
    (an expert count the ranks do not divide: grok-1's 8 experts on the
    reference's 16-way mesh) every rank holds all experts on a d_ff slice,
    and the same sum adds the partial-F products (the activation is
    elementwise over F). As in the reference, the sharded body's router
    takes no ctx: its ``router_logits`` site is neither quantized nor
    observed there.

The experts are plain batched matmuls (the reference's are ``jnp.einsum``
outside any Pallas kernel).

Every integer of the dispatch equals the reference's bit for bit: top-k
keeps the lower expert id first on ties (a stable descending sort, as
``jax.lax.top_k``), and the dispatch sorts with a stable argsort. The
combine adds each token's k rows in increasing expert id, starting at
zero, with one vectorized add per choice: the order in which the
reference's scatter-add meets them, and the same order on every run (no
atomics, unlike ``index_add_`` on the card).

Router logits are range-sensitive (softmax input); they pass through the
activation site ``{prefix}/router_logits``. The experts' weights are not
under ``ctx.weight``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.common import (ACTIVATIONS, dense_init,
                                       matmul_dtype, resolve_weight)
from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    activation: str = "silu"
    norm_topk: bool = True         # qwen3 normalizes top-k probs
    min_capacity: int = 8          # decode-time floor (no drops at tiny t)


def _capacity(t: int, cfg: MoEConfig) -> int:
    """Per-expert slot count: capacity-factor based, floored for tiny token
    counts (decode must never drop), never above t (an expert can receive at
    most one row per token)."""
    cap = int(t * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(1, min(t, max(cap, cfg.min_capacity)))


def router_probs(p, x, cfg: MoEConfig, ctx=None, prefix="moe"):
    """x: (t, D) -> (probs (t, E) f32, top_p (t, k), top_e (t, k) int64)."""
    logits = x.float() @ p["router"].float()
    if ctx is not None:
        logits = ctx.act(f"{prefix}/router_logits", logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    if cfg.norm_topk:
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def _dispatch_indices(top_e, num_experts: int, capacity: int,
                      e_lo: int = 0, e_hi: Optional[int] = None):
    """Sort-based dispatch bookkeeping.

    top_e: (t, k) expert ids. Returns (order, slot, keep, token_of_row) where
    rows are the t*k (token, choice) pairs in expert-sorted order; ``slot`` is
    the destination row in the local ((e_hi - e_lo) * C) buffer of experts
    [e_lo, e_hi) (overflow and other experts' rows -> trash).
    """
    t, k = top_e.shape
    e_hi = num_experts if e_hi is None else e_hi
    flat_e = top_e.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)                 # (t*k,)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=top_e.device))
    pos = torch.arange(t * k, device=top_e.device) - starts[sorted_e]
    keep = (sorted_e >= e_lo) & (sorted_e < e_hi) & (pos < capacity)
    slot = torch.where(keep, (sorted_e - e_lo) * capacity + pos,
                       torch.full_like(pos, (e_hi - e_lo) * capacity))
    token_of_row = order // k
    return order, slot, keep, token_of_row


def _expert_ffn(p, buf, cfg: MoEConfig):
    """buf: (E, C, D) -> (E, C, D) through per-expert gated MLP."""
    act = ACTIVATIONS[cfg.activation]
    wg, wu, wo = (resolve_weight(p[n], matmul_dtype(buf))
                  for n in ("w_gate", "w_up", "w_out"))
    dt = torch.promote_types(buf.dtype, wg.dtype)
    b = buf.to(dt)
    h = act(torch.bmm(b, wg.to(dt))) * torch.bmm(b, wu.to(dt))
    return torch.bmm(h, wo.to(dt))


def _compute_combine(p, x, top_p, order, slot, keep, token_of_row,
                     e_local: int, capacity: int, cfg: MoEConfig):
    """The kept rows through their experts (``slot``: each row's place in
    the local (e_local * C) buffer), combined per token weighted by router
    prob."""
    t, d = x.shape
    k = top_p.shape[1]
    # Scatter token rows into the expert buffer (+1 trash row; every row
    # written there is a row not kept, zeroed).
    buf = torch.zeros((e_local * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[slot] = x[token_of_row] * keep[:, None].to(x.dtype)
    y = _expert_ffn(p, buf[:-1].reshape(e_local, capacity, d), cfg)
    # Gather each routed row's output, weighted by its router prob.
    y_rows = torch.cat([y.reshape(e_local * capacity, d),
                        torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    contrib = y_rows[slot] * top_p.reshape(-1)[order][:, None].to(y.dtype)
    contrib = torch.where(keep[:, None], contrib,
                          torch.zeros((), dtype=contrib.dtype,
                                      device=contrib.device)).to(x.dtype)
    # Combine: token i's rows, in increasing expert id (the sorted order),
    # added one choice at a time onto zeros.
    row_of = torch.empty_like(order)
    row_of[order] = torch.arange(t * k, device=x.device)
    rows = torch.sort(row_of.reshape(t, k), dim=1).values
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for r in range(k):
        out = out + contrib[rows[:, r]]
    return out


def _dispatch_compute_combine(p, x, top_p, top_e, cfg: MoEConfig,
                              capacity: int, e_lo: int = 0,
                              e_hi: Optional[int] = None):
    e_hi = cfg.num_experts if e_hi is None else e_hi
    order, slot, keep, token_of_row = _dispatch_indices(
        top_e, cfg.num_experts, capacity, e_lo, e_hi)
    return _compute_combine(p, x, top_p, order, slot, keep, token_of_row,
                            e_hi - e_lo, capacity, cfg)


def moe_apply(p, x, cfg: MoEConfig, *, ctx=None, prefix="moe"):
    """Single-shard MoE. x: (t, D) flattened tokens."""
    t = x.shape[0]
    capacity = _capacity(t, cfg)
    _, top_p, top_e = router_probs(p, x, cfg, ctx, prefix)
    return _dispatch_compute_combine(p, x, top_p, top_e, cfg, capacity)


def moe_apply_sharded(p, x, cfg: MoEConfig, *, dist,
                      expert_parallel: bool = True):
    """The expert-parallel MoE body on this rank of ``dist``'s ``model``
    axis (the reference's, run inside ``shard_map`` there).

    x: (t, D), the same tokens on every rank of the ``model`` axis (a
    data-parallel shard's under a ``data`` axis, routed and cut to
    capacity on their own). expert_parallel=True: ``p`` carries this
    rank's E/N experts [r*E/N, (r+1)*E/N); the sum over ``model`` adds
    disjoint expert outputs. expert_parallel=False (hybrid): ``p``
    carries ALL experts on a d_ff slice; the same sum reduces the
    partial-F products. The router is whole and takes no ctx."""
    t, d = x.shape
    n = coll.tp_size(dist)
    e_local = cfg.num_experts // n if expert_parallel else cfg.num_experts
    e_lo = coll.tp_index(dist) * e_local if expert_parallel else 0
    capacity = _capacity(t, cfg)
    # every rank's experts see x and the router: their gradients sum over
    # model (in training)
    x = coll.copy_to(x, dist)
    p = dict(p, router=coll.copy_to(p["router"], dist))
    _, top_p, top_e = router_probs(p, x, cfg)
    order, slot, keep, token_of_row = _dispatch_indices(
        top_e, cfg.num_experts, capacity, 0, cfg.num_experts)
    # re-localize: keep only experts in [e_lo, e_lo + e_local)
    sorted_e = top_e.reshape(-1).long()[order]
    local = (sorted_e >= e_lo) & (sorted_e < e_lo + e_local) & keep
    local_slot = torch.where(local, (sorted_e - e_lo) * capacity
                             + slot % capacity,
                             torch.full_like(slot, e_local * capacity))
    out = _compute_combine(p, x, top_p, order, local_slot, local,
                           token_of_row, e_local, capacity, cfg)
    return coll.sum_over(out, dist)


def aux_load_balance_loss(probs, top_e, cfg: MoEConfig):
    """Switch-style load-balancing auxiliary loss."""
    t = probs.shape[0]
    me = torch.mean(probs, dim=0)                                  # (E,)
    counts = torch.zeros((cfg.num_experts,), dtype=torch.float32,
                         device=probs.device)
    counts = counts.index_add(
        0, top_e.reshape(-1).long(),
        torch.ones(top_e.numel(), dtype=torch.float32, device=probs.device))
    ce = counts / max(t * cfg.top_k, 1)
    return cfg.num_experts * torch.sum(me * ce)


def init_moe_params(gen, d_model: int, cfg: MoEConfig, dtype=torch.float32,
                    device=None, num_local_experts: Optional[int] = None):
    """The reference's distributions (router ``dense_init``; experts
    N(0, 1/d) and N(0, 1/d_ff)), drawn from ``gen`` in the order router,
    w_gate, w_up, w_out: ``num_local_experts`` experts (default all), the
    router over all of them."""
    e = num_local_experts or cfg.num_experts

    def normal(shape, std):
        return torch.randn(shape, generator=gen,
                           device=device).mul_(std).to(dtype)
    return {
        "router": dense_init(gen, d_model, cfg.num_experts, dtype,
                             device=device),
        "w_gate": normal((e, d_model, cfg.d_ff), 1.0 / math.sqrt(d_model)),
        "w_up": normal((e, d_model, cfg.d_ff), 1.0 / math.sqrt(d_model)),
        "w_out": normal((e, cfg.d_ff, d_model), 1.0 / math.sqrt(cfg.d_ff)),
    }
