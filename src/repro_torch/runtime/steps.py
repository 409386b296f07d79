"""Serve step factories (port of the prefill, admit, chunk-prefill,
decode and block-swap steps of ``repro.runtime.steps``). Each model step
builds a fresh ctx from ``ctx_factory`` and runs without autograd. Paged
caches need no extra plumbing: the block table rides inside the cache
dict.

``quant_telemetry=True`` returns a second closure (``prefill_t``,
``admit_t``, ``chunk_t``, ``decode_t``) whose ctx is armed for quant-health
telemetry and which returns ``(logits, cache, telemetry)``, the extra
output being the ``{site: [clipped, total, amax, range]}`` dict of device
tensors (``runtime.engine.Engine`` folds it); ``quant_telemetry=False``
returns the plain closure itself."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def _telem_ctx(ctx_factory):
    """A fresh ctx with quant telemetry armed: every fake-quant and deploy
    site it passes adds its vector to ``ctx.telemetry``. Returns (ctx, the
    dict)."""
    ctx = ctx_factory() if ctx_factory is not None else None
    if ctx is not None:
        ctx.telemetry = {}
        return ctx, ctx.telemetry
    return None, {}


def make_prefill_step(cfg: ModelConfig, *,
                      ctx_factory: Optional[Callable] = None, chunked=None,
                      quant_telemetry: bool = False):
    """prefill(params, tokens, cache[, positions]) -> (last_logits, cache).
    ``positions`` (B, T) carries the -1 dead-cell sentinel on pads."""
    @torch.no_grad()
    def prefill(params, tokens, cache, positions=None):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           ctx=ctx, chunked=chunked)

    if not quant_telemetry:
        return prefill

    @torch.no_grad()
    def prefill_t(params, tokens, cache, positions=None):
        ctx, tel = _telem_ctx(ctx_factory)
        logits, cache = tfm.prefill(cfg, params, tokens, cache,
                                    positions=positions, ctx=ctx,
                                    chunked=chunked)
        return logits, cache, tel
    return prefill_t


def make_admit_step(cfg: ModelConfig, *,
                    ctx_factory: Optional[Callable] = None, chunked=None,
                    quant_telemetry: bool = False):
    """Slot-insert prefill for continuous batching:
    admit(params, tokens (B, P), positions (B, P), admit_mask (B,), cache)
    -> (last_logits (B, 1, V), cache). Admitted lanes are reset first
    (``transformer.cache_reset_slots``) and prefilled with their left-padded
    prompt; the other lanes carry all -1 positions and pass through."""
    @torch.no_grad()
    def admit(params, tokens, positions, admit_mask, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        cache = tfm.cache_reset_slots(cache, admit_mask)
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           ctx=ctx, chunked=chunked)

    if not quant_telemetry:
        return admit

    @torch.no_grad()
    def admit_t(params, tokens, positions, admit_mask, cache):
        ctx, tel = _telem_ctx(ctx_factory)
        cache = tfm.cache_reset_slots(cache, admit_mask)
        logits, cache = tfm.prefill(cfg, params, tokens, cache,
                                    positions=positions, ctx=ctx,
                                    chunked=chunked)
        return logits, cache, tel
    return admit_t


def make_chunk_prefill_step(cfg: ModelConfig, *,
                            ctx_factory: Optional[Callable] = None,
                            chunked=None, quant_telemetry: bool = False):
    """Chunked prefill: chunk(params, tokens (B, C), positions (B, C),
    reset_mask (B,), cache) -> (last_logits (B, 1, V), cache). Appends one
    chunk at each prefilling lane's position (append-mode attention);
    lanes starting their first chunk are reset first, lanes not prefilling
    carry all -1 positions and pass through."""
    @torch.no_grad()
    def chunk(params, tokens, positions, reset_mask, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        cache = tfm.cache_reset_slots(cache, reset_mask)
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           ctx=ctx, chunked=chunked, append=True)

    if not quant_telemetry:
        return chunk

    @torch.no_grad()
    def chunk_t(params, tokens, positions, reset_mask, cache):
        ctx, tel = _telem_ctx(ctx_factory)
        cache = tfm.cache_reset_slots(cache, reset_mask)
        logits, cache = tfm.prefill(cfg, params, tokens, cache,
                                    positions=positions, ctx=ctx,
                                    chunked=chunked, append=True)
        return logits, cache, tel
    return chunk_t


def make_decode_step(cfg: ModelConfig, *,
                     ctx_factory: Optional[Callable] = None,
                     quant_telemetry: bool = False):
    """decode(params, tokens (B,1), pos (B,1), cache) -> (logits, cache)."""
    @torch.no_grad()
    def decode(params, tokens, pos, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.decode_step(cfg, params, tokens, pos, cache, ctx=ctx)

    if not quant_telemetry:
        return decode

    @torch.no_grad()
    def decode_t(params, tokens, pos, cache):
        ctx, tel = _telem_ctx(ctx_factory)
        logits, cache = tfm.decode_step(cfg, params, tokens, pos, cache,
                                        ctx=ctx)
        return logits, cache, tel
    return decode_t


def make_swap_steps():
    """Block swap-out / swap-in for over-commit preemption (paged caches
    only; thin wrappers over ``models.transformer``'s gather and scatter):

      swap_out(cache, ids (n,)) -> payload on the cache's device
      swap_in(cache, ids (n,), payload) -> cache, written in place

    ``ids`` are a lane's live physical blocks; swap-in writes the payload
    into the lane's new blocks in the same order, bit for bit, so the
    resumed lane emits the same greedy tokens. The engine moves the
    payload to host memory and back (``Engine.swap_out`` /
    ``Engine.swap_in``)."""
    def swap_out(cache, ids):
        return tfm.cache_gather_blocks(cache, ids)

    def swap_in(cache, ids, payload):
        return tfm.cache_scatter_blocks(cache, ids, payload)
    return swap_out, swap_in
