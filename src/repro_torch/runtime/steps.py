"""Serve step factories (port of the prefill, admit, chunk-prefill and
decode steps of ``repro.runtime.steps``). Each call builds a fresh ctx from
``ctx_factory`` and runs without autograd. Paged caches need no extra
plumbing: the block table rides inside the cache dict."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg: ModelConfig, *,
                      ctx_factory: Optional[Callable] = None, chunked=None):
    """prefill(params, tokens, cache[, positions]) -> (last_logits, cache).
    ``positions`` (B, T) carries the -1 dead-cell sentinel on pads."""
    @torch.no_grad()
    def prefill(params, tokens, cache, positions=None):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           ctx=ctx, chunked=chunked)
    return prefill


def make_admit_step(cfg: ModelConfig, *,
                    ctx_factory: Optional[Callable] = None, chunked=None):
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
    return admit


def make_chunk_prefill_step(cfg: ModelConfig, *,
                            ctx_factory: Optional[Callable] = None,
                            chunked=None):
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
    return chunk


def make_decode_step(cfg: ModelConfig, *,
                     ctx_factory: Optional[Callable] = None):
    """decode(params, tokens (B,1), pos (B,1), cache) -> (logits, cache)."""
    @torch.no_grad()
    def decode(params, tokens, pos, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.decode_step(cfg, params, tokens, pos, cache, ctx=ctx)
    return decode
