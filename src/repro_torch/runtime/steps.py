"""Serve step factories (port of ``make_prefill_step`` / ``make_decode_step``
of ``repro.runtime.steps``). Each call builds a fresh ctx from
``ctx_factory`` and runs without autograd."""
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


def make_decode_step(cfg: ModelConfig, *,
                     ctx_factory: Optional[Callable] = None):
    """decode(params, tokens (B,1), pos (B,1), cache) -> (logits, cache)."""
    @torch.no_grad()
    def decode(params, tokens, pos, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.decode_step(cfg, params, tokens, pos, cache, ctx=ctx)
    return decode
