"""The serving engine: every model call of the continuous scheduler behind
one interface (port of the fused path of ``repro.runtime.engine``).

The Scheduler (``runtime.serve_loop``) decides which requests to admit and
retire and keeps the books (policy); the Engine makes the model calls —
``admit`` (slot-insert prefill), ``chunk`` (append-mode chunked prefill)
and ``generate`` (one greedy decode step over every lane) — places the
host inputs on the device and reads the greedy tokens back (mechanism).

Not yet ported: the decomposed ``prefill`` / ``insert`` API, block swap
and copy-on-write, quant-health telemetry, and mesh placement.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


class DecodeState(NamedTuple):
    """Per-lane decode state: ``tokens`` (B, 1) and ``pos`` (B, 1) int32 are
    host numpy (pos -1 marks an idle lane, whose output is discarded and
    whose cache writes are dropped); ``cache`` lives on the device."""
    tokens: np.ndarray
    pos: np.ndarray
    cache: Any


def greedy(logits) -> np.ndarray:
    """(B, 1) int32 argmax of the last position's logits, on the host (the
    read-back waits for the device)."""
    return torch.argmax(logits[:, -1:], dim=-1).to(
        torch.int32).cpu().numpy()


class Engine:
    """Model calls over step functions with fixed shapes.

    admit_fn: (tokens (B,P), positions (B,P), admit_mask (B,), cache)
              -> (last_logits (B,1,V), cache)
    decode_fn: (tokens (B,1), pos (B,1), cache) -> (logits (B,1,V), cache)
    chunk_fn:  (tokens (B,C), positions (B,C), reset_mask (B,), cache)
              -> (last_logits (B,1,V), cache)       [chunked prefill only]
    init_cache_fn: (batch,) -> model cache dict

    ``device``: where host inputs go (None: the GPU). Decoding is greedy.
    """

    def __init__(self, admit_fn: Callable, decode_fn: Callable,
                 init_cache_fn: Callable, *, batch_slots: int,
                 chunk_fn: Optional[Callable] = None, device=None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        self.admit_fn = admit_fn
        self.decode_fn = decode_fn
        self.chunk_fn = chunk_fn
        self.init_cache_fn = init_cache_fn
        self.batch_slots = batch_slots
        self.device = resolve_device(device)

    def _put(self, x):
        return torch.as_tensor(x, device=self.device)

    def init_state(self) -> DecodeState:
        """A fresh all-idle decode state: every lane dead (pos -1)."""
        B = self.batch_slots
        return DecodeState(tokens=np.zeros((B, 1), np.int32),
                           pos=np.full((B, 1), -1, np.int32),
                           cache=self.init_cache_fn(B))

    def admit(self, tokens, positions, admit_mask, cache):
        """Reset the masked lanes and prefill their packed prompts in one
        model call. Returns ((B, 1) greedy first tokens, cache)."""
        logits, cache = self.admit_fn(self._put(tokens), self._put(positions),
                                      self._put(admit_mask), cache)
        return greedy(logits), cache

    def chunk(self, tokens, positions, reset_mask, cache):
        """One append-mode chunked-prefill step. Returns ((B, 1) greedy
        tokens from the chunk's final position, cache)."""
        if self.chunk_fn is None:
            raise ValueError("engine was built without a chunk_fn")
        logits, cache = self.chunk_fn(self._put(tokens), self._put(positions),
                                      self._put(reset_mask), cache)
        return greedy(logits), cache

    def generate(self, state: DecodeState):
        """One greedy decode step over every lane. Returns ((B, 1) next
        tokens, cache); idle lanes give tokens the caller ignores."""
        logits, cache = self.decode_fn(self._put(state.tokens),
                                       self._put(state.pos), state.cache)
        return greedy(logits), cache
