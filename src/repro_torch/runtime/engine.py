"""The serving engine: every model call of the continuous scheduler behind
one interface (port of the fused path of ``repro.runtime.engine``).

The Scheduler (``runtime.serve_loop``) decides which requests to admit and
retire and keeps the books (policy); the Engine makes the model calls —
``admit`` (slot-insert prefill), ``chunk`` (append-mode chunked prefill)
``generate`` (one greedy decode step over every lane), ``copy_block``
(the device half of copy-on-write) and ``swap_out`` / ``swap_in`` (a
preempted lane's blocks to host memory and back) — places the host inputs
on the device and reads the greedy tokens back (mechanism). Steps built
with ``quant_telemetry=True`` return their quant-health site vectors as a
third output; the engine gathers them into one (n, 4) tensor, copies it to
the host in the same stream as the greedy tokens (one read-back a step,
however many sites) and folds it into ``telemetry_sink``.

Not yet ported: the decomposed ``prefill`` / ``insert`` API and mesh
placement.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import _map


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
    copy_block_fn: (cache, src, dst) -> cache  [copy-on-write only;
              ``models.transformer.cache_copy_block``]
    swap_out_fn: (cache, ids) -> payload; swap_in_fn: (cache, ids, payload)
              -> cache  [swap-mode preemption only;
              ``runtime.steps.make_swap_steps``]

    ``device``: where host inputs go (None: the GPU). Decoding is greedy.
    ``telemetry_sink``: called with each armed step's {site: host array}
    dict (``runtime.telemetry.QuantHealth.update``).
    """

    def __init__(self, admit_fn: Callable, decode_fn: Callable,
                 init_cache_fn: Callable, *, batch_slots: int,
                 chunk_fn: Optional[Callable] = None,
                 copy_block_fn: Optional[Callable] = None,
                 swap_out_fn: Optional[Callable] = None,
                 swap_in_fn: Optional[Callable] = None,
                 telemetry_sink: Optional[Callable] = None, device=None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        self.admit_fn = admit_fn
        self.decode_fn = decode_fn
        self.chunk_fn = chunk_fn
        self.init_cache_fn = init_cache_fn
        self.copy_block_fn = copy_block_fn
        self.swap_out_fn = swap_out_fn
        self.swap_in_fn = swap_in_fn
        self.batch_slots = batch_slots
        self.telemetry_sink = telemetry_sink
        self.device = resolve_device(device)

    def _put(self, x):
        return torch.as_tensor(x, device=self.device)

    def _unwrap(self, out):
        """Greedy tokens of a step's output, and its cache. A third output
        (an armed step's {site: (4,) or (n_super, 4)} vectors) is gathered
        into one (n, 4) tensor whose copy to pinned host memory is queued
        before the tokens' blocking read-back, which therefore waits for it
        too: the sink gets host arrays and the step syncs once."""
        if len(out) == 2:
            return greedy(out[0]), out[1]
        logits, cache, tel = out
        if self.telemetry_sink is None or not tel:
            return greedy(logits), cache
        flat = torch.cat([v.reshape(-1, 4) for v in tel.values()])
        host = flat
        if flat.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
        tokens = greedy(logits)
        rows, at, folded = host.numpy(), 0, {}
        for site, v in tel.items():
            n = v.numel() // 4
            folded[site] = rows[at:at + n].reshape(v.shape)
            at += n
        self.telemetry_sink(folded)
        return tokens, cache

    def init_state(self) -> DecodeState:
        """A fresh all-idle decode state: every lane dead (pos -1)."""
        B = self.batch_slots
        return DecodeState(tokens=np.zeros((B, 1), np.int32),
                           pos=np.full((B, 1), -1, np.int32),
                           cache=self.init_cache_fn(B))

    def admit(self, tokens, positions, admit_mask, cache):
        """Reset the masked lanes and prefill their packed prompts in one
        model call. Returns ((B, 1) greedy first tokens, cache)."""
        return self._unwrap(self.admit_fn(self._put(tokens),
                                          self._put(positions),
                                          self._put(admit_mask), cache))

    def chunk(self, tokens, positions, reset_mask, cache):
        """One append-mode chunked-prefill step. Returns ((B, 1) greedy
        tokens from the chunk's final position, cache)."""
        if self.chunk_fn is None:
            raise ValueError("engine was built without a chunk_fn")
        return self._unwrap(self.chunk_fn(self._put(tokens),
                                          self._put(positions),
                                          self._put(reset_mask), cache))

    def generate(self, state: DecodeState):
        """One greedy decode step over every lane. Returns ((B, 1) next
        tokens, cache); idle lanes give tokens the caller ignores."""
        return self._unwrap(self.decode_fn(self._put(state.tokens),
                                           self._put(state.pos),
                                           state.cache))

    def copy_block(self, cache, src: int, dst: int):
        """Clone physical block ``src`` into ``dst`` in every paged arena
        (the device half of copy-on-write); the ids go to the device as
        0-d tensors, so one code path serves every copy."""
        if self.copy_block_fn is None:
            raise ValueError("engine was built without a copy_block_fn")
        return self.copy_block_fn(
            cache, torch.tensor(src, dtype=torch.int64, device=self.device),
            torch.tensor(dst, dtype=torch.int64, device=self.device))

    def swap_out(self, cache, ids):
        """Gather physical blocks ``ids`` (a host array) of every paged arena
        into host memory (the swap-out half of a preemption). On the card
        the gather is enqueued on the current stream before any later write
        into those blocks, each tensor is copied into pinned host memory
        without blocking, and one stream synchronisation makes the payload
        complete before it is returned."""
        if self.swap_out_fn is None:
            raise ValueError("engine was built without swap steps")
        payload = self.swap_out_fn(cache, self._put(ids))
        if self.device.type != "cuda":
            return payload
        host = _map(lambda x: torch.empty(
            x.shape, dtype=x.dtype, pin_memory=True).copy_(
                x, non_blocking=True), payload)
        torch.cuda.current_stream(self.device).synchronize()
        return host

    def swap_in(self, cache, ids, payload):
        """Write a :meth:`swap_out` payload into the lane's new blocks
        ``ids`` (the resume half), in place, bit for bit. A pinned payload
        goes to the device without blocking; the pinned allocator keeps
        its memory until that copy has run, whatever becomes of
        ``payload``. Returns ``cache``."""
        if self.swap_in_fn is None:
            raise ValueError("engine was built without swap steps")
        dev = _map(lambda x: x.to(self.device, non_blocking=True), payload)
        return self.swap_in_fn(cache, self._put(ids), dev)
