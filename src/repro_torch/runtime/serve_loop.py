"""Static batched serving over prefill / decode steps (port of the static
scheduler of ``repro.runtime.serve_loop``; continuous batching, paging,
chunked prefill, prefix sharing and preemption come with later slices).

``serve_batch`` packs up to ``batch_slots`` requests per group (prompts
left-padded to the group maximum, pads carrying the -1 dead-cell position),
prefills the group once, then decodes it in lockstep, greedily, until every
request of the group has its ``max_new_tokens``. Each lane decodes at its
own next position, so a short prompt packed next to longer ones decodes as
if it were served alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (T,) int
    max_new_tokens: int = 16
    priority: int = 0           # admission tier (continuous scheduler)
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class RequestLatency:
    """Per-request latency in model-call steps (see the reference)."""
    enqueue_step: int = 0
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    queue_wait_steps: int = 0


@dataclasses.dataclass
class TierLatency:
    requests: int = 0
    first_token_p50: float = 0.0
    first_token_p99: float = 0.0
    inter_token_p50: float = 0.0
    inter_token_p99: float = 0.0


@dataclasses.dataclass
class ServeStats:
    prefill_calls: int = 0
    chunk_steps: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    wall_s: float = 0.0
    cache_bytes: int = 0        # peak live KV-cache bytes
    tokens_per_s: float = 0.0
    slot_utilization: float = 0.0
    blocks_in_use: int = 0
    block_fragmentation: float = 0.0
    prefix_hit_tokens: int = 0
    prefill_tokens_saved: int = 0
    shared_blocks: int = 0
    prefix_hit_rate: float = 0.0
    preemptions: int = 0
    swapped_blocks: int = 0
    recomputed_tokens: int = 0
    queue_wait_steps: int = 0
    request_latency: Dict[int, RequestLatency] = \
        dataclasses.field(default_factory=dict)
    tier_latency: Dict[int, TierLatency] = \
        dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _check_capacity(requests: List[Request], max_len: Optional[int]) -> None:
    """Reject requests whose decode would write past a ``max_len``-slot
    cache (the final token is emitted without a write, so the last write
    lands at position len(prompt) + quota - 2): such writes would be
    dropped and silently truncate the attended context."""
    if max_len is None:
        return
    for r in requests:
        if r.max_new_tokens <= 0:
            continue
        need = len(r.prompt) + r.max_new_tokens - 1
        if need > max_len:
            raise ValueError(
                f"request {r.rid}: prompt ({len(r.prompt)}) + "
                f"max_new_tokens ({r.max_new_tokens}) needs {need} cache "
                f"slots but the cache holds max_len={max_len}; later KV "
                "writes would be silently dropped")


def _pack_prompts(group: List[Request], T: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts to length T. Returns (tokens (B,T), positions (B,T))
    with real positions 0..len-1 and the -1 dead-cell sentinel on pads."""
    toks = np.zeros((len(group), T), np.int32)
    posm = np.full((len(group), T), -1, np.int32)
    for i, r in enumerate(group):
        n = len(r.prompt)
        if n == 0:
            raise ValueError(f"request {r.rid}: empty prompt (an all-dead "
                             f"lane has no last-token logits to decode from)")
        if n > T:
            raise ValueError(f"request {r.rid}: prompt length {n} exceeds "
                             f"the packing length {T}")
        toks[i, T - n:] = r.prompt
        posm[i, T - n:] = np.arange(n)
    return toks, posm


class _Book:
    """Emission / latency / utilization bookkeeping."""

    def __init__(self, stats: ServeStats, batch_slots: int):
        self.stats = stats
        self.slots = batch_slots
        self.step = 0
        self.cells = 0
        self.active_cells = 0
        self.priority: Dict[int, int] = {}
        self.emitted: Dict[int, int] = {}

    def enqueue(self, r: Request) -> None:
        self.stats.request_latency[r.rid] = RequestLatency(
            enqueue_step=self.step)
        self.priority[r.rid] = r.priority

    def admit(self, r: Request) -> None:
        lat = self.stats.request_latency[r.rid]
        wait = self.step - lat.enqueue_step
        lat.queue_wait_steps += wait
        self.stats.queue_wait_steps += wait
        lat.admit_step = self.step

    def emit(self, r: Request, tok: int) -> None:
        r.tokens_out.append(int(tok))
        self.stats.tokens_generated += 1
        self.emitted[r.rid] = self.emitted.get(r.rid, 0) + 1
        lat = self.stats.request_latency[r.rid]
        if lat.first_token_step < 0:
            lat.first_token_step = self.step
        lat.finish_step = self.step
        if len(r.tokens_out) >= r.max_new_tokens:
            r.done = True

    def track_cache(self, cache) -> None:
        self.stats.cache_bytes = max(self.stats.cache_bytes,
                                     _tree_bytes(cache))

    def count_decode(self, n_active: int) -> None:
        self.stats.decode_steps += 1
        self.cells += self.slots
        self.active_cells += n_active

    def finalize(self, t_start: float) -> ServeStats:
        s = self.stats
        s.wall_s = time.perf_counter() - t_start
        s.tokens_per_s = s.tokens_generated / max(s.wall_s, 1e-9)
        s.slot_utilization = (self.active_cells / self.cells
                              if self.cells else 0.0)
        by_tier: Dict[int, List[Tuple[int, RequestLatency]]] = {}
        for rid, lat in s.request_latency.items():
            if lat.first_token_step >= 0:
                by_tier.setdefault(self.priority.get(rid, 0), []).append(
                    (rid, lat))
        for tier, entries in sorted(by_tier.items()):
            first = [lat.first_token_step - lat.enqueue_step
                     for _, lat in entries]
            inter = [(lat.finish_step - lat.first_token_step)
                     / (self.emitted[rid] - 1)
                     for rid, lat in entries if self.emitted.get(rid, 0) >= 2]
            s.tier_latency[tier] = TierLatency(
                requests=len(entries),
                first_token_p50=float(np.percentile(first, 50)),
                first_token_p99=float(np.percentile(first, 99)),
                inter_token_p50=(float(np.percentile(inter, 50))
                                 if inter else 0.0),
                inter_token_p99=(float(np.percentile(inter, 99))
                                 if inter else 0.0))
        return s


def _greedy(logits) -> np.ndarray:
    """(B, 1, V) logits -> (B, 1) int32 argmax tokens on the host."""
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32).cpu().numpy()


def serve_batch(prefill_fn: Callable, decode_fn: Callable, init_cache_fn,
                requests: List[Request], *, batch_slots: int,
                max_len: Optional[int] = None, device=None) -> ServeStats:
    """Static-batch serving (greedy).

    prefill_fn: (tokens (B,T), positions (B,T), cache) -> (logits, cache)
    decode_fn:  (tokens (B,1), pos (B,1), cache) -> (logits, cache)
    ``device``: where tokens and positions are placed for the steps.
    """
    _check_capacity(requests, max_len)
    stats = ServeStats()
    book = _Book(stats, batch_slots)
    t_start = time.perf_counter()
    for r in requests:
        if r.max_new_tokens <= 0:
            r.done = True
    live = [r for r in requests if r.max_new_tokens > 0]
    for r in live:
        book.enqueue(r)

    def put(a):
        return torch.as_tensor(a, device=device)

    for lo in range(0, len(live), batch_slots):
        group = live[lo:lo + batch_slots]
        T = max(len(r.prompt) for r in group)
        toks, posm = _pack_prompts(group, T)
        cache = init_cache_fn(len(group))
        book.track_cache(cache)
        for r in group:
            book.admit(r)
        logits, cache = prefill_fn(put(toks), put(posm), cache)
        stats.prefill_calls += 1
        book.step += 1
        book.track_cache(cache)
        # each lane decodes at ITS next position (prompt length)
        pos = np.array([[len(r.prompt)] for r in group], np.int32)
        cur = _greedy(logits)
        for _ in range(max(r.max_new_tokens for r in group)):
            for i, r in enumerate(group):
                if not r.done:
                    book.emit(r, cur[i, 0])
            if all(r.done for r in group):
                break
            n_active = sum(not r.done for r in group)
            logits, cache = decode_fn(put(cur), put(pos), cache)
            book.count_decode(n_active)
            book.step += 1
            book.track_cache(cache)
            cur = _greedy(logits)
            pos = pos + 1
    return book.finalize(t_start)


def serve(prefill_step: Callable, decode_step: Callable, init_cache_fn,
          params, requests: List[Request], *, scheduler: str = "static",
          batch_slots: int, max_len: Optional[int] = None,
          device=None) -> ServeStats:
    """Bind ``params`` into the step functions (``runtime.steps``
    signatures, params first) and serve with the chosen scheduler."""
    if scheduler != "static":
        raise NotImplementedError(f"scheduler {scheduler!r} is not yet "
                                  "ported (static only)")
    return serve_batch(lambda t, pm, c: prefill_step(params, t, c, pm),
                       lambda t, p, c: decode_step(params, t, p, c),
                       init_cache_fn, requests, batch_slots=batch_slots,
                       max_len=max_len, device=device)
