"""Batched serving over prefill / admit / chunk / decode steps (port of
the static and the continuous schedulers of ``repro.runtime.serve_loop``).

* ``serve_batch`` — static groups: packs up to ``batch_slots`` requests
  per group (prompts left-padded to the group maximum, pads carrying the -1
  dead-cell position), prefills the group once, then decodes it in
  lockstep, greedily, until every request of the group has its quota.
* ``Scheduler`` / ``serve_continuous`` — continuous batching over a fixed
  pool of lanes: finished requests retire at once and queued ones are
  admitted into the freed lanes mid-flight (slot-insert prefill), FIFO.
  With ``prefill_chunk=N`` admission is host bookkeeping only and each
  admitted prompt is appended N tokens per chunk step, one chunk step per
  decode step. With a ``block_pool`` the cache is paged: admission
  reserves the worst case and maps the first blocks, growth follows the
  writes, retirement frees the lane's blocks.

Each lane decodes at its own next position, so a request gets the same
greedy tokens whatever it is packed with. Prefix sharing, over-commit with
preemption, ``decode_ratio > 1`` and telemetry are not yet ported.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.block_pool import BlockPool, blocks_for_tokens
from repro_torch.runtime.engine import DecodeState, Engine, greedy


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


def _paged_block_bytes(cache) -> int:
    """Per-physical-block bytes of a paged model cache (0 otherwise)."""
    if not isinstance(cache, dict):
        return 0
    from repro_torch.models.transformer import paged_block_bytes
    return paged_block_bytes(cache)


def _check_capacity(requests: List[Request], max_len: Optional[int],
                    pool: Optional[BlockPool] = None,
                    ring_tokens: Optional[int] = None) -> None:
    """Reject requests whose decode would write past a ``max_len``-slot
    cache (the final token is emitted without a write, so the last write
    lands at position len(prompt) + quota - 2): such writes would be
    dropped and silently truncate the attended context. With a paged
    ``pool`` a request whose worst case (ring-clamped by ``ring_tokens``)
    exceeds the pool or the lane's table width could never be admitted, so
    it raises too."""
    if max_len is None and pool is None:
        return
    for r in requests:
        if r.max_new_tokens <= 0:
            continue
        need = len(r.prompt) + r.max_new_tokens - 1
        if max_len is not None and need > max_len:
            raise ValueError(
                f"request {r.rid}: prompt ({len(r.prompt)}) + "
                f"max_new_tokens ({r.max_new_tokens}) needs {need} cache "
                f"slots but the cache holds max_len={max_len}; later KV "
                "writes would be silently dropped")
        if pool is not None:
            if ring_tokens is not None:
                need = min(need, ring_tokens)
            nb = blocks_for_tokens(need, pool.block_size)
            lane_cap = pool.max_blocks_per_lane * pool.block_size
            if nb > pool.num_blocks or need > lane_cap:
                raise ValueError(
                    f"request {r.rid}: prompt ({len(r.prompt)}) + "
                    f"max_new_tokens ({r.max_new_tokens}) needs {nb} cache "
                    f"blocks but the pool holds num_blocks="
                    f"{pool.num_blocks} (lane capacity {lane_cap} cells); "
                    "later KV writes would be silently dropped")


def _require_nonempty_prompt(r: Request) -> None:
    if len(r.prompt) == 0:
        raise ValueError(f"request {r.rid}: empty prompt (an all-dead "
                         f"lane has no last-token logits to decode from)")


def _pack_prompts(group: List[Request], T: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts to length T. Returns (tokens (B,T), positions (B,T))
    with real positions 0..len-1 and the -1 dead-cell sentinel on pads."""
    toks = np.zeros((len(group), T), np.int32)
    posm = np.full((len(group), T), -1, np.int32)
    for i, r in enumerate(group):
        n = len(r.prompt)
        _require_nonempty_prompt(r)
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

    def track_pool(self, pool: BlockPool, live_tokens: int,
                   block_bytes: int) -> None:
        """Paged serving: peak allocated bytes, and the pool gauges sampled
        at the first peak of blocks in use."""
        s = self.stats
        s.cache_bytes = max(s.cache_bytes, pool.blocks_in_use * block_bytes)
        if pool.blocks_in_use > s.blocks_in_use:
            s.blocks_in_use = pool.blocks_in_use
            s.block_fragmentation = pool.fragmentation(live_tokens)

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


def serve_batch(prefill_fn: Callable, decode_fn: Callable, init_cache_fn,
                requests: List[Request], *, batch_slots: int,
                max_len: Optional[int] = None, device=None) -> ServeStats:
    """Static-batch serving (greedy).

    prefill_fn: (tokens (B,T), positions (B,T), cache) -> (logits, cache)
    decode_fn:  (tokens (B,1), pos (B,1), cache) -> (logits, cache)
    ``device``: where tokens and positions are placed (None: the GPU).
    """
    device = resolve_device(device)
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
        cur = greedy(logits)
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
            cur = greedy(logits)
            pos = pos + 1
    return book.finalize(t_start)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported")


class Scheduler:
    """Slot-scheduled continuous batching over ``batch_slots`` decode lanes.

    Admission is FIFO and greedy: before every decode step all free lanes
    are (re)filled from the queue. Without chunking one slot-insert prefill
    call admits them (prompts left-padded to the longest queued prompt, the
    other lanes all -1, so they pass through untouched). With ``prefill_chunk``
    an admitted lane is PREFILLING from offset 0: every loop iteration runs
    one chunk step that appends up to ``prefill_chunk`` prompt tokens to
    every prefilling lane, then one decode step for the decodable lanes; a
    lane becomes decodable after its last chunk, whose final-position
    logits give its first token.

    **Paged mode** (``block_pool``): admission reserves the request's worst
    case and maps the blocks of its prompt (only of its first chunk when
    chunking); a request whose reservation does not fit waits at the head
    of the queue. Growth maps the block each coming write lands in,
    retirement frees the lane's blocks; the table is uploaded into
    ``cache["block_table"]`` whenever the pool changed it. ``ring_tokens``
    (all-window models) caps reservations at the ring.

    Step contracts as in :class:`~repro_torch.runtime.engine.Engine`.
    """

    def __init__(self, admit_fn: Callable, decode_fn: Callable,
                 init_cache_fn: Callable, *, batch_slots: int,
                 max_len: Optional[int] = None,
                 block_pool: Optional[BlockPool] = None,
                 chunk_fn: Optional[Callable] = None,
                 prefill_chunk: Optional[int] = None,
                 ring_tokens: Optional[int] = None, radix_cache=None,
                 write_caps=None, copy_block_fn=None,
                 over_commit: bool = False, swap_out_fn=None,
                 swap_in_fn=None, decode_ratio: int = 1, telemetry=None,
                 device=None):
        for what, given in (("prefix sharing (radix_cache, write_caps)",
                             radix_cache or write_caps),
                            ("copy-on-write (copy_block_fn)", copy_block_fn),
                            ("over-commit with preemption", over_commit),
                            ("block swap (swap_out_fn / swap_in_fn)",
                             swap_out_fn or swap_in_fn),
                            ("decode_ratio > 1", decode_ratio > 1),
                            ("serving telemetry", telemetry)):
            if given:
                _not_ported(what)
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if block_pool is not None and block_pool.batch_slots != batch_slots:
            raise ValueError(
                f"block_pool is sized for {block_pool.batch_slots} lanes, "
                f"scheduler has batch_slots={batch_slots}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if chunk_fn is None:
                raise ValueError("prefill_chunk requires a chunk_fn "
                                 "(runtime.steps.make_chunk_prefill_step)")
        if ring_tokens is not None and block_pool is None:
            raise ValueError("ring_tokens only applies to paged serving "
                             "(block_pool)")
        self.batch_slots = batch_slots
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        self.pool = block_pool
        self._ring_tokens = ring_tokens
        self._ring_blocks = (None if ring_tokens is None else
                             blocks_for_tokens(ring_tokens,
                                               block_pool.block_size))
        self._block_bytes = 0
        # per-lane PREFILLING state: next prompt offset, or None
        self._pref: List[Optional[int]] = [None] * batch_slots
        self.engine = Engine(admit_fn, decode_fn, init_cache_fn,
                             batch_slots=batch_slots, chunk_fn=chunk_fn,
                             device=device)

    def run(self, requests: List[Request]) -> ServeStats:
        _check_capacity(requests, self.max_len, self.pool, self._ring_tokens)
        stats = ServeStats()
        book = _Book(stats, self.batch_slots)
        t_start = time.perf_counter()
        queue: collections.deque = collections.deque()
        for r in requests:
            if r.max_new_tokens <= 0:
                r.done = True                # never occupies a lane
            else:
                book.enqueue(r)
                queue.append(r)
        pad = max((len(r.prompt) for r in queue), default=1)
        B = self.batch_slots
        lanes: List[Optional[Request]] = [None] * B
        self._pref = [None] * B
        state = self.engine.init_state()
        if self.pool is not None:
            self.pool.reset()
            self._block_bytes = _paged_block_bytes(state.cache)
            self._sync_table(state.cache)
        self._track(state.cache, lanes, state, book)

        while queue or any(r is not None for r in lanes):
            before = book.step
            free = [i for i in range(B) if lanes[i] is None]
            if free and queue and self._head_fits(queue[0]):
                if self.prefill_chunk is None:
                    state = self._admit(free, queue, pad, lanes, state, book)
                    continue    # immediate retirees may have freed lanes
                self._admit_chunked(free, queue, lanes, book)
            if any(off is not None for off in self._pref):
                state = self._chunk(lanes, state, book)
            if any(lanes[i] is not None and self._pref[i] is None
                   for i in range(B)):
                state = self._decode(lanes, state, book)
            elif book.step == before and not any(r is not None
                                                 for r in lanes):
                raise RuntimeError(
                    "scheduler deadlock: no queued request fits an empty "
                    f"pool (queue head rid {queue[0].rid})")
        return book.finalize(t_start)

    # -- paged-pool plumbing (no-ops in dense mode) -------------------------

    def _need_blocks(self, r: Request) -> int:
        """Worst-case block count of ``r``, ring-clamped."""
        need = len(r.prompt) + r.max_new_tokens - 1
        if self._ring_tokens is not None:
            need = min(need, self._ring_tokens)
        return blocks_for_tokens(need, self.pool.block_size)

    def _head_fits(self, r: Request) -> bool:
        """Backpressure: the queue head's reservation must fit, or the
        whole admission waits (later requests do not overtake it)."""
        return self.pool is None or self.pool.can_reserve(
            self._need_blocks(r))

    def _reserve(self, lane: int, r: Request) -> bool:
        """Reserve the worst case and map the prompt's blocks (only the
        first chunk's when chunking)."""
        if self.pool is None:
            return True
        first = len(r.prompt) if self.prefill_chunk is None \
            else min(len(r.prompt), self.prefill_chunk)
        n_alloc = blocks_for_tokens(first, self.pool.block_size)
        if self._ring_blocks is not None:
            n_alloc = min(n_alloc, self._ring_blocks)
        return self.pool.reserve_and_alloc(lane, n_alloc,
                                           self._need_blocks(r))

    def _grow(self, lane: int, last_pos: int) -> None:
        """Map the block that position ``last_pos``'s write lands in."""
        n_total = last_pos // self.pool.block_size + 1
        if self._ring_blocks is not None:
            n_total = min(n_total, self._ring_blocks)
        self.pool.grow(lane, n_total)

    def _release(self, lane: int) -> None:
        if self.pool is not None:
            self.pool.free_lane(lane)

    def _sync_table(self, cache) -> None:
        """Upload the block table only when the pool changed it."""
        if self.pool is not None and self.pool.dirty \
                and isinstance(cache, dict):
            cache["block_table"] = torch.as_tensor(
                self.pool.table, device=self.engine.device)
            self.pool.dirty = False

    def _track(self, cache, lanes, state: DecodeState, book: _Book) -> None:
        if self.pool is None:
            book.track_cache(cache)
            return
        # prefilling lanes carry pos -1 but hold their written chunks
        live = sum(int(state.pos[i, 0]) for i, r in enumerate(lanes)
                   if r is not None and state.pos[i, 0] > 0)
        live += sum(off for off in self._pref if off)
        book.track_pool(self.pool, live, self._block_bytes)

    def _retire_done(self, lanes, slots, pos) -> None:
        """Retire the decodable lanes among ``slots`` that met their quota
        (after the gauges were sampled, so the peak includes them)."""
        for i in slots:
            if lanes[i] is not None and self._pref[i] is None \
                    and lanes[i].done:
                lanes[i] = None
                pos[i, 0] = -1
                self._release(i)

    # -----------------------------------------------------------------------

    def _admit(self, free, queue, pad, lanes, state: DecodeState,
               book: _Book) -> DecodeState:
        B = self.batch_slots
        group, slots = [], []
        for i in free:
            if not queue:
                break
            if not self._reserve(i, queue[0]):
                break           # head-of-line backpressure: keep FIFO order
            group.append(queue.popleft())
            slots.append(i)
        toks = np.zeros((B, pad), np.int32)
        posm = np.full((B, pad), -1, np.int32)
        g_toks, g_posm = _pack_prompts(group, pad)
        admit_mask = np.zeros((B,), bool)
        for j, i in enumerate(slots):
            toks[i], posm[i] = g_toks[j], g_posm[j]
            admit_mask[i] = True
            lanes[i] = group[j]
            book.admit(group[j])
        self._sync_table(state.cache)
        first, cache = self.engine.admit(toks, posm, admit_mask, state.cache)
        book.stats.prefill_calls += 1
        book.step += 1
        tokens, pos = state.tokens.copy(), state.pos.copy()
        for i in slots:
            tokens[i, 0] = first[i, 0]
            pos[i, 0] = len(lanes[i].prompt)
            book.emit(lanes[i], tokens[i, 0])
        self._track(cache, lanes, DecodeState(tokens, pos, cache), book)
        self._retire_done(lanes, slots, pos)
        return DecodeState(tokens, pos, cache)

    def _admit_chunked(self, free, queue, lanes, book: _Book) -> None:
        """Chunked admission is bookkeeping only: each admitted lane is
        PREFILLING at offset 0; the model work happens in _chunk."""
        for i in free:
            if not queue:
                break
            _require_nonempty_prompt(queue[0])
            if not self._reserve(i, queue[0]):
                break           # head-of-line backpressure: keep FIFO order
            lanes[i] = queue.popleft()
            self._pref[i] = 0
            book.admit(lanes[i])

    def _chunk(self, lanes, state: DecodeState, book: _Book) -> DecodeState:
        """One chunk step: append up to ``prefill_chunk`` prompt tokens to
        every prefilling lane (left-padded into the fixed width; lanes on
        their first chunk are reset by the step). Lanes that finish their
        prompt emit their first token and become decodable."""
        C, B = self.prefill_chunk, self.batch_slots
        prefilling = [i for i in range(B) if self._pref[i] is not None]
        toks = np.zeros((B, C), np.int32)
        posm = np.full((B, C), -1, np.int32)
        reset = np.zeros((B,), bool)
        ends = {}
        for i in prefilling:
            off, prompt = self._pref[i], lanes[i].prompt
            c = min(C, len(prompt) - off)
            if self.pool is not None:
                self._grow(i, off + c - 1)
            toks[i, C - c:] = prompt[off:off + c]
            posm[i, C - c:] = np.arange(off, off + c, dtype=np.int32)
            reset[i] = off == 0
            ends[i] = off + c
        self._sync_table(state.cache)
        last, cache = self.engine.chunk(toks, posm, reset, state.cache)
        book.stats.prefill_calls += 1
        book.stats.chunk_steps += 1
        book.step += 1
        tokens, pos = state.tokens.copy(), state.pos.copy()
        for i in prefilling:
            r = lanes[i]
            if ends[i] < len(r.prompt):
                self._pref[i] = ends[i]     # more chunks to go
                continue
            self._pref[i] = None            # last chunk: lane is decodable
            tokens[i, 0] = last[i, 0]
            pos[i, 0] = len(r.prompt)
            book.emit(r, tokens[i, 0])
        self._track(cache, lanes, DecodeState(tokens, pos, cache), book)
        self._retire_done(lanes, prefilling, pos)
        return DecodeState(tokens, pos, cache)

    def _decode(self, lanes, state: DecodeState, book: _Book) -> DecodeState:
        active = [i for i, r in enumerate(lanes)
                  if r is not None and self._pref[i] is None]
        if self.pool is not None:
            for i in active:
                self._grow(i, int(state.pos[i, 0]))
            self._sync_table(state.cache)
        nxt, cache = self.engine.generate(state)
        book.count_decode(len(active))
        book.step += 1
        tokens, pos = state.tokens.copy(), state.pos.copy()
        for i in active:
            tokens[i, 0] = nxt[i, 0]
            pos[i, 0] += 1
            book.emit(lanes[i], tokens[i, 0])
        self._track(cache, lanes, DecodeState(tokens, pos, cache), book)
        self._retire_done(lanes, active, pos)
        return DecodeState(tokens, pos, cache)


def serve_continuous(admit_fn: Callable, decode_fn: Callable, init_cache_fn,
                     requests: List[Request], *, batch_slots: int,
                     **kw) -> ServeStats:
    """Continuous-batching counterpart of :func:`serve_batch` (keywords as
    in :class:`Scheduler`)."""
    return Scheduler(admit_fn, decode_fn, init_cache_fn,
                     batch_slots=batch_slots, **kw).run(requests)


def serve(prefill_step: Callable, decode_step: Callable, init_cache_fn,
          params, requests: List[Request], *, scheduler: str = "static",
          batch_slots: int, max_len: Optional[int] = None,
          admit_step: Optional[Callable] = None,
          chunk_step: Optional[Callable] = None,
          block_pool: Optional[BlockPool] = None,
          prefill_chunk: Optional[int] = None,
          ring_tokens: Optional[int] = None, device=None) -> ServeStats:
    """Bind ``params`` into the step functions (``runtime.steps``
    signatures, params first) and serve with the chosen scheduler:

      prefill_step(params, tokens, cache, positions) — static
      admit_step(params, tokens, positions, admit_mask, cache) — continuous
      chunk_step(params, tokens, positions, reset_mask, cache) — chunked
      decode_step(params, tokens, pos, cache)

    The step a scheduler does not use may be None. ``block_pool``,
    ``prefill_chunk`` and ``ring_tokens`` are continuous only; the static
    scheduler serves paged caches through a fully mapped identity table. ``device``: where host inputs go (None: the GPU)."""
    if scheduler == "continuous":
        return serve_continuous(
            lambda t, pm, m, c: admit_step(params, t, pm, m, c),
            lambda t, p, c: decode_step(params, t, p, c),
            init_cache_fn, requests, batch_slots=batch_slots,
            max_len=max_len, block_pool=block_pool,
            chunk_fn=(None if chunk_step is None else
                      lambda t, pm, m, c: chunk_step(params, t, pm, m, c)),
            prefill_chunk=prefill_chunk, ring_tokens=ring_tokens,
            device=device)
    if scheduler != "static":
        raise ValueError(f"unknown scheduler {scheduler!r}")
    for what, given in (("block_pool", block_pool),
                        ("prefill_chunk", prefill_chunk)):
        if given is not None:
            raise ValueError(f"{what} is a continuous-scheduler feature")
    return serve_batch(lambda t, pm, c: prefill_step(params, t, c, pm),
                       lambda t, p, c: decode_step(params, t, p, c),
                       init_cache_fn, requests, batch_slots=batch_slots,
                       max_len=max_len, device=device)
