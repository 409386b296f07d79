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
  decode step (``decode_ratio`` decode steps per chunk step once lanes are
  decodable). With a ``block_pool`` the cache is paged: admission
  reserves the worst case and maps the first blocks, growth follows the
  writes, retirement frees the lane's blocks. With a ``radix_cache``
  (prefix sharing) admission maps the longest cached block-aligned prompt
  prefix read-only and prefills only the novel suffix; a write that would
  land in a shared block copies it first (copy-on-write). With
  ``over_commit`` admission claims only what the first chunk needs, the
  queue goes by priority tier, and a pool that runs dry preempts a lane:
  its blocks go to host memory and come back on resume (swap mode), or
  are freed and recomputed through the chunk step (drop mode).

Each lane decodes at its own next position, so a request gets the same
greedy tokens whatever it is packed with, and whether or not it was
preempted. With a ``telemetry`` handle (``runtime.telemetry``) the
Scheduler records lifecycle events and phase times, gauge snapshots and,
through armed steps, quant-health site vectors; without one its loop
touches no tracer, timer or metrics object.
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
from repro_torch.runtime.radix_cache import RadixCache
from repro_torch.runtime.telemetry import ServeTelemetry


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
        self.prompt_tokens = 0      # admitted prompt tokens (hit-rate base)
        self._enq_step: Dict[int, int] = {}  # rid -> last (re)enqueue step

    def enqueue(self, r: Request) -> None:
        self.stats.request_latency[r.rid] = RequestLatency(
            enqueue_step=self.step)
        self.priority[r.rid] = r.priority
        self._enq_step[r.rid] = self.step

    def requeue(self, r: Request) -> None:
        """A preempted request queues again: its new wait counts toward
        queue_wait_steps, while enqueue_step keeps its first arrival
        (first-token latency is measured from there)."""
        self._enq_step[r.rid] = self.step

    def admit(self, r: Request) -> None:
        lat = self.stats.request_latency[r.rid]
        wait = self.step - self._enq_step[r.rid]
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
        s.shared_blocks = max(s.shared_blocks, pool.shared_blocks)

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
        s.prefix_hit_rate = (s.prefix_hit_tokens / self.prompt_tokens
                             if self.prompt_tokens else 0.0)
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

@dataclasses.dataclass
class _Swapped:
    """Swap-mode preemption residue: the lane's blocks wait in host memory
    until resume writes them into new blocks; nothing is recomputed."""
    payload: Any                # host payload of Engine.swap_out
    n_blocks: int               # live blocks at preemption
    prompt: np.ndarray          # the lane's working prompt at preemption
    pref_off: Optional[int]     # PREFILLING offset, or None if decodable
    token: int                  # pending decode token (decodable lanes)
    pos: int                    # its write position (decodable lanes)


@dataclasses.dataclass
class _Dropped:
    """Drop-mode preemption residue: the blocks were freed (the fully
    written ones donated to the radix cache when there is one); resume
    prefills prompt + emitted tokens through the chunk step again, which
    gives the same greedy continuation."""
    written: int                # cache positions held at preemption


@dataclasses.dataclass(eq=False)      # identity compare: queue.remove(entry)
class _QEntry:
    """Admission-queue entry. ``seq`` is the arrival number, the FIFO key
    within a priority tier, kept across preemptions."""
    req: Request
    seq: int
    resume: Optional[Any] = None    # _Swapped | _Dropped | None (fresh)


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
    logits give its first token. ``decode_ratio=N`` runs N decode steps per
    chunk step once lanes are decodable (1: the 1:1 interleave).

    **Paged mode** (``block_pool``): admission reserves the request's worst
    case and maps the blocks of its prompt (only of its first chunk when
    chunking); a request whose reservation does not fit waits at the head
    of the queue. Growth maps the block each coming write lands in,
    retirement frees the lane's blocks; the table is uploaded into
    ``cache["block_table"]`` only when the pool changed it. ``ring_tokens``
    (all-window models) caps reservations at the ring.

    **Prefix sharing** (``radix_cache``; needs paged mode and a
    ``chunk_fn``): admission matches the prompt against the
    :class:`~repro_torch.runtime.radix_cache.RadixCache`, maps the longest
    block-aligned cached prefix read-only into the lane's table
    (``BlockPool.map_shared``) and prefills only the novel suffix through
    the append-mode chunk step: the lane starts PREFILLING at that offset,
    so the step does not reset it and the shared blocks stay as they are.
    Every admission then goes through the chunk step (its width is the
    prompt pad when ``prefill_chunk`` is unset). Reservations count the
    novel blocks only, plus one copy-on-write allowance per shared block
    when the request can wrap a ring layer. Retirement donates the lane's
    full prompt blocks to the tree, unless the lane wrapped a ring layer
    (its prompt cells then hold generation data). ``write_caps``
    (``models.transformer.attn_write_caps``) lists the token capacities at
    which the attention layers wrap their paged writes; ``copy_block_fn``
    (``models.transformer.cache_copy_block``) copies a shared block the
    lane is about to write into its private replacement.

    **Over-commit and preemption** (``over_commit``; needs paged mode and a
    ``chunk_fn``): admission reserves nothing beyond the matched prefix and
    the first chunk's blocks, growth extends the reservation on demand
    (``BlockPool.try_grow``). The queue is tried in ``(-priority, arrival)``
    order, so a request that does not fit no longer blocks the ones behind
    it. When the pool runs dry a victim lane (lowest tier, then youngest;
    admission only ever preempts a strictly lower tier) is preempted: with
    ``swap_out_fn`` / ``swap_in_fn`` (``runtime.steps.make_swap_steps``)
    its blocks go to host memory and come back bit for bit on resume;
    otherwise they are freed (the fully written ones donated to the radix
    cache) and resume prefills prompt + emitted tokens again through the
    chunk step. Either way the request emits the same greedy tokens.

    **Telemetry** (``telemetry``, a
    :class:`~repro_torch.runtime.telemetry.ServeTelemetry`): its tracer
    records the lifecycle events and times the admit, chunk, decode and
    swap phases; its metrics logger takes a gauge snapshot every N steps;
    its quant-health collector folds the site vectors of steps built with
    ``quant_telemetry=True`` (through the engine) and, at the end of a run,
    the KV cache's scales. Greedy tokens are the same with it or without.

    **Under a mesh** (``dist``, one rank of a tensor-parallel job): every
    rank runs this loop on the same requests over its slices of the
    params and caches. The pool, the radix tree, the victims and the
    decode:chunk pacing are host state that reads nothing but the greedy
    tokens, which are whole on every rank, so every rank takes the same
    decisions; block ids are global, and copy-on-write and swaps move the
    rank's share of each block. The engine folds the armed steps' site
    vectors over the ranks, and the KV scales are gathered whole at the
    end.

    Step contracts as in :class:`~repro_torch.runtime.engine.Engine`.
    """

    def __init__(self, admit_fn: Callable, decode_fn: Callable,
                 init_cache_fn: Callable, *, batch_slots: int,
                 max_len: Optional[int] = None,
                 block_pool: Optional[BlockPool] = None,
                 chunk_fn: Optional[Callable] = None,
                 prefill_chunk: Optional[int] = None,
                 ring_tokens: Optional[int] = None,
                 radix_cache: Optional[RadixCache] = None,
                 write_caps: Optional[List[int]] = None,
                 copy_block_fn: Optional[Callable] = None,
                 over_commit: bool = False,
                 swap_out_fn: Optional[Callable] = None,
                 swap_in_fn: Optional[Callable] = None,
                 decode_ratio: int = 1,
                 telemetry: Optional[ServeTelemetry] = None, device=None,
                 dist=None):
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
        if (write_caps is not None or ring_tokens is not None) \
                and block_pool is None:
            raise ValueError("write_caps / ring_tokens only apply to "
                             "paged serving (block_pool)")
        if radix_cache is not None:
            if block_pool is None:
                raise ValueError("radix_cache requires a block_pool "
                                 "(prefix sharing is a paged feature)")
            if chunk_fn is None:
                raise ValueError(
                    "radix_cache requires a chunk_fn: prefix-hit lanes "
                    "prefill their novel suffix through the append-mode "
                    "chunk path (the monolithic admit step would reset "
                    "the shared blocks)")
            if radix_cache.block_size != block_pool.block_size:
                raise ValueError(
                    f"radix_cache block_size {radix_cache.block_size} != "
                    f"pool block_size {block_pool.block_size}")
            block_pool.attach_cache(radix_cache)
        if over_commit:
            if block_pool is None:
                raise ValueError("over_commit requires a block_pool "
                                 "(preemption is a paged feature)")
            if chunk_fn is None:
                raise ValueError(
                    "over_commit requires a chunk_fn: optimistic admission "
                    "maps only the first chunk's blocks and drop-mode "
                    "resume re-prefills through the chunk path")
        if (swap_out_fn is None) != (swap_in_fn is None):
            raise ValueError("swap_out_fn and swap_in_fn come as a pair")
        if swap_out_fn is not None and not over_commit:
            raise ValueError("swap functions only apply to over_commit "
                             "preemption")
        if decode_ratio < 1:
            raise ValueError(f"decode_ratio must be >= 1, got {decode_ratio}")
        if decode_ratio > 1 and chunk_fn is None:
            raise ValueError("decode_ratio > 1 requires a chunk_fn (it "
                             "paces decode steps against chunk steps)")
        self._write_caps = self._min_cap = None
        if block_pool is not None:
            lane_cap = block_pool.max_blocks_per_lane * block_pool.block_size
            caps = sorted(set(write_caps)) if write_caps else [lane_cap]
            if caps[0] < 1 or caps[-1] > lane_cap:
                raise ValueError(f"write_caps {caps} outside the lane "
                                 f"capacity 1..{lane_cap}")
            self._write_caps, self._min_cap = caps, caps[0]
            if radix_cache is not None and copy_block_fn is None \
                    and caps[0] < lane_cap:
                raise ValueError(
                    "prefix sharing with a sliding-window layer (write cap "
                    f"{caps[0]} < lane capacity {lane_cap}) requires a "
                    "copy_block_fn for copy-on-write")
        self.batch_slots = batch_slots
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        self.pool = block_pool
        self.radix = radix_cache
        self.over_commit = over_commit
        self.swap = swap_out_fn is not None
        self.decode_ratio = decode_ratio
        self._ring_tokens = ring_tokens
        self._ring_blocks = (None if ring_tokens is None else
                             blocks_for_tokens(ring_tokens,
                                               block_pool.block_size))
        self._block_bytes = 0
        # per-lane PREFILLING state: next prompt offset, or None
        self._pref: List[Optional[int]] = [None] * batch_slots
        # per-lane tokens mapped from the radix cache (counted once in
        # _track, however many lanes map them)
        self._shared_tok: List[int] = [0] * batch_slots
        # the chunk step's width: prefill_chunk, or the prompt pad when the
        # radix cache or over-commit routes unchunked admissions through it
        # (set in run)
        self._chunk_width: Optional[int] = prefill_chunk
        # per lane: the WORKING prompt _chunk and _decode read (the prompt,
        # or prompt + emitted tokens for a drop-resumed lane), its queue
        # entry (carries the resume residue) and an admission age stamp
        # (youngest-first victims)
        self._lane_prompt: List[Optional[np.ndarray]] = [None] * batch_slots
        self._lane_entry: List[Optional[_QEntry]] = [None] * batch_slots
        self._lane_age: List[int] = [0] * batch_slots
        self._age = 0
        self._queue: collections.deque = collections.deque()
        # decode:chunk pacing credit: one less per decode step, back to
        # decode_ratio after each chunk step; a chunk step runs only when
        # it is spent (or nothing is decodable)
        self._decode_credit = 0
        # observability: None turns it all off, and the loop then touches
        # no tracer, timer or metrics object
        self.tel = telemetry
        self._tracer = telemetry.tracer if telemetry is not None else None
        self._book: Optional[_Book] = None
        self.engine = Engine(admit_fn, decode_fn, init_cache_fn,
                             batch_slots=batch_slots, chunk_fn=chunk_fn,
                             copy_block_fn=copy_block_fn,
                             swap_out_fn=swap_out_fn, swap_in_fn=swap_in_fn,
                             telemetry_sink=(
                                 telemetry.quant.update
                                 if telemetry is not None
                                 and telemetry.quant is not None else None),
                             device=device, dist=dist)

    def run(self, requests: List[Request]) -> ServeStats:
        _check_capacity(requests, self.max_len, self.pool, self._ring_tokens)
        stats = ServeStats()
        book = self._book = _Book(stats, self.batch_slots)
        if self.pool is not None and self._tracer is not None:
            self.pool.on_evict = lambda blocks: self._ev(
                "radix_evict", blocks=len(blocks))
        t_start = time.perf_counter()
        queue = self._queue = collections.deque()
        for seq, r in enumerate(requests):
            if r.max_new_tokens <= 0:
                r.done = True                # never occupies a lane
            else:
                book.enqueue(r)
                queue.append(_QEntry(r, seq))
                self._ev("enqueue", rid=r.rid, prompt_len=len(r.prompt),
                         max_new=r.max_new_tokens)
        pad = max((len(e.req.prompt) for e in queue), default=1)
        self._chunk_width = self.prefill_chunk or pad
        B = self.batch_slots
        lanes: List[Optional[Request]] = [None] * B
        self._pref = [None] * B
        self._shared_tok = [0] * B
        self._lane_prompt = [None] * B
        self._lane_entry = [None] * B
        self._lane_age = [0] * B
        self._age = 0
        self._decode_credit = 0
        state = self.engine.init_state()
        if self.pool is not None:
            self.pool.reset()
            self._block_bytes = _paged_block_bytes(state.cache)
            self._sync_table(state.cache)
        self._track(state.cache, lanes, state, book)

        while queue or any(r is not None for r in lanes):
            # a preemption frees blocks without a model call: it counts as
            # progress for the deadlock guard
            before = (book.step, stats.preemptions)
            free = [i for i in range(B) if lanes[i] is None]
            if queue and self.over_commit:
                state = self._admit_over_commit(lanes, state, book)
            elif free and queue and self._head_fits(queue[0].req):
                if self.prefill_chunk is None and self.radix is None:
                    state = self._admit(free, queue, pad, lanes, state, book)
                    continue    # immediate retirees may have freed lanes
                self._admit_chunked(free, queue, lanes, book)
            prefilling = any(off is not None for off in self._pref)
            has_decodable = any(lanes[i] is not None and self._pref[i] is None
                                for i in range(B))
            if prefilling and (self._decode_credit <= 0 or not has_decodable):
                state = self._chunk(lanes, state, book)
                self._decode_credit = self.decode_ratio
            if any(lanes[i] is not None and self._pref[i] is None
                   for i in range(B)):
                state = self._decode(lanes, state, book)
                self._decode_credit -= 1
            elif (book.step, stats.preemptions) == before \
                    and not any(r is not None for r in lanes):
                # no model call, no preemption and no resident lane while
                # requests queue: nothing can ever progress (the capacity
                # check guarantees an empty pool fits any one request, so
                # the pool broke that contract)
                raise RuntimeError(
                    "scheduler deadlock: no queued request fits an empty "
                    f"pool (queue head rid {queue[0].req.rid})")
            self._snapshot(queue, lanes, book)
        if self.tel is not None and self.tel.quant is not None:
            self.tel.quant.update_kv_scales(state.cache, self.engine.dist)
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
        if self.pool is None:
            return True
        if self.radix is not None:
            blocks, _, _, _, n_reserve, total = self._plan_prefix(r)
            if blocks:
                return self.pool.can_map_shared(blocks, n_reserve, total)
            return self.pool.can_reserve(n_reserve)
        return self.pool.can_reserve(self._need_blocks(r))

    def _first_cols(self, k: int, P: int) -> int:
        """Table columns the first chunk of a P-token prompt fills after
        ``k`` matched blocks, ring-clamped."""
        bs = self.pool.block_size
        cols = blocks_for_tokens(k * bs + min(self._chunk_width, P - k * bs),
                                 bs)
        return cols if self._ring_blocks is None else min(cols,
                                                          self._ring_blocks)

    def _plan_prefix(self, r: Request):
        """Radix admission plan: match the prompt, then size the lane.
        Returns (shared blocks, raw hit tokens, aligned hit tokens,
        n_alloc, n_reserve, n_cols). ``n_reserve`` counts the novel blocks
        (suffix and decode growth, ring-clamped) plus one copy-on-write
        allowance per shared block when the request's last write reaches
        the smallest write cap. The match is capped at (P - 1) // bs blocks
        so the novel suffix keeps at least one token (its final-position
        logits emit the first token)."""
        P = len(r.prompt)
        bs = self.pool.block_size
        blocks, raw = self.radix.match(r.prompt, max_blocks=(P - 1) // bs)
        k = len(blocks)
        total = self._need_blocks(r)        # ring-clamped table columns
        wraps = P + r.max_new_tokens - 2 >= self._min_cap
        n_alloc = max(self._first_cols(k, P) - k, 0)
        n_reserve = (total - k) + (k if wraps else 0)
        return blocks, raw, k * bs, n_alloc, n_reserve, total

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

    def _reserve_prefix(self, lane: int, r: Request,
                        book: _Book) -> Optional[int]:
        """Radix admission: map the matched prefix read-only plus the first
        chunk's novel blocks, reserving novel growth only. Returns the
        prompt offset the lane starts prefilling at (0 on a miss), or None
        when the plan does not fit (backpressure)."""
        blocks, raw, k_tok, n_alloc, n_reserve, total = self._plan_prefix(r)
        if blocks:
            ok = self.pool.map_shared(lane, blocks, n_alloc, n_reserve,
                                      n_cols=total)
        else:
            ok = self.pool.reserve_and_alloc(lane, n_alloc, n_reserve)
        if not ok:
            return None
        self._shared_tok[lane] = k_tok
        book.stats.prefix_hit_tokens += raw
        book.stats.prefill_tokens_saved += k_tok
        return k_tok

    def _grow(self, lane: int, last_pos: int, lanes, state: DecodeState,
              book: _Book) -> None:
        """Map the block that position ``last_pos``'s write lands in: from
        the reservation, or under over-commit on demand, preempting lanes
        until the pool can supply it (the lane itself last: then
        ``lanes[lane]`` is None and the caller skips it)."""
        n_total = last_pos // self.pool.block_size + 1
        if self._ring_blocks is not None:
            n_total = min(n_total, self._ring_blocks)
        n_before = (self.pool.lane_mapped(lane)
                    if self._tracer is not None else 0)
        if not self.over_commit:
            self.pool.grow(lane, n_total)
        else:
            while not self.pool.try_grow(lane, n_total):
                # the demander is always a candidate, so there is a victim
                victim = self._pick_victim(lanes)
                self._preempt(victim, lanes, state, book)
                if victim == lane:
                    break
        if self._tracer is not None and lanes[lane] is not None \
                and self.pool.lane_mapped(lane) > n_before:
            self._ev("block_grow", rid=lanes[lane].rid, lane=lane,
                     blocks=self.pool.lane_mapped(lane) - n_before)

    def _release(self, lane: int, r: Request) -> None:
        self._ev("retire", rid=r.rid, lane=lane, tokens=len(r.tokens_out))
        if self.pool is not None:
            if self.radix is not None:
                self._donate(lane, r)
            self.pool.free_lane(lane)
            self._shared_tok[lane] = 0
        self._lane_prompt[lane] = None
        self._lane_entry[lane] = None

    def _donate(self, lane: int, r: Request) -> None:
        """Retirement donation: insert the lane's full working-prompt
        blocks (the prompt, or prompt + the tokens emitted before a
        drop-mode preemption: what those blocks hold) into the radix tree
        instead of freeing them. Skipped when the lane ever wrapped a ring
        layer (its last write reached the smallest write cap): a wrapping
        write lands generation data in prompt cells, so those blocks no
        longer hold a clean prefix."""
        seq = self._lane_prompt[lane]
        n_full = len(seq) // self.pool.block_size
        if n_full == 0 or \
                len(r.prompt) + r.max_new_tokens - 2 >= self._min_cap:
            return
        blocks = [int(b) for b in self.pool.table[lane, :n_full]]
        for b in self.radix.insert(
                np.asarray(seq[:n_full * self.pool.block_size]), blocks):
            self.pool.set_cached(b, True)

    def _cow_barrier(self, lane: int, positions, cache, lanes,
                     state: DecodeState, book: _Book):
        """Copy-on-write before a step writes ``positions`` for ``lane``:
        for every write cap, the table column each write wraps into; a
        column that still maps a shared (or cached) block is swapped for a
        private copy first (the device copy through the engine, the table
        upload at the next sync). Under over-commit no copy-on-write
        allowance was reserved: lanes are preempted until a block is
        available (the lane itself last; the caller then finds
        ``lanes[lane]`` None and skips it)."""
        if self.pool.lane_shared(lane) == 0:
            return cache
        bs = self.pool.block_size
        cols = sorted({(p % cap) // bs
                       for p in positions for cap in self._write_caps})
        for col in cols:
            if self.over_commit and self.pool.needs_cow(lane, col):
                while self.pool.available_blocks() < 1:
                    victim = self._pick_victim(lanes)
                    self._preempt(victim, lanes, state, book)
                    if victim == lane:
                        return cache
            pair = (self.pool.cow(lane, col, extend=True)
                    if self.over_commit else self.pool.cow(lane, col))
            if pair is not None:
                cache = self.engine.copy_block(cache, *pair)
                self._ev("cow", lane=lane, src=int(pair[0]),
                         dst=int(pair[1]))
        return cache

    def _sync_table(self, cache) -> None:
        """Upload the block table only when the pool changed it: steady
        decode steps reuse the table already on the device."""
        if self.pool is not None and self.pool.dirty \
                and isinstance(cache, dict):
            cache["block_table"] = torch.as_tensor(
                self.pool.table, device=self.engine.device)
            self.pool.dirty = False

    def _track(self, cache, lanes, state: DecodeState, book: _Book) -> None:
        if self.pool is None:
            book.track_cache(cache)
            return
        # live tokens counted once: each lane its privately written tokens,
        # every cached block's cells once however many lanes map it;
        # prefilling lanes carry pos -1 but hold their written chunks
        live = sum(int(state.pos[i, 0]) - self._shared_tok[i]
                   for i, r in enumerate(lanes)
                   if r is not None and state.pos[i, 0] > 0)
        live += sum(off - self._shared_tok[i]
                    for i, off in enumerate(self._pref) if off)
        live += self.pool.blocks_cached * self.pool.block_size
        book.track_pool(self.pool, live, self._block_bytes)

    def _retire_done(self, lanes, slots, pos) -> None:
        """Retire the decodable lanes among ``slots`` that met their quota
        (after the gauges were sampled, so the peak includes them)."""
        for i in slots:
            r = lanes[i]
            if r is not None and self._pref[i] is None and r.done:
                lanes[i] = None
                pos[i, 0] = -1
                self._release(i, r)

    # -- observability hooks (no-ops without telemetry) ---------------------

    def _ev(self, name: str, rid: Optional[int] = None,
            lane: Optional[int] = None, **args) -> None:
        if self._tracer is not None:
            self._tracer.event(name, self._book.step, rid=rid, lane=lane,
                               **args)

    def _step_call(self, phase: str, op: Callable, args,
                   n_lanes: Optional[int] = None):
        """One engine op (a model call and its greedy read-back). Traced,
        it is a phase duration event in host time: the read-back waits for
        the device, so the phase covers its work too."""
        if self._tracer is None:
            return op(*args)
        with self._tracer.phase(phase, self._book.step) as ph:
            toks, cache = op(*args)
            if n_lanes is not None:
                ph.args["lanes"] = n_lanes
        return toks, cache

    def _timed(self, phase: str, thunk: Callable, **args):
        """Time a block swap as a phase duration event (host time: swap-out
        returns once its payload is in host memory, swap-in once its copies
        and scatter are queued)."""
        if self._tracer is None:
            return thunk()
        with self._tracer.phase(phase, self._book.step) as ph:
            out = thunk()
            ph.args.update(args)
        return out

    def _snapshot(self, queue, lanes, book: _Book) -> None:
        """A gauge snapshot (queue, lanes, pool), at most once per step,
        when a metrics logger is attached and due."""
        m = self.tel.metrics if self.tel is not None else None
        if m is None or not m.due(book.step):
            return
        s = book.stats
        gauges: Dict[str, Any] = {
            "queue_depth": len(queue),
            "resident_lanes": sum(r is not None for r in lanes),
            "prefilling_lanes": sum(o is not None for o in self._pref),
            "tokens_generated": s.tokens_generated,
            "decode_steps": s.decode_steps,
            "prefill_calls": s.prefill_calls,
            "preemptions": s.preemptions,
            "swapped_blocks": s.swapped_blocks,
            "prefix_hit_rate": (s.prefix_hit_tokens / book.prompt_tokens
                                if book.prompt_tokens else 0.0),
        }
        if self.pool is not None:
            gauges.update(
                blocks_in_use=self.pool.blocks_in_use,
                blocks_free=self.pool.blocks_free,
                blocks_evictable=self.pool.blocks_evictable,
                blocks_cached=self.pool.blocks_cached,
                shared_blocks=self.pool.shared_blocks,
                refcount_total=self.pool.refcount_total)
        m.emit(book.step, gauges)

    def _register_lane(self, lane: int, entry: _QEntry,
                       prompt: np.ndarray, book: _Book) -> None:
        """Admission bookkeeping of every path: the lane's working prompt,
        its queue entry, an age stamp, and the queue-wait sample."""
        self._lane_prompt[lane] = prompt
        self._lane_entry[lane] = entry
        self._age += 1
        self._lane_age[lane] = self._age
        book.admit(entry.req)

    # -----------------------------------------------------------------------

    def _admit(self, free, queue, pad, lanes, state: DecodeState,
               book: _Book) -> DecodeState:
        B = self.batch_slots
        entries, slots = [], []
        for i in free:
            if not queue:
                break
            if not self._reserve(i, queue[0].req):
                break           # head-of-line backpressure: keep FIFO order
            entries.append(queue.popleft())
            slots.append(i)
            book.prompt_tokens += len(entries[-1].req.prompt)
        group = [e.req for e in entries]
        toks = np.zeros((B, pad), np.int32)
        posm = np.full((B, pad), -1, np.int32)
        g_toks, g_posm = _pack_prompts(group, pad)
        admit_mask = np.zeros((B,), bool)
        for j, i in enumerate(slots):
            toks[i], posm[i] = g_toks[j], g_posm[j]
            admit_mask[i] = True
            lanes[i] = group[j]
            self._register_lane(i, entries[j], group[j].prompt, book)
            self._ev("admit", rid=group[j].rid, lane=i)
        self._sync_table(state.cache)
        first, cache = self._step_call(
            "admit", self.engine.admit,
            (toks, posm, admit_mask, state.cache), n_lanes=len(slots))
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
        PREFILLING at offset 0, or with a radix hit at its matched offset
        (the matched blocks already mapped read-only); the model work
        happens in _chunk."""
        for i in free:
            if not queue:
                break
            r = queue[0].req
            _require_nonempty_prompt(r)
            if self.radix is not None:
                off = self._reserve_prefix(i, r, book)
                if off is None:
                    break       # head-of-line backpressure: keep FIFO order
            else:
                if not self._reserve(i, r):
                    break       # head-of-line backpressure: keep FIFO order
                off = 0
            entry = queue.popleft()
            lanes[i] = r
            self._pref[i] = off
            self._register_lane(i, entry, r.prompt, book)
            book.prompt_tokens += len(r.prompt)
            self._ev("admit", rid=r.rid, lane=i)
            if off:
                self._ev("prefix_hit", rid=r.rid, lane=i, tokens=off)

    # -- over-commit: preemption and priority admission ---------------------

    def _pick_victim(self, lanes, *,
                     below: Optional[int] = None) -> Optional[int]:
        """The lane to preempt: lowest priority first, youngest (largest
        age stamp) within a tier. ``below`` admits only lanes of a strictly
        lower tier (admission never evicts a peer to seat an equal);
        growth passes no bound, so the demander itself is a candidate and
        a victim always exists."""
        cand = [i for i in range(self.batch_slots) if lanes[i] is not None]
        if below is not None:
            cand = [i for i in cand if lanes[i].priority < below]
        if not cand:
            return None
        return min(cand, key=lambda i: (lanes[i].priority,
                                        -self._lane_age[i]))

    def _preempt(self, lane: int, lanes, state: DecodeState,
                 book: _Book) -> None:
        """Preempt ``lane``: swap its blocks out to host memory (swap mode)
        or free them after donating the fully written ones to the radix
        cache (drop mode), then queue its request again with the resume
        residue, at its original arrival number."""
        r = lanes[lane]
        entry = self._lane_entry[lane]
        off = self._pref[lane]
        written = off if off is not None else int(state.pos[lane, 0])
        stats = book.stats
        if self.swap:
            ids = self.pool.lane_blocks(lane)
            entry.resume = _Swapped(
                payload=self._timed(
                    "swap_out", lambda: self.engine.swap_out(state.cache,
                                                             ids),
                    blocks=len(ids)),
                n_blocks=len(ids), prompt=self._lane_prompt[lane],
                pref_off=off, token=int(state.tokens[lane, 0]),
                pos=int(state.pos[lane, 0]))
            stats.swapped_blocks += len(ids)
        else:
            self._donate_written(lane, r, written)
            entry.resume = _Dropped(written=written)
        self.pool.free_lane(lane)
        self._shared_tok[lane] = 0
        self._lane_prompt[lane] = None
        self._lane_entry[lane] = None
        lanes[lane] = None
        self._pref[lane] = None
        state.pos[lane, 0] = -1        # idle: the decode step ignores it
        stats.preemptions += 1
        self._ev("preempt", rid=r.rid, lane=lane, written=written,
                 mode="swap" if self.swap else "drop")
        book.requeue(r)
        self._queue.append(entry)

    def _donate_written(self, lane: int, r: Request, written: int) -> None:
        """Drop-mode donation: the lane's blocks hold positions
        0..written-1 of prompt + emitted tokens, so its fully written
        blocks go to the radix cache and resume recomputes only the novel
        suffix. Skipped without a radix cache, and when a ring layer may
        have wrapped (the highest written position reached the smallest
        write cap)."""
        if self.radix is None:
            return
        bs = self.pool.block_size
        n_full = written // bs
        if n_full == 0 or written - 1 >= self._min_cap:
            return
        full = np.concatenate([np.asarray(r.prompt, np.int32),
                               np.asarray(r.tokens_out, np.int32)])
        blocks = [int(b) for b in self.pool.table[lane, :n_full]]
        for b in self.radix.insert(full[:n_full * bs], blocks):
            self.pool.set_cached(b, True)

    def _admit_over_commit(self, lanes, state: DecodeState,
                           book: _Book) -> DecodeState:
        """Priority-aware over-commit admission: queued entries in
        (-priority, arrival) order. An entry with no free lane may preempt
        a strictly lower-tier lane for its slot, and again while its first
        chunk does not fit the pool; an entry that still cannot be placed
        stays queued without blocking the others."""
        B = self.batch_slots
        for entry in sorted(self._queue,
                            key=lambda e: (-e.req.priority, e.seq)):
            _require_nonempty_prompt(entry.req)
            free = [i for i in range(B) if lanes[i] is None]
            if not free:
                victim = self._pick_victim(lanes, below=entry.req.priority)
                if victim is None:
                    break       # every resident lane is >= this tier: wait
                self._preempt(victim, lanes, state, book)
                free = [victim]
            lane = free[0]
            placed, state = self._try_place(lane, entry, state, book)
            while not placed:
                victim = self._pick_victim(lanes, below=entry.req.priority)
                if victim is None:
                    break
                self._preempt(victim, lanes, state, book)
                placed, state = self._try_place(lane, entry, state, book)
            if not placed:
                continue        # the pool is too full even after preemption
            self._queue.remove(entry)
            lanes[lane] = entry.req
        return state

    def _try_place(self, lane: int, entry: _QEntry, state: DecodeState,
                   book: _Book) -> Tuple[bool, DecodeState]:
        """Seat ``entry`` in the free ``lane``: swap residue allocates as
        many blocks as it held and writes the host payload back into them;
        a fresh or dropped request goes through optimistic chunked
        placement. Returns (placed, state); not placed leaves the pool as
        it was."""
        r, res, pool = entry.req, entry.resume, self.pool
        if isinstance(res, _Swapped):
            n = res.n_blocks
            if n > pool.available_blocks() \
                    or not pool.reserve_and_alloc(lane, n, n):
                return False, state
            ids = pool.lane_blocks(lane)
            cache = self._timed(
                "swap_in", lambda: self.engine.swap_in(state.cache, ids,
                                                       res.payload),
                blocks=len(ids))
            tokens, pos = state.tokens.copy(), state.pos.copy()
            self._pref[lane] = res.pref_off
            if res.pref_off is None:    # decodable: its pending token
                tokens[lane, 0] = res.token
                pos[lane, 0] = res.pos
            self._register_lane(lane, entry, res.prompt, book)
            self._shared_tok[lane] = 0  # every written-back block is private
            entry.resume = None
            self._ev("resume", rid=r.rid, lane=lane, mode="swap")
            return True, DecodeState(tokens, pos, cache)
        if isinstance(res, _Dropped):
            prompt = np.concatenate([np.asarray(r.prompt, np.int32),
                                     np.asarray(r.tokens_out, np.int32)])
        else:
            prompt = r.prompt
        off = self._place_chunked(lane, prompt, book)
        if off is None:
            return False, state
        if isinstance(res, _Dropped):
            book.stats.recomputed_tokens += max(res.written - off, 0)
            entry.resume = None
            self._ev("resume", rid=r.rid, lane=lane, mode="drop")
        else:
            self._ev("admit", rid=r.rid, lane=lane)
        if off:
            self._ev("prefix_hit", rid=r.rid, lane=lane, tokens=off)
        self._pref[lane] = off
        self._register_lane(lane, entry, prompt, book)
        book.prompt_tokens += len(prompt)
        return True, state

    def _place_chunked(self, lane: int, prompt: np.ndarray,
                       book: _Book) -> Optional[int]:
        """Optimistic admission: map the radix-matched prefix (if any) and
        only the blocks the first chunk writes, with no worst-case
        reservation (``try_grow`` extends it later). Returns the offset
        prefilling starts at, or None when the first chunk does not fit."""
        pool = self.pool
        bs = pool.block_size
        P = len(prompt)
        blocks, raw = [], 0
        if self.radix is not None:
            blocks, raw = self.radix.match(np.asarray(prompt),
                                           max_blocks=(P - 1) // bs)
        k = len(blocks)
        cols_first = self._first_cols(k, P)
        n_alloc = max(cols_first - k, 0)
        if n_alloc > pool.available_blocks():
            return None
        if blocks:
            ok = pool.map_shared(lane, blocks, n_alloc, n_alloc,
                                 n_cols=cols_first)
        else:
            ok = pool.reserve_and_alloc(lane, n_alloc, n_alloc)
        if not ok:
            return None
        self._shared_tok[lane] = k * bs
        if k:
            book.stats.prefix_hit_tokens += raw
            book.stats.prefill_tokens_saved += k * bs
        return k * bs

    # -----------------------------------------------------------------------

    def _chunk(self, lanes, state: DecodeState, book: _Book) -> DecodeState:
        """One chunk step: append up to the chunk width of working-prompt
        tokens to every prefilling lane (left-padded into the fixed width;
        lanes on their first chunk are reset by the step). Lanes that
        finish their working prompt emit their next token and become
        decodable. Copy-on-write and growth run first, for every
        prefilling lane, since under over-commit either may preempt a lane
        and so change who takes part."""
        C, B = self._chunk_width, self.batch_slots
        cache = state.cache
        if self.pool is not None:
            for i in range(B):
                if self._pref[i] is None or lanes[i] is None:
                    continue
                off = self._pref[i]
                c = min(C, len(self._lane_prompt[i]) - off)
                # copy-on-write before growth: a ring write of this chunk
                # may wrap into a shared prefix column
                if self.radix is not None:
                    cache = self._cow_barrier(i, range(off, off + c), cache,
                                              lanes, state, book)
                    if lanes[i] is None:
                        continue        # preempted by its own barrier
                self._grow(i, off + c - 1, lanes, state, book)
        prefilling = [i for i in range(B) if self._pref[i] is not None]
        if not prefilling:              # every prefilling lane was preempted
            return DecodeState(state.tokens, state.pos, cache)
        toks = np.zeros((B, C), np.int32)
        posm = np.full((B, C), -1, np.int32)
        reset = np.zeros((B,), bool)
        ends = {}
        for i in prefilling:
            off, seq = self._pref[i], self._lane_prompt[i]
            c = min(C, len(seq) - off)
            toks[i, C - c:] = seq[off:off + c]
            posm[i, C - c:] = np.arange(off, off + c, dtype=np.int32)
            reset[i] = off == 0
            ends[i] = off + c
        self._sync_table(cache)
        last, cache = self._step_call(
            "chunk", self.engine.chunk, (toks, posm, reset, cache),
            n_lanes=len(prefilling))
        book.stats.prefill_calls += 1
        book.stats.chunk_steps += 1
        book.step += 1
        tokens, pos = state.tokens.copy(), state.pos.copy()
        for i in prefilling:
            seq = self._lane_prompt[i]
            if ends[i] < len(seq):
                self._pref[i] = ends[i]     # more chunks to go
                continue
            self._pref[i] = None            # last chunk: lane is decodable
            tokens[i, 0] = last[i, 0]
            pos[i, 0] = len(seq)
            book.emit(lanes[i], tokens[i, 0])
        self._track(cache, lanes, DecodeState(tokens, pos, cache), book)
        self._retire_done(lanes, prefilling, pos)
        return DecodeState(tokens, pos, cache)

    def _decode(self, lanes, state: DecodeState, book: _Book) -> DecodeState:
        cache = state.cache
        if self.pool is not None:
            # map the block each coming write lands in; under over-commit
            # this may preempt lanes, so the active set is taken after it
            for i in range(self.batch_slots):
                if lanes[i] is None or self._pref[i] is not None:
                    continue
                p = int(state.pos[i, 0])
                if self.radix is not None:
                    # a ring write may wrap into a shared column
                    cache = self._cow_barrier(i, (p,), cache, lanes, state,
                                              book)
                    if lanes[i] is None:
                        continue        # preempted by its own barrier
                self._grow(i, p, lanes, state, book)
            self._sync_table(cache)
        active = [i for i, r in enumerate(lanes)
                  if r is not None and self._pref[i] is None]
        if not active:                  # every decodable lane was preempted
            return DecodeState(state.tokens, state.pos, cache)
        nxt, cache = self._step_call(
            "decode_batch", self.engine.generate,
            (DecodeState(state.tokens, state.pos, cache),),
            n_lanes=len(active))
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
          ring_tokens: Optional[int] = None,
          radix_cache: Optional[RadixCache] = None,
          write_caps: Optional[List[int]] = None,
          copy_block_fn: Optional[Callable] = None,
          over_commit: bool = False,
          swap_out_fn: Optional[Callable] = None,
          swap_in_fn: Optional[Callable] = None,
          decode_ratio: int = 1,
          telemetry: Optional[ServeTelemetry] = None,
          device=None, dist=None) -> ServeStats:
    """Bind ``params`` into the step functions (``runtime.steps``
    signatures, params first) and serve with the chosen scheduler:

      prefill_step(params, tokens, cache, positions) — static
      admit_step(params, tokens, positions, admit_mask, cache) — continuous
      chunk_step(params, tokens, positions, reset_mask, cache) — chunked
      decode_step(params, tokens, pos, cache)

    The step a scheduler does not use may be None. ``block_pool``,
    ``prefill_chunk``, ``ring_tokens``, prefix sharing (``radix_cache``
    with ``write_caps`` and ``copy_block_fn(cache, src, dst)``, no params),
    over-commit (``over_commit`` with ``swap_out_fn(cache, ids)`` /
    ``swap_in_fn(cache, ids, payload)`` from
    ``runtime.steps.make_swap_steps``, no params), ``decode_ratio`` and
    ``telemetry`` are continuous only; the static scheduler serves paged
    caches through a fully mapped identity table. ``device``: where host
    inputs go (None: the GPU). ``dist``: this rank of a tensor-parallel
    job, for the continuous scheduler's engine to fold the armed steps'
    site vectors and the KV scales over the ranks (the steps themselves
    carry ``dist``)."""
    if scheduler == "continuous":
        return serve_continuous(
            lambda t, pm, m, c: admit_step(params, t, pm, m, c),
            lambda t, p, c: decode_step(params, t, p, c),
            init_cache_fn, requests, batch_slots=batch_slots,
            max_len=max_len, block_pool=block_pool,
            chunk_fn=(None if chunk_step is None else
                      lambda t, pm, m, c: chunk_step(params, t, pm, m, c)),
            prefill_chunk=prefill_chunk, ring_tokens=ring_tokens,
            radix_cache=radix_cache, write_caps=write_caps,
            copy_block_fn=copy_block_fn, over_commit=over_commit,
            swap_out_fn=swap_out_fn, swap_in_fn=swap_in_fn,
            decode_ratio=decode_ratio, telemetry=telemetry, device=device,
            dist=dist)
    if scheduler != "static":
        raise ValueError(f"unknown scheduler {scheduler!r}")
    if telemetry is not None:
        raise ValueError("telemetry is a continuous-scheduler feature; "
                         "the static scheduler has no request lifecycle")
    if radix_cache is not None:
        raise ValueError("radix_cache is a continuous-scheduler feature; "
                         "prefix sharing needs the paged block pool")
    if over_commit:
        raise ValueError("over_commit is a continuous-scheduler feature; "
                         "preemption needs the paged block pool")
    if decode_ratio != 1:
        raise ValueError("decode_ratio is a continuous-scheduler feature; "
                         "static groups have no chunk/decode interleave")
    for what, given in (("block_pool", block_pool),
                        ("prefill_chunk", prefill_chunk)):
        if given is not None:
            raise ValueError(f"{what} is a continuous-scheduler feature")
    return serve_batch(lambda t, pm, c: prefill_step(params, t, c, pm),
                       lambda t, p, c: decode_step(params, t, p, c),
                       init_cache_fn, requests, batch_slots=batch_slots,
                       max_len=max_len, device=device)
