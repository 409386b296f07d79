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

The decomposed path runs a request's prefill into a private scratch
cache and hands its lane over as a payload: ``prefill(request) ->
(first_token, LanePayload)``, ``insert(payload, slot, state)`` (a whole-lane
overwrite in place, every other lane's bytes untouched) and
``release(slot, state)`` (host bookkeeping only). ``serve_engine`` is the
FIFO loop over them and ``runtime.async_serve.AsyncServer`` the push-style
front-end. ``make_engine`` builds an engine for a model config. The engine
records the shapes each step is called with (``step_signatures``): every
step sees one signature for its life, whatever the prompt lengths and lane
compositions, which a captured CUDA graph would need.

Mesh placement (``make_engine(dist=)``): each rank of a tensor-parallel
job runs the same host loop on the same requests and holds its slice of
the params and of every cache (``parallel.sharding``); host inputs reach
every rank as the same arrays, and the logits are whole on every rank, so
the greedy tokens, and every decision taken on them, agree. An armed
step's site vectors are folded over the ranks before the sink sees them,
and a swap moves the rank's share of a lane's blocks (its cells of every
block, or its KV heads) to host memory and back.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import _map
from repro_torch.parallel import collectives as coll
from repro_torch.runtime.steps import (make_admit_step,
                                       make_chunk_prefill_step,
                                       make_decode_step)


class DecodeState(NamedTuple):
    """Per-lane decode state: ``tokens`` (B, 1) and ``pos`` (B, 1) int32 are
    host numpy (pos -1 marks an idle lane, whose output is discarded and
    whose cache writes are dropped); ``cache`` lives on the device."""
    tokens: np.ndarray
    pos: np.ndarray
    cache: Any


class LanePayload(NamedTuple):
    """What a decomposed ``prefill`` hands over: one lane's whole KV
    payload (a dense lane's slices, or the gathered blocks of a paged
    lane), on the device, and the lane's decode seed. ``insert`` lands
    ``kv`` in a slot and seeds the lane with (``first_token``,
    ``next_pos``)."""
    kv: Any
    first_token: int            # greedy token of the prefill's last logits
    next_pos: int               # len(prompt): the first decode position


def _lane_rows(prompt: np.ndarray, width: int):
    """One prompt left-padded into a (width,) pair (tokens, positions):
    positions 0..len-1 on the prompt, the -1 dead-cell sentinel on pads."""
    n = len(prompt)
    if n == 0:
        raise ValueError("empty prompt (an all-dead lane has no last-token "
                         "logits to decode from)")
    if n > width:
        raise ValueError(f"prompt length {n} exceeds the engine's "
                         f"prompt_pad_len {width}")
    toks = np.zeros((width,), np.int32)
    posm = np.full((width,), -1, np.int32)
    toks[width - n:] = prompt
    posm[width - n:] = np.arange(n)
    return toks, posm


def shape_signature(*args) -> tuple:
    """(shape, dtype) of every tensor or array leaf of ``args`` in order,
    caches included: two calls with one signature pass tensors of the same
    shapes and dtypes."""
    sig = []

    def walk(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            sig.append((tuple(x.shape), str(x.dtype)))
        elif isinstance(x, dict):
            for k in x:
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(args)
    return tuple(sig)


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
    dict (``runtime.telemetry.QuantHealth.update``). ``prompt_pad_len``:
    the width a decomposed ``prefill`` pads every prompt to (None: the
    prompt's own length). ``step_signatures``: {step: set of input shape
    signatures} of the payload steps (``extract``, ``insert``), and of
    ``prefill`` / ``generate`` / ``chunk`` on an engine from
    :func:`make_engine`.
    """

    def __init__(self, admit_fn: Callable, decode_fn: Callable,
                 init_cache_fn: Callable, *, batch_slots: int,
                 prompt_pad_len: Optional[int] = None,
                 chunk_fn: Optional[Callable] = None,
                 copy_block_fn: Optional[Callable] = None,
                 swap_out_fn: Optional[Callable] = None,
                 swap_in_fn: Optional[Callable] = None,
                 telemetry_sink: Optional[Callable] = None, device=None,
                 dist=None):
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
        self.prompt_pad_len = prompt_pad_len
        self.telemetry_sink = telemetry_sink
        self.device = resolve_device(device)
        self.dist = dist
        self.step_signatures: Dict[str, set] = {}
        self._scratch = None            # the decomposed prefill's cache
        self._scratch_ids = None        # paged scratch: lane 0's block ids

    def _record(self, step: str, *args) -> None:
        self.step_signatures.setdefault(step, set()).add(
            shape_signature(*args))

    @property
    def signature_counts(self) -> Dict[str, int]:
        """{step: number of distinct input shape signatures seen}: 1 for
        every step means fixed shapes."""
        return {k: len(v) for k, v in self.step_signatures.items()}

    def _put(self, x):
        """A host input on this rank's device. Under a mesh every rank runs
        the same host loop, so each puts the same array (the reference
        broadcasts the admit mask replicated from one host)."""
        return torch.as_tensor(x, device=self.device)

    def _unwrap(self, out):
        """Greedy tokens of a step's output, and its cache. A third output
        (an armed step's {site: (4,) or (n_super, 4)} vectors) is gathered
        into one (n, 4) tensor whose copy to pinned host memory is queued
        before the tokens' blocking read-back, which therefore waits for it
        too: the sink gets host arrays and the step syncs once. Under a
        mesh the rows are first folded over the ranks in one collective
        (:func:`_ranks_folded`), so the sink sees the unsharded step's
        vectors on every rank."""
        if len(out) == 2:
            return greedy(out[0]), out[1]
        logits, cache, tel = out
        if self.telemetry_sink is None or not tel:
            return greedy(logits), cache
        flat = torch.cat([v.reshape(-1, 4) for v in tel.values()])
        if coll.tp_size(self.dist) > 1:
            flat = _ranks_folded(flat, tel, self.dist)
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
        into host memory (the swap-out half of a preemption; under a mesh
        the rank's share of each block, the ids being global). On the card
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

    # -- the decomposed path: prefill -> insert -> generate -----------------

    @staticmethod
    def _is_paged(cache) -> bool:
        return isinstance(cache, dict) and "block_table" in cache

    def _ensure_scratch(self) -> None:
        """Build the decomposed prefill's scratch cache once: a private
        cache of the engine's own shape, so the admit step serves it with
        the decode cache's shapes. A paged scratch maps lane 0 to blocks
        0..nb-1, so the payload gather reads one fixed id vector."""
        if self._scratch is not None:
            return
        scratch = self.init_cache_fn(self.batch_slots)
        if self._is_paged(scratch):
            table = scratch["block_table"]
            nb = table.shape[1]
            num_blocks = self._arena_blocks(scratch)
            if nb > num_blocks:
                raise ValueError(
                    f"decomposed prefill needs {nb} scratch blocks for one "
                    f"lane but the paged arena holds {num_blocks}")
            table[0] = torch.arange(nb, dtype=table.dtype,
                                    device=table.device)
            self._scratch_ids = torch.arange(nb, dtype=torch.long,
                                             device=table.device)
        self._scratch = scratch

    @staticmethod
    def _arena_blocks(cache) -> int:
        for node in tfm._cache_nodes(cache):
            pos = getattr(node, "pos", None)
            if pos is not None:
                return pos.shape[-2]
        raise ValueError("paged cache holds no attention arenas")

    @torch.no_grad()
    def _extract(self, cache):
        """Lane 0 of the scratch cache as a payload (a copy: the next
        prefill writes the scratch in place)."""
        self._record("extract", cache)
        if self._is_paged(cache):
            return tfm.cache_gather_blocks(cache, self._scratch_ids)
        return tfm.cache_extract_lane(cache, 0)

    @torch.no_grad()
    def _insert(self, cache, slot: int, row, payload):
        """Write a payload into lane ``slot`` (dense) or into the blocks of
        its block-table ``row`` (paged), in place."""
        self._record("insert", cache, payload)
        if row is not None:
            return tfm.cache_scatter_blocks(cache, row, payload)
        return tfm.cache_insert_lane(cache, slot, payload)

    def prefill(self, request):
        """Prefill ONE request into the engine's scratch cache and return
        (first_token, :class:`LanePayload`). ``request`` is a
        ``serve_loop.Request`` or a (T,) prompt. The first token is read
        back from the prefill's last logits (one wait for the device), so a
        quota-1 request needs no decode step. The admit step runs at the
        decode cache's shapes (prompts pad to ``prompt_pad_len``)."""
        prompt = np.asarray(getattr(request, "prompt", request), np.int32)
        width = self.prompt_pad_len or len(prompt)
        row_t, row_p = _lane_rows(prompt, width)
        B = self.batch_slots
        toks = np.zeros((B, width), np.int32)
        posm = np.full((B, width), -1, np.int32)
        toks[0], posm[0] = row_t, row_p
        mask = np.zeros((B,), bool)
        mask[0] = True
        self._ensure_scratch()
        first, self._scratch = self.admit(toks, posm, mask, self._scratch)
        tok = int(first[0, 0])
        return tok, LanePayload(kv=self._extract(self._scratch),
                                first_token=tok, next_pos=len(prompt))

    def insert(self, payload: LanePayload, slot: int,
               state: DecodeState) -> DecodeState:
        """Land a prefilled payload in decode slot ``slot``: the whole lane
        is overwritten in place (prompt K/V and dead cells), so the slot's
        previous occupant needs no reset and every other lane's bytes stay
        as they were; the lane's host row is seeded with (first_token,
        next_pos). A paged decode cache takes the write through the slot's
        block-table row, which must be fully mapped (the identity layout of
        ``init_cache(paged=True)``; pool-managed admission uses the fused
        ``admit``)."""
        if not 0 <= slot < self.batch_slots:
            raise ValueError(f"slot {slot} outside 0..{self.batch_slots - 1}")
        cache = state.cache
        row = None
        if self._is_paged(cache):
            row = cache["block_table"][slot].long()
            if bool((row < 0).any()):
                raise ValueError(
                    f"slot {slot}'s block-table row is not fully mapped — "
                    "decomposed insert needs the identity-mapped paged "
                    "layout (init_cache(paged=True) default)")
        cache = self._insert(cache, slot, row, payload.kv)
        tokens, pos = state.tokens.copy(), state.pos.copy()
        tokens[slot, 0] = payload.first_token
        pos[slot, 0] = payload.next_pos
        return DecodeState(tokens, pos, cache)

    def release(self, slot: int, state: DecodeState) -> DecodeState:
        """Retire lane ``slot`` on the host: its position becomes -1. The
        lane's stale bytes are unreadable behind the dead-cell sentinel and
        the next ``insert`` overwrites them, so no device call is made and
        a cancellation mid-generation costs nothing."""
        tokens, pos = state.tokens.copy(), state.pos.copy()
        pos[slot, 0] = -1
        return DecodeState(tokens, pos, state.cache)


def _ranks_folded(flat, tel, dist):
    """An armed step's (n, 4) site rows ``[clipped, total, amax, range]``
    of every rank of the ``model`` axis folded into the mesh's, in one
    all-gather: a site whose tensor each rank holds a part of
    (``tel.parts``, ``core.calibration.SiteTelemetry``) adds its counts
    over the ranks, any other site's tensor is whole on every rank and
    counts once (rank 0's); amax and range take the max over the ranks."""
    parts = torch.tensor([site in tel.parts for site, v in tel.items()
                          for _ in range(v.numel() // 4)],
                         device=flat.device)
    every = coll.all_gather(flat[None], dist, dim=0)       # (N, n, 4)
    counts = torch.where(parts[:, None], every[..., :2].sum(0),
                         every[0, :, :2])
    return torch.cat([counts, every[..., 2:].amax(0)], dim=1)


def make_engine(cfg, params, *, batch_slots: int, prompt_pad_len: int,
                max_len: int, dtype=torch.float32, kv_bits: int = 16,
                paged: bool = False, block_size: int = 16,
                ctx_factory: Optional[Callable] = None, chunked=None,
                dist=None, quant_telemetry: bool = False,
                telemetry_sink: Optional[Callable] = None,
                with_chunk_fn: bool = False, device=None) -> Engine:
    """A ready-to-serve :class:`Engine` for a model config: the admit,
    decode (and with ``with_chunk_fn`` the chunk) steps of
    ``runtime.steps`` with ``params`` bound, and caches from
    ``models.transformer.init_cache`` on ``device`` (None: the GPU). Paged
    engines use the identity-mapped layout (the decomposed insert's
    contract). Each step records the shapes it is called with in
    ``engine.step_signatures`` under the reference's names ("prefill" for
    the admit step, "generate", "chunk").

    ``dist`` (a ``DistContext`` over a rank mesh) places the params and
    caches as the reference does: ``params`` (whole) cut to this rank's
    slice by ``parallel.sharding.make_param_shardings``, every cache by
    the dist's layout (``place_cache``: on its sequence dim, the
    reference's default, or with ``kv_seq_shard=False`` on its KV heads),
    the ctx's fake-quant weights from the whole weights' grids
    (``shard_ctx_factory``), and the steps run tensor-parallel. Configs the
    sharded forward cannot run raise "... not yet ported under --tp /
    dist"."""
    device = resolve_device(device)
    if dist is not None:
        from repro_torch.parallel.sharding import (make_param_shardings,
                                                   place_cache,
                                                   shard_ctx_factory)
        tfm.check_tp(cfg, dist)
        placed = make_param_shardings(params, dist)
        ctx_factory = shard_ctx_factory(cfg, params, placed, ctx_factory,
                                        dist)
        params = placed
    signatures: Dict[str, set] = {}

    def recorded(name, fn):
        def step(*args):
            signatures.setdefault(name, set()).add(shape_signature(*args))
            return fn(params, *args)
        return step

    kw = dict(ctx_factory=ctx_factory, quant_telemetry=quant_telemetry,
              dist=dist)
    admit = recorded("prefill", make_admit_step(cfg, chunked=chunked, **kw))
    decode = recorded("generate", make_decode_step(cfg, **kw))
    chunk = None
    if with_chunk_fn:
        chunk = recorded("chunk", make_chunk_prefill_step(
            cfg, chunked=chunked, **kw))

    def init_cache_fn(batch):
        cache = tfm.init_cache(cfg, batch, max_len, dtype=dtype,
                               kv_bits=kv_bits, paged=paged,
                               block_size=block_size, device=device)
        if dist is not None:
            cache = place_cache(cache, dist)
        return cache

    engine = Engine(admit, decode, init_cache_fn, batch_slots=batch_slots,
                    prompt_pad_len=prompt_pad_len, chunk_fn=chunk,
                    telemetry_sink=telemetry_sink, device=device, dist=dist)
    engine.step_signatures = signatures
    engine.params = params      # what the steps are bound to (a rank's slice)
    return engine


def serve_engine(engine: Engine, requests: List[Any],
                 state: Optional[DecodeState] = None) -> DecodeState:
    """The FIFO loop over the decomposed triad: fill free slots with
    prefill + insert, run generate until every request has its quota.
    Appends each request's greedy tokens to its ``tokens_out`` (the
    continuous Scheduler's tokens for the same requests); requests with
    ``max_new_tokens <= 0`` retire untouched. Returns the decode state."""
    B = engine.batch_slots
    if state is None:
        state = engine.init_state()
    queue = [r for r in requests if r.max_new_tokens > 0]
    for r in requests:
        if r.max_new_tokens <= 0:
            r.done = True
    lanes: List[Optional[Any]] = [None] * B
    while queue or any(r is not None for r in lanes):
        for slot in range(B):
            if lanes[slot] is not None or not queue:
                continue
            r = queue.pop(0)
            first, payload = engine.prefill(r)
            state = engine.insert(payload, slot, state)
            r.tokens_out.append(first)
            if len(r.tokens_out) >= r.max_new_tokens:
                r.done = True
                state = engine.release(slot, state)
            else:
                lanes[slot] = r
        if not any(r is not None for r in lanes):
            continue
        toks, cache = engine.generate(state)
        tokens, pos = state.tokens.copy(), state.pos.copy()
        for slot in range(B):
            r = lanes[slot]
            if r is None:
                continue
            tokens[slot, 0] = toks[slot, 0]
            pos[slot, 0] += 1
            r.tokens_out.append(int(toks[slot, 0]))
            if len(r.tokens_out) >= r.max_new_tokens:
                r.done = True
                lanes[slot] = None
                pos[slot, 0] = -1
        state = DecodeState(tokens, pos, cache)
    return state
