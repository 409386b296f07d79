"""Async serving front-end over the engine's decomposed triad (port of
``repro.runtime.async_serve``).

:class:`AsyncServer` turns the pull-style :func:`~repro_torch.runtime.
engine.serve_engine` loop into a push-style service: producers ``submit()``
prompts from any thread and read tokens back through a per-request
:class:`TokenStream`, while ONE scheduler thread owns the engine and its
:class:`~repro_torch.runtime.engine.DecodeState` and drives the
prefill -> insert -> generate cycle.

Threading contract:

* The engine and every device tensor are touched ONLY by the scheduler
  thread — producers never hold a tensor of the engine, so nothing on the
  device needs a lock. Submissions cross over through a thread-safe inbox
  queue; tokens cross back through each stream's condition variable. (The
  steps run under ``torch.no_grad``, which is per thread in PyTorch: they
  set it themselves.)
* FIFO admission in ARRIVAL order (the inbox's order), whatever thread
  races produced it: two producers submitting concurrently get whichever
  interleave the queue saw, but each request's OWN tokens arrive on its
  stream strictly in generation order and equal the synchronous
  Scheduler's greedy tokens for the same prompt (lanes are computed
  independently).
* ``cancel()`` retires a request at the next scheduler iteration:
  resident lanes are released (host-side pos sentinel — no device call),
  queued requests never admit. The stream closes with ``cancelled=True``
  and keeps the tokens emitted so far.
* ``close()`` drains by default (every accepted request finishes), then
  joins the thread; ``close(drain=False)`` cancels everything pending.
* Under a mesh (an engine from ``make_engine(dist=)``) every rank runs
  its own server on the same submissions, and each scheduler iteration
  first settles its host view with the other ranks (``collectives.
  agree_max`` over the mesh's host group): it admits only the requests
  every rank has seen, closes only when every rank is closing, and
  cancels a request once any rank has cancelled it. So every rank makes
  the same model calls in the same order, whenever each rank's
  submissions arrive.
* A failure in the scheduler thread (a kernel launch error, say) is not
  swallowed and hangs no one: every queued and resident stream closes
  with that error, which ``result()``, iteration, ``close()`` and any later
  ``submit()`` raise. (The reference's loop has no handler: its consumers
  would wait out their timeouts.)
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
from typing import Any, List, Optional

import numpy as np

from repro_torch.parallel.collectives import agree_max
from repro_torch.runtime.engine import DecodeState, Engine


class TokenStream:
    """One request's token stream. The scheduler thread appends tokens;
    any number of consumers iterate (blocking) or poll. Iteration yields
    each token exactly once per iterator, in generation order, and ends
    when the request retires (quota reached or cancelled); a stream closed
    by a scheduler failure raises that failure once its tokens are
    read."""

    def __init__(self, rid: Any = None):
        self.rid = rid
        self._cv = threading.Condition()
        self._toks: List[int] = []
        self._closed = False
        self._error: Optional[BaseException] = None
        self.cancelled = False

    # -- scheduler-thread side ---------------------------------------------

    def _put(self, tok: int) -> None:
        with self._cv:
            self._toks.append(int(tok))
            self._cv.notify_all()

    def _close(self, cancelled: bool = False,
               error: Optional[BaseException] = None) -> None:
        with self._cv:
            self._closed = True
            self.cancelled = self.cancelled or cancelled
            self._error = self._error or error
            self._cv.notify_all()

    # -- consumer side ------------------------------------------------------

    @property
    def done(self) -> bool:
        with self._cv:
            return self._closed

    @property
    def error(self) -> Optional[BaseException]:
        """The scheduler failure that closed this stream, or None."""
        with self._cv:
            return self._error

    def tokens_so_far(self) -> List[int]:
        with self._cv:
            return list(self._toks)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream closes, then return ALL its tokens (or
        raise the scheduler failure that closed it)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._closed, timeout):
                raise TimeoutError(f"stream {self.rid!r} still open "
                                   f"after {timeout}s")
            if self._error is not None:
                raise self._error
            return list(self._toks)

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: i < len(self._toks) or self._closed)
                if i >= len(self._toks):
                    if self._error is not None:
                        raise self._error
                    return
                tok = self._toks[i]
            i += 1
            yield tok


class _Pending:
    __slots__ = ("stream", "prompt", "quota")

    def __init__(self, stream: TokenStream, prompt: np.ndarray, quota: int):
        self.stream = stream
        self.prompt = prompt
        self.quota = quota


class AsyncServer:
    """Push-style serving front-end: one scheduler thread drives an
    :class:`~repro_torch.runtime.engine.Engine`'s decomposed triad over a
    thread-safe submission queue. See the module docstring for the
    threading contract."""

    # scheduler-thread poll period while lanes are idle and the inbox is
    # empty — bounds cancel/close latency without spinning
    _IDLE_WAIT = 0.005

    def __init__(self, engine: Engine):
        self._engine = engine
        self._inbox: _queue.Queue = _queue.Queue()
        self._cancelled: set = set()        # id(stream) marks
        self._lock = threading.Lock()       # guards the flags and the inbox
        self._closing = False
        self._drain = True
        self._error: Optional[BaseException] = None
        # scheduler-thread state (module docstring): queued and resident
        self._pending: collections.deque = collections.deque()
        self._lanes: List[Optional[_Pending]] = [None] * engine.batch_slots
        self._thread = threading.Thread(
            target=self._run, name="async-serve-scheduler", daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               rid: Any = None) -> TokenStream:
        """Enqueue one request; returns its stream immediately. Safe from
        any thread. Quota <= 0 closes the stream without ever admitting."""
        stream = TokenStream(rid)
        prompt = np.asarray(prompt, np.int32)
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._closing:
                raise RuntimeError("AsyncServer is closed")
            if max_new_tokens <= 0:
                stream._close()
                return stream
            self._inbox.put(_Pending(stream, prompt, max_new_tokens))
        return stream

    def cancel(self, stream: TokenStream) -> None:
        """Retire ``stream``'s request at the next scheduler iteration —
        free whether it is still queued or already generating (lane
        release is a host-side sentinel write). Idempotent; a no-op on an
        already-finished stream."""
        with self._lock:
            self._cancelled.add(id(stream))

    def close(self, drain: bool = True) -> None:
        """Stop the scheduler thread. ``drain=True`` (default) finishes
        every accepted request first; ``drain=False`` cancels all queued
        AND resident requests. Further submits raise, and so does this
        call when the scheduler thread failed."""
        with self._lock:
            self._closing = True
            self._drain = drain
        self._thread.join()
        if self._error is not None:
            raise self._error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- scheduler thread ---------------------------------------------------

    def _is_cancelled(self, stream: TokenStream) -> bool:
        with self._lock:
            return id(stream) in self._cancelled

    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as e:      # noqa: BLE001 — handed to consumers
            self._fail(e)

    def _fail(self, error: BaseException) -> None:
        """Close every queued, resident and not yet collected stream with
        ``error``; later submits raise it."""
        with self._lock:
            self._error = error
            while True:
                try:
                    self._pending.append(self._inbox.get_nowait())
                except _queue.Empty:
                    break
        for item in list(self._pending) + [x for x in self._lanes if x]:
            item.stream._close(error=error)
        self._pending.clear()
        self._lanes = [None] * len(self._lanes)

    def _settle(self, pending, closing: bool, drain: bool):
        """(closing, drain, n, drained): the host view every rank acts on
        this iteration. ``n`` queued requests are seen by every rank;
        ``drained``: no rank holds a request beyond those ``n``. Without
        a mesh: this server's own view."""
        dist = getattr(self._engine, "dist", None)
        n_local = len(pending)
        rest = n_local + (0 if self._inbox.empty() else 1)
        if dist is None:
            return closing, drain, n_local, rest == n_local
        neg_n, rest_max, not_closing, no_drain = agree_max(
            [-n_local, rest, int(not closing), int(closing and not drain)],
            dist)
        n = -neg_n
        return not not_closing, not no_drain, n, rest_max == n

    def _cancelled_flags(self, items) -> List[bool]:
        """Whether each item (None: an empty lane) is cancelled — on any
        rank, under a mesh."""
        flags = [int(it is not None and self._is_cancelled(it.stream))
                 for it in items]
        dist = getattr(self._engine, "dist", None)
        if dist is not None and flags:
            flags = agree_max(flags, dist)
        return [bool(f) for f in flags]

    def _loop(self) -> None:
        eng = self._engine
        B = eng.batch_slots
        state = eng.init_state()
        lanes, pending = self._lanes, self._pending
        while True:
            # drain the inbox (non-blocking — arrival order preserved)
            while True:
                try:
                    pending.append(self._inbox.get_nowait())
                except _queue.Empty:
                    break
            with self._lock:
                closing, drain = self._closing, self._drain
            closing, drain, n, drained = self._settle(pending, closing,
                                                      drain)
            head = list(pending)[:n]
            if closing and not drain:
                for item in head:
                    pending.remove(item)
                    item.stream._close(cancelled=True)
                head, n = [], 0
                for slot in range(B):
                    if lanes[slot] is not None:
                        lanes[slot].stream._close(cancelled=True)
                        state = eng.release(slot, state)
                        lanes[slot] = None
            # cancellation sweep: queued requests never admit, resident
            # lanes release (host-side only — generation just stops)
            flags = self._cancelled_flags(head + list(lanes))
            for item, cancelled in zip(head, flags):
                if cancelled:
                    pending.remove(item)
                    item.stream._close(cancelled=True)
            admissible = n - sum(flags[:len(head)])
            for slot, cancelled in zip(range(B), flags[len(head):]):
                item = lanes[slot]
                if cancelled:
                    lanes[slot] = None
                    state = eng.release(slot, state)
                    item.stream._close(cancelled=True)
            # admission: decomposed prefill+insert into every free slot
            for slot in range(B):
                if lanes[slot] is not None or not admissible:
                    continue
                item = pending.popleft()
                admissible -= 1
                lanes[slot] = item      # resident from here (see _fail)
                first, payload = eng.prefill(item.prompt)
                state = eng.insert(payload, slot, state)
                item.stream._put(first)
                if item.quota <= 1:
                    item.stream._close()
                    lanes[slot] = None
                    state = eng.release(slot, state)
            live = [s for s in range(B) if lanes[s] is not None]
            if not live:
                if closing and drained and not pending:
                    return
                # idle: park briefly on the inbox so submit() wakes us
                try:
                    pending.append(self._inbox.get(timeout=self._IDLE_WAIT))
                except _queue.Empty:
                    pass
                continue
            # one generate step over every lane; idle lanes emit garbage
            # the loop ignores (dead-cell sentinel drops their writes)
            toks, cache = eng.generate(state)
            tokens, pos = state.tokens.copy(), state.pos.copy()
            for slot in live:
                item = lanes[slot]
                tokens[slot, 0] = toks[slot, 0]
                pos[slot, 0] += 1
                item.stream._put(int(toks[slot, 0]))
                if len(item.stream._toks) >= item.quota:
                    item.stream._close()
                    lanes[slot] = None
                    pos[slot, 0] = -1
            state = DecodeState(tokens, pos, cache)
