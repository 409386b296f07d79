"""Host-side block allocator for the paged KV cache (port of
``repro.runtime.block_pool`` for reservation-backed serving with prefix
sharing; numpy only).

The paged cache stores every attention layer's K/V as one arena of
``num_blocks`` blocks of ``block_size`` token cells. Which block backs
which cells of which decode lane is data: the ``(batch_slots,
max_blocks_per_lane)`` int32 block table (-1 = unmapped) that the steps
receive inside the cache dict. This pool owns that table between steps:

* **Prefix mapping.** A lane's mapped blocks are always the logical prefix
  ``table[lane, 0:n]``; a lane that has written positions ``0..p`` maps
  at least ``p // block_size + 1`` blocks, so every cell a read path can
  derive as valid is backed.
* **Reservation-backed growth.** Admission reserves the request's worst
  case (``ceil((prompt + quota - 1) / block_size)``, clamped to the ring
  when every layer is windowed) and admits only when it fits; growth then
  draws on the reservation and cannot fail mid-flight. A request whose
  reservation does not fit waits at the head of the queue.
* **Refcounted sharing and copy-on-write (prefix cache).** Every block
  carries a refcount (how many lane tables map it) and a ``cached`` flag
  (it backs a node of an attached
  :class:`~repro_torch.runtime.radix_cache.RadixCache`). ``map_shared``
  installs already-written blocks read-only into a lane's prefix;
  ``free_lane`` decrements instead of freeing, returning a block to the
  free list only at refcount 0 when it is not cached. A lane about to
  write into a block it does not solely own first calls ``cow``: the
  table entry is swapped for a fresh private block (charged to the lane's
  novel reservation) and the scheduler copies the payload on the device.
  Reservations count only a lane's NOVEL blocks; shared blocks are
  accounted through ``blocks_pinned`` (cached blocks some lane still maps,
  unevictable), while cached refcount-0 blocks stay reclaimable: the free
  list evicts them LRU through the attached radix cache when it runs dry.

* **Over-commit growth.** Without worst-case reservations ``try_grow``
  extends a lane's reservation on demand and returns False, with no
  change, when the pool cannot supply the blocks (the scheduler then
  preempts a victim lane and retries); ``cow(extend=True)`` grows the
  reservation in place instead of raising.

All gauges are physical: a block mapped by five lanes counts once in
``blocks_in_use``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to back token cells 0..n_tokens-1 (0 -> 0 blocks)."""
    return -(-max(n_tokens, 0) // block_size)


class BlockPool:
    """Free-list allocator over ``num_blocks`` physical KV-cache blocks.
    ``table`` is mutated only through ``reserve_and_alloc`` /
    ``map_shared`` / ``grow`` / ``try_grow`` / ``cow`` / ``free_lane``;
    ``dirty`` is set on every mutation and cleared by the scheduler when
    it uploads the table."""

    def __init__(self, num_blocks: int, block_size: int, batch_slots: int,
                 max_blocks_per_lane: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.batch_slots = batch_slots
        self.max_blocks_per_lane = max_blocks_per_lane
        self._cache = None          # attached RadixCache (eviction source)
        # called with the evicted block ids whenever the radix cache's LRU
        # eviction reclaims blocks (the scheduler sets it when tracing)
        self.on_evict = None
        self.reset()

    def reset(self) -> None:
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.table = np.full((self.batch_slots, self.max_blocks_per_lane),
                             -1, np.int32)
        self._n_mapped = np.zeros((self.batch_slots,), np.int64)
        # novel-only worst-case claims (shared blocks are already allocated)
        self._reserved = np.zeros((self.batch_slots,), np.int64)
        # per-lane count of still-shared mapped blocks (decremented by cow)
        self._n_shared = np.zeros((self.batch_slots,), np.int64)
        self._ref = np.zeros((self.num_blocks,), np.int64)
        self._cached = np.zeros((self.num_blocks,), bool)
        if self._cache is not None:
            self._cache.reset()
        self.dirty = True

    def attach_cache(self, cache) -> None:
        """Attach a RadixCache as the LRU eviction source: when the free
        list runs dry, the pool reclaims refcount-0 cached blocks from
        it."""
        self._cache = cache

    # -- gauges -------------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        """Physically allocated blocks (each counted once however many
        lanes map it; cached prefix blocks included)."""
        return self.num_blocks - len(self._free)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_reserved(self) -> int:
        """Outstanding worst-case NOVEL claims (shared blocks excluded)."""
        return int(self._reserved.sum())

    @property
    def blocks_cached(self) -> int:
        """Blocks backing radix-cache nodes (evictable iff refcount 0)."""
        return int(self._cached.sum())

    @property
    def blocks_pinned(self) -> int:
        """Cached blocks some lane still maps: not evictable, so they
        subtract from the capacity admission can claim."""
        return int((self._cached & (self._ref > 0)).sum())

    @property
    def shared_blocks(self) -> int:
        """Blocks serving a shared prefix now (cached and mapped)."""
        return self.blocks_pinned

    @property
    def blocks_evictable(self) -> int:
        """Cached refcount-0 blocks, reclaimable through the attached radix
        cache's LRU eviction."""
        return int((self._cached & (self._ref == 0)).sum())

    def available_blocks(self) -> int:
        """Blocks the free list could supply now: free plus evictable."""
        return len(self._free) + self.blocks_evictable

    @property
    def refcount_total(self) -> int:
        """Sum of block refcounts: the table entries that map a block."""
        return int(self._ref.sum())

    def fragmentation(self, live_tokens: int) -> float:
        """Fraction of allocated token cells not holding a live token
        (``live_tokens`` counted once per physical cell, see the
        scheduler's ``_track``)."""
        cells = self.blocks_in_use * self.block_size
        if cells == 0:
            return 0.0
        return 1.0 - min(live_tokens, cells) / cells

    def lane_blocks(self, lane: int) -> np.ndarray:
        return self.table[lane, :int(self._n_mapped[lane])].copy()

    def lane_mapped(self, lane: int) -> int:
        return int(self._n_mapped[lane])

    def lane_shared(self, lane: int) -> int:
        """Number of ``lane``'s mapped blocks still shared (not yet
        copied on write)."""
        return int(self._n_shared[lane])

    def block_ref(self, block: int) -> int:
        return int(self._ref[block])

    def is_cached(self, block: int) -> bool:
        return bool(self._cached[block])

    # -- allocation ---------------------------------------------------------

    def _fits(self, n_novel: int, n_cols: int, new_pins: int) -> bool:
        """``n_cols`` table columns must fit the lane width, and the novel
        claim must fit next to every outstanding reservation and every
        pinned cached block."""
        return (n_cols <= self.max_blocks_per_lane
                and (self.blocks_reserved + n_novel
                     + self.blocks_pinned + new_pins) <= self.num_blocks)

    def can_reserve(self, n_blocks: int) -> bool:
        """True if a worst-case novel claim of ``n_blocks`` fits (no shared
        prefix)."""
        return self._fits(n_blocks, n_blocks, 0)

    def can_map_shared(self, blocks: Sequence[int], n_reserve: int,
                       n_cols: int) -> bool:
        """Backpressure test of a prefix-hit admission: ``blocks`` mapped
        shared, ``n_reserve`` novel claim, ``n_cols`` table columns the
        lane may ever occupy."""
        new_pins = sum(1 for b in blocks if self._ref[b] == 0)
        return self._fits(n_reserve, n_cols, new_pins)

    def reserve_and_alloc(self, lane: int, n_alloc: int,
                          n_reserve: int) -> bool:
        """Admission: claim ``n_reserve`` blocks for ``lane`` and map the
        first ``n_alloc`` now. False, with no change, when it does not
        fit."""
        n_reserve = max(n_reserve, n_alloc)
        if self._reserved[lane] or self._n_mapped[lane]:
            raise RuntimeError(f"lane {lane} still holds blocks/reservation")
        if not self.can_reserve(n_reserve):
            return False
        self._reserved[lane] = n_reserve
        self._map(lane, n_alloc)
        return True

    def map_shared(self, lane: int, blocks: Sequence[int], n_alloc: int,
                   n_reserve: int, n_cols: int) -> bool:
        """Prefix-hit admission: install the already-written cached
        ``blocks`` read-only at ``table[lane, 0:k]`` (refcount bump, no
        allocation), map ``n_alloc`` fresh blocks for the first novel chunk
        and claim ``n_reserve`` novel blocks (suffix, decode growth and a
        copy-on-write allowance). ``n_cols`` is the table columns the lane
        may ever occupy. False, with no change, when it does not fit."""
        if self._reserved[lane] or self._n_mapped[lane]:
            raise RuntimeError(f"lane {lane} still holds blocks/reservation")
        k = len(blocks)
        if k == 0:
            return self.reserve_and_alloc(lane, n_alloc, n_reserve)
        n_reserve = max(n_reserve, n_alloc)
        if not self.can_map_shared(blocks, n_reserve, max(n_cols,
                                                          k + n_alloc)):
            return False
        for j, b in enumerate(blocks):
            if not self._cached[b]:
                raise RuntimeError(
                    f"map_shared: block {b} is not a cached prefix block")
            self.table[lane, j] = b
            self._ref[b] += 1
        self._n_mapped[lane] = k
        self._n_shared[lane] = k
        self._reserved[lane] = n_reserve
        self._map(lane, n_alloc)
        self.dirty = True
        return True

    def grow(self, lane: int, n_total: int) -> None:
        """Extend ``lane``'s mapped prefix to ``n_total`` blocks within its
        reservation; only the novel part (beyond its shared prefix) draws
        on it."""
        novel = n_total - int(self._n_shared[lane])
        if novel > self._reserved[lane]:
            raise RuntimeError(
                f"lane {lane}: growth to {n_total} blocks ({novel} novel) "
                f"exceeds its reservation of {int(self._reserved[lane])}")
        if n_total > self._n_mapped[lane]:
            self._map(lane, n_total - int(self._n_mapped[lane]))

    def try_grow(self, lane: int, n_total: int) -> bool:
        """Over-commit growth: extend ``lane``'s mapped prefix to
        ``n_total`` blocks, extending its reservation on demand. False, with
        no change, when the pool cannot supply the extra blocks or the
        lane's table row is too narrow. The reservation tracks the lane's
        novel mapped count, so ``_fits`` stays physically exact."""
        if n_total > self.max_blocks_per_lane:
            return False
        n_new = n_total - int(self._n_mapped[lane])
        if n_new <= 0:
            return True
        if n_new > self.available_blocks():
            return False
        novel = n_total - int(self._n_shared[lane])
        self._reserved[lane] = max(int(self._reserved[lane]), novel)
        self._map(lane, n_new)
        return True

    def needs_cow(self, lane: int, col: int) -> bool:
        """True when ``lane`` does not solely own the mapped block at table
        column ``col``: writing it would mutate a shared or cached block."""
        if col >= int(self._n_mapped[lane]):
            return False
        b = int(self.table[lane, col])
        return bool(self._cached[b]) or int(self._ref[b]) > 1

    def cow(self, lane: int, col: int,
            extend: bool = False) -> Optional[Tuple[int, int]]:
        """Copy-on-write: if ``lane`` is about to write into a block it does
        not solely own, swap ``table[lane, col]`` for a fresh private block
        (charged to the lane's novel reservation) and return ``(src, dst)``
        for the device copy. None when the lane already owns the block.
        ``extend`` (over-commit, no copy-on-write allowance reserved) grows
        the reservation instead of raising; the scheduler makes sure a
        block is available first."""
        if not self.needs_cow(lane, col):
            return None
        src = int(self.table[lane, col])
        novel = int(self._n_mapped[lane]) - int(self._n_shared[lane]) + 1
        if novel > self._reserved[lane]:
            if not extend:
                raise RuntimeError(
                    f"lane {lane}: COW at col {col} exceeds its reservation "
                    f"of {int(self._reserved[lane])}")
            self._reserved[lane] = novel
        dst = self._pop_free(1)[0]
        self.table[lane, col] = dst
        self._ref[dst] = 1
        self._ref[src] -= 1
        self._n_shared[lane] -= 1
        self.dirty = True
        return src, dst

    def _pop_free(self, n: int) -> List[int]:
        """Take ``n`` blocks off the free list, reclaiming LRU refcount-0
        cached blocks through the attached radix cache when it runs dry."""
        while len(self._free) < n and self._cache is not None:
            evicted = self._cache.evict_lru(self.block_ref)
            if not evicted:
                break
            if self.on_evict is not None:
                self.on_evict(evicted)
            for b in evicted:
                self._cached[b] = False
                if self._ref[b] == 0:
                    self._free.append(b)
        if n > len(self._free):
            raise RuntimeError(
                f"free list underflow: need {n}, have {len(self._free)} "
                "(reservation invariant violated)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 0
        return out

    def _map(self, lane: int, n_new: int) -> None:
        if n_new <= 0:
            return
        start = int(self._n_mapped[lane])
        for j, b in enumerate(self._pop_free(n_new)):
            self.table[lane, start + j] = b
            self._ref[b] = 1
        self._n_mapped[lane] = start + n_new
        self.dirty = True

    def set_cached(self, block: int, cached: bool = True) -> None:
        """Mark ``block`` as backing a radix-cache node (on donation; the
        pool clears it on eviction). An uncached refcount-0 block goes
        straight back to the free list."""
        self._cached[block] = cached
        if not cached and self._ref[block] == 0:
            self._free.append(int(block))

    def free_lane(self, lane: int) -> int:
        """Retirement: decrement every mapped block's refcount, returning
        blocks that reach refcount 0 (and are not cached) to the free list;
        clear the lane's reservation and table row. Returns the blocks
        released to the free list."""
        n = int(self._n_mapped[lane])
        released = 0
        for j in range(n - 1, -1, -1):
            b = int(self.table[lane, j])
            self._ref[b] -= 1
            if self._ref[b] == 0 and not self._cached[b]:
                self._free.append(b)
                released += 1
        self.table[lane, :n] = -1
        self._n_mapped[lane] = 0
        self._n_shared[lane] = 0
        self._reserved[lane] = 0
        if n:
            self.dirty = True
        return released
