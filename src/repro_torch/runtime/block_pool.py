"""Host-side block allocator for the paged KV cache (port of the parts of
``repro.runtime.block_pool`` that reservation-backed serving uses; numpy
only).

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

Prefix sharing (refcounts, copy-on-write, radix eviction) and over-commit
growth are not yet ported.
"""
from __future__ import annotations

from typing import List

import numpy as np


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to back token cells 0..n_tokens-1 (0 -> 0 blocks)."""
    return -(-max(n_tokens, 0) // block_size)


class BlockPool:
    """Free-list allocator over ``num_blocks`` physical KV-cache blocks.
    ``table`` is mutated only through ``reserve_and_alloc`` / ``grow`` /
    ``free_lane``; ``dirty`` is set on every mutation and cleared by the
    scheduler when it uploads the table."""

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
        self.reset()

    def reset(self) -> None:
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.table = np.full((self.batch_slots, self.max_blocks_per_lane),
                             -1, np.int32)
        self._n_mapped = np.zeros((self.batch_slots,), np.int64)
        self._reserved = np.zeros((self.batch_slots,), np.int64)
        self.dirty = True

    # -- gauges -------------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_reserved(self) -> int:
        """Outstanding worst-case claims."""
        return int(self._reserved.sum())

    def fragmentation(self, live_tokens: int) -> float:
        """Fraction of allocated token cells not holding a live token."""
        cells = self.blocks_in_use * self.block_size
        if cells == 0:
            return 0.0
        return 1.0 - min(live_tokens, cells) / cells

    def lane_blocks(self, lane: int) -> np.ndarray:
        return self.table[lane, :int(self._n_mapped[lane])].copy()

    def lane_mapped(self, lane: int) -> int:
        return int(self._n_mapped[lane])

    # -- allocation ---------------------------------------------------------

    def can_reserve(self, n_blocks: int) -> bool:
        """True if a worst-case claim of ``n_blocks`` fits the lane width
        and the pool next to every outstanding reservation."""
        return (n_blocks <= self.max_blocks_per_lane
                and self.blocks_reserved + n_blocks <= self.num_blocks)

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

    def grow(self, lane: int, n_total: int) -> None:
        """Extend ``lane``'s mapped prefix to ``n_total`` blocks, within its
        reservation."""
        if n_total > self._reserved[lane]:
            raise RuntimeError(
                f"lane {lane}: growth to {n_total} blocks exceeds its "
                f"reservation of {int(self._reserved[lane])}")
        if n_total > self._n_mapped[lane]:
            self._map(lane, n_total - int(self._n_mapped[lane]))

    def _map(self, lane: int, n_new: int) -> None:
        if n_new <= 0:
            return
        if n_new > len(self._free):
            raise RuntimeError(
                f"free list underflow: need {n_new}, have "
                f"{len(self._free)} (reservation invariant violated)")
        start = int(self._n_mapped[lane])
        for j in range(n_new):
            self.table[lane, start + j] = self._free.pop()
        self._n_mapped[lane] = start + n_new
        self.dirty = True

    def free_lane(self, lane: int) -> int:
        """Retirement: return the lane's blocks to the free list and clear
        its reservation and table row. Returns the blocks released."""
        n = int(self._n_mapped[lane])
        for j in range(n - 1, -1, -1):
            self._free.append(int(self.table[lane, j]))
        self.table[lane, :n] = -1
        self._n_mapped[lane] = 0
        self._reserved[lane] = 0
        if n:
            self.dirty = True
        return n
