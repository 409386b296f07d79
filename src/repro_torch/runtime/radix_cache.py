"""Radix (prefix) cache over prompt token ids at KV-block granularity (a
copy of ``repro.runtime.radix_cache``, host-only numpy bookkeeping).

Sits next to :class:`~repro_torch.runtime.block_pool.BlockPool` and gives
the continuous scheduler O(suffix) admission for requests that share a
prompt prefix (system prompts, few-shot templates):

* **Match** (admission): walk the tree in ``block_size``-token steps and
  return the physical blocks backing the longest block-aligned cached
  prefix of the prompt. The scheduler maps them read-only into the lane's
  block table (``BlockPool.map_shared``) and prefills only the novel
  suffix through the append-mode chunk path.
* **Insert** (retirement): a retiring lane donates its FULL prompt blocks
  — each becomes (or joins) a tree node keyed by its ``block_size`` token
  ids. Blocks whose path already exists are NOT adopted (the donor's
  duplicates are freed normally); only newly adopted blocks are marked
  ``cached`` in the pool.
* **Evict** (pool pressure): when the free list runs dry the pool calls
  ``evict_lru`` — the least-recently-used subtree whose root block has
  refcount 0 is detached. Detached blocks with live refs merely lose
  matchability (their mappers are unaffected and the blocks free when the
  last ref drops); refcount-0 blocks return to the free list. Because
  lanes always map root paths, a refcount-0 node can never shadow a
  referenced ancestor.

The tree stores token ids as plain Python tuples (one dict-keyed child per
block); physical block contents never move here (only the scheduler's
copy-on-write copies a block, outside the tree).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class RadixNode:
    """One cached KV block: ``key`` is its block_size-token id tuple,
    ``block`` the physical block id backing it."""
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["RadixNode"]):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent = parent
        self.last_used = 0


class RadixCache:
    """Block-granular prefix tree. All methods are O(prompt / block_size)
    dict walks; ``evict_lru`` is O(nodes) (the tree is small — one node
    per cached block)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.reset()

    def reset(self) -> None:
        self._root: Dict[Tuple[int, ...], RadixNode] = {}
        self._clock = 0
        self.n_nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens) -> List[Tuple[int, ...]]:
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        return [tuple(int(t) for t in toks[i:i + bs])
                for i in range(0, (len(toks) // bs) * bs, bs)]

    # -- match --------------------------------------------------------------

    def match(self, tokens, max_blocks: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest block-aligned cached prefix of ``tokens``. Returns the
        physical blocks along the matched path (root first) and the number
        of matched tokens; bumps the LRU clock on every node of the path.
        ``max_blocks`` caps the match depth (the scheduler caps at
        ``(prompt_len - 1) // block_size`` so the novel suffix always
        keeps at least one token — the logits contract)."""
        blocks: List[int] = []
        level = self._root
        now = self._tick()
        for chunk in self._chunks(tokens):
            if max_blocks is not None and len(blocks) >= max_blocks:
                break
            node = level.get(chunk)
            if node is None:
                break
            node.last_used = now
            blocks.append(node.block)
            level = node.children
        return blocks, len(blocks) * self.block_size

    # -- insert -------------------------------------------------------------

    def insert(self, tokens, blocks: Sequence[int]) -> List[int]:
        """Donate the FULL prompt blocks of a retiring lane: ``blocks[i]``
        backs tokens ``[i*bs, (i+1)*bs)``. Existing path nodes keep their
        original physical block (the donor's duplicate is NOT adopted);
        new nodes adopt the donor's block. Returns the list of newly
        adopted blocks (the caller marks exactly those ``cached`` in the
        pool)."""
        chunks = self._chunks(tokens)
        if len(blocks) > len(chunks):
            raise ValueError(
                f"insert: {len(blocks)} blocks but only {len(chunks)} full "
                f"token chunks (donate full prompt blocks only)")
        adopted: List[int] = []
        level = self._root
        parent: Optional[RadixNode] = None
        now = self._tick()
        for chunk, block in zip(chunks, blocks):
            node = level.get(chunk)
            if node is None:
                node = RadixNode(chunk, int(block), parent)
                level[chunk] = node
                self.n_nodes += 1
                adopted.append(int(block))
            node.last_used = now
            parent = node
            level = node.children
        return adopted

    # -- evict --------------------------------------------------------------

    def _nodes(self):
        stack = list(self._root.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def evict_lru(self, ref: Callable[[int], int]) -> List[int]:
        """Detach the least-recently-used subtree whose ROOT block has
        refcount 0 (per ``ref``) and return every block of that subtree
        (the pool un-caches them all and frees the refcount-0 ones).
        Returns [] when nothing is evictable."""
        victim = None
        for nd in self._nodes():
            if ref(nd.block) == 0 and (victim is None
                                       or nd.last_used < victim.last_used):
                victim = nd
        if victim is None:
            return []
        level = (self._root if victim.parent is None
                 else victim.parent.children)
        del level[victim.key]
        out: List[int] = []
        stack = [victim]
        while stack:
            nd = stack.pop()
            out.append(nd.block)
            self.n_nodes -= 1
            stack.extend(nd.children.values())
        return out
