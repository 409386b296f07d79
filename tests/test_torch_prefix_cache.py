"""The port's prefix-sharing bookkeeping against the reference's, host only
(no model): the same sequences of ``match`` / ``insert`` / ``evict_lru``
through both ``RadixCache`` classes, of ``map_shared`` / ``cow`` /
``free_lane`` / eviction through both ``BlockPool`` classes, and of whole
prefix-sharing serving runs through both continuous Schedulers on a stub
model (the cases of ``tests/test_prefix_cache.py``'s ``TestRadixCache``,
``TestSharedBlockPool``, ``TestGoldenPrefix``, ``TestPrefixSweep`` and its
hypothesis properties, and ``TestSyncTableFastPath``). Outputs, tables,
refcounts, cached flags, free lists, ``dirty`` and the serving counters
must come out equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import BlockPool as JBlockPool
from repro.runtime import RadixCache as JRadixCache
from repro.runtime import Request as JRequest
from repro.runtime import serve as jserve
from repro.runtime import serve_continuous as jserve_continuous
from repro_torch.runtime import (BlockPool, RadixCache, Request, serve,
                                 serve_continuous)

pytestmark = pytest.mark.prefix


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 32
CPU = "cpu"


def _next_arr(toks):
    return (2 * np.asarray(toks) + 1) % VOCAB


def _golden(prompt, n):
    out, tok = [], int(prompt[-1])
    for _ in range(n):
        tok = (2 * tok + 1) % VOCAB
        out.append(tok)
    return out


# ---------------------------------------------------------------------------
# RadixCache: one script through both
# ---------------------------------------------------------------------------

def _cat(*parts):
    return np.concatenate([np.asarray(p) for p in parts]).astype(np.int32)


RADIX_SCRIPTS = {
    "match_longest_block_aligned_prefix": [
        ("insert", (np.arange(12), [5, 7, 2])),
        ("match", (np.arange(12),)), ("match", (np.arange(8),)),
        ("match", (np.arange(10),)),
        ("match", (_cat(np.arange(8), [99, 98, 97, 96]),)),
        ("match", (np.arange(50, 62),))],
    "match_cap_preserves_logits_contract": [
        ("insert", (np.arange(12), [5, 7, 2])),
        ("match", (np.arange(12), (12 - 1) // 4))],
    "insert_dedup_keeps_original_blocks": [
        ("insert", (np.arange(8), [5, 7])),
        ("insert", (np.arange(12), [9, 8, 2])),
        ("match", (np.arange(12),))],
    "insert_rejects_partial_blocks": [
        ("insert", (np.arange(6), [5, 7]))],
    "evict_lru_picks_oldest_ref0_subtree": [
        ("insert", (np.arange(8), [0, 1])),
        ("insert", (np.arange(50, 54), [2])),
        ("match", (np.arange(8),)),
        ("evict_lru", ({},)), ("evict_lru", ({},)), ("evict_lru", ({},))],
    "evict_respects_refcounts": [
        ("insert", (np.arange(8), [0, 1])),
        ("evict_lru", ({0: 1},)), ("match", (np.arange(8),)),
        ("evict_lru", ({0: 1, 1: 1},))],
    "reset_forgets_every_path": [
        ("insert", (np.arange(16), [3, 1, 4, 0])), ("reset", ()),
        ("match", (np.arange(16),)),
        ("insert", (np.arange(4), [6])), ("match", (np.arange(16),))],
}


def _radix_call(rc, name, args):
    if name == "evict_lru":
        refs = args[0]
        out = rc.evict_lru(lambda b: refs.get(b, 0))
        return sorted(out)
    if name == "reset":
        return rc.reset()
    try:
        return getattr(rc, name)(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(RADIX_SCRIPTS))
def test_radix_cache_matches_reference(case):
    jrc, trc = JRadixCache(4), RadixCache(4)
    for name, args in RADIX_SCRIPTS[case]:
        want = _radix_call(jrc, name, args)
        got = _radix_call(trc, name, args)
        assert got == want, (case, name)
        assert trc.n_nodes == jrc.n_nodes, (case, name)


def test_radix_cache_rejects_a_zero_block_size():
    for cls in (JRadixCache, RadixCache):
        with pytest.raises(ValueError, match="block_size"):
            cls(0)


# ---------------------------------------------------------------------------
# BlockPool sharing: one script through both
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return dict(table=pool.table.tolist(), free=list(pool._free),
                ref=pool._ref.tolist(), cached=pool._cached.tolist(),
                reserved=pool._reserved.tolist(),
                shared=pool._n_shared.tolist(),
                mapped=pool._n_mapped.tolist(), dirty=pool.dirty,
                gauges=[pool.blocks_in_use, pool.blocks_free,
                        pool.blocks_reserved, pool.blocks_cached,
                        pool.blocks_pinned, pool.shared_blocks,
                        pool.blocks_evictable, pool.available_blocks(),
                        pool.refcount_total, pool.fragmentation(5)])


def _donate(lane=0, n=3, cached=2):
    """Allocate ``n`` blocks on ``lane``, cache the first ``cached`` and
    retire the lane: the canonical donation sequence."""
    return [("reserve_and_alloc", (lane, n, n)),
            ("cache_lane_blocks", (lane, cached)),
            ("free_lane", (lane,))]


# (pool shape, attach a radix cache, operations); "cache_lane_blocks"
# marks the lane's first blocks cached, "radix_insert" donates them
# through the radix cache, "clear_dirty" acts as the scheduler's upload
POOL_SCRIPTS = {
    "map_shared_refcounts_and_decrementing_free": (
        (8, 4, 2, 6), False, _donate() + [
            ("map_shared", (1, [0, 1], 1, 2, 4)),
            ("map_shared", (0, [0, 1], 0, 1, 4)),
            ("free_lane", (0,)), ("free_lane", (1,)),
            ("set_cached", (0, False))]),
    "map_shared_rejects_uncached_blocks": (
        (8, 4, 2, 6), False, [("reserve_and_alloc", (0, 2, 2)),
                              ("map_shared", (1, [0], 1, 1, 2))]),
    "cow_swaps_column_and_preserves_source": (
        (8, 4, 2, 6), False, _donate() + [
            ("map_shared", (1, [0, 1], 1, 3, 4)),
            ("needs_cow", (1, 0)), ("needs_cow", (1, 1)),
            ("needs_cow", (1, 2)), ("cow", (1, 0)), ("cow", (1, 0)),
            ("cow", (1, 1)), ("free_lane", (1,))]),
    "cow_beyond_the_reservation_raises": (
        (8, 4, 2, 6), False, _donate() + [
            ("map_shared", (1, [0, 1], 1, 1, 4)), ("cow", (1, 0))]),
    "pinned_blocks_gate_admission": (
        (4, 4, 2, 4), False, _donate(n=2, cached=2) + [
            ("map_shared", (0, [0, 1], 1, 1, 3)), ("can_reserve", (2,)),
            ("can_reserve", (1,)), ("can_map_shared", ([0, 1], 1, 3))]),
    "free_list_reclaims_lru_cached_via_radix": (
        (4, 4, 1, 4), True, [
            ("reserve_and_alloc", (0, 3, 3)),
            ("radix_insert", (0, np.arange(12))), ("free_lane", (0,)),
            ("reserve_and_alloc", (0, 3, 3)), ("radix_match",
                                               (np.arange(12),))]),
    "eviction_keeps_mapped_ancestors": (
        (6, 4, 2, 4), True, [
            ("reserve_and_alloc", (0, 2, 2)),
            ("radix_insert", (0, np.arange(8))), ("free_lane", (0,)),
            ("map_shared", (1, [0], 1, 2, 3)),
            ("reserve_and_alloc", (0, 4, 4)),
            ("radix_match", (np.arange(8),)), ("free_lane", (1,)),
            ("free_lane", (0,))]),
    "dirty_flag_transitions": (
        (8, 4, 2, 6), False, [
            ("clear_dirty", ()), ("reserve_and_alloc", (0, 1, 3)),
            ("clear_dirty", ()), ("grow", (0, 1)), ("grow", (0, 2)),
            ("clear_dirty", ()), ("cache_lane_blocks", (0, 1)),
            ("free_lane", (0,)), ("clear_dirty", ()),
            ("map_shared", (1, [0], 0, 2, 3)), ("clear_dirty", ()),
            ("cow", (1, 0)), ("free_lane", (1,))]),
    "grow_beyond_the_reservation_raises": (
        (8, 4, 2, 6), False, _donate() + [
            ("map_shared", (1, [0, 1], 1, 2, 4)), ("grow", (1, 4)),
            ("grow", (1, 5))]),
}


def _pool_call(pool, radix, name, args):
    if name == "clear_dirty":
        pool.dirty = False
        return None
    if name == "cache_lane_blocks":
        lane, n = args
        for b in pool.lane_blocks(lane)[:n]:
            pool.set_cached(int(b))
        return None
    if name == "radix_insert":
        lane, toks = args
        blocks = [int(b) for b in pool.lane_blocks(lane)]
        for b in radix.insert(toks, blocks):
            pool.set_cached(b)
        return None
    if name == "radix_match":
        return radix.match(*args)
    try:
        return getattr(pool, name)(*args)
    except RuntimeError as e:
        return ("RuntimeError", str(e))


@pytest.mark.parametrize("case", sorted(POOL_SCRIPTS))
def test_shared_block_pool_matches_reference(case):
    shape, with_radix, script = POOL_SCRIPTS[case]
    jpool, tpool = JBlockPool(*shape), BlockPool(*shape)
    jrc = trc = None
    if with_radix:
        jrc, trc = JRadixCache(shape[1]), RadixCache(shape[1])
        jpool.attach_cache(jrc)
        tpool.attach_cache(trc)
    assert _pool_state(tpool) == _pool_state(jpool)
    for name, args in script:
        want = _pool_call(jpool, jrc, name, args)
        got = _pool_call(tpool, trc, name, args)
        assert got == want, (case, name, args)
        assert _pool_state(tpool) == _pool_state(jpool), (case, name, args)
        if with_radix:
            assert trc.n_nodes == jrc.n_nodes


# ---------------------------------------------------------------------------
# Serving on a stub model: both Schedulers, the same runs
# ---------------------------------------------------------------------------

class _Stub:
    """next token = (2 * last token + 1) % VOCAB as one-hot logits; counts
    the step calls and records the device block table each step sees (a
    new object: the scheduler uploaded the table again)."""

    def __init__(self, onehot):
        self.onehot = onehot
        self.calls = []
        self.tables = {"admit": [], "chunk": [], "decode": []}

    def init_cache(self, batch):
        return {}

    def _step(self, kind, tokens, cache):
        self.calls.append(kind)
        self.tables[kind].append(cache.get("block_table"))
        return self.onehot(_next_arr(tokens)), cache

    def admit(self, tokens, positions, admit_mask, cache):
        return self._step("admit", tokens, cache)

    def chunk(self, tokens, positions, reset_mask, cache):
        return self._step("chunk", tokens, cache)

    def decode(self, tokens, pos, cache):
        return self._step("decode", tokens, cache)


def _jstub():
    return _Stub(lambda t: jnp.eye(VOCAB, dtype=jnp.float32)[
        jnp.asarray(t) % VOCAB])


def _tstub():
    return _Stub(lambda t: torch.nn.functional.one_hot(
        torch.as_tensor(t).long() % VOCAB, VOCAB).float())


PREFIX8 = np.arange(1, 9, dtype=np.int32)        # two 4-token blocks


def _prefix_reqs(cls, specs, shared=PREFIX8):
    """Requests opening with ``shared``; suffixes distinct per request."""
    return [cls(rid=i, prompt=np.concatenate(
        [shared, np.full(n - len(shared), 10 + i, np.int32)]),
        max_new_tokens=q) for i, (n, q) in enumerate(specs)]


STAT_FIELDS = ("tokens_generated", "decode_steps", "prefill_calls",
               "chunk_steps", "blocks_in_use", "block_fragmentation",
               "slot_utilization", "queue_wait_steps", "prefix_hit_tokens",
               "prefill_tokens_saved", "shared_blocks", "prefix_hit_rate")


class _CountingPools:
    """The pool classes with their block draws counted."""

    @staticmethod
    def wrap(cls):
        class Counting(cls):
            def reset(self):
                self.popped = 0
                super().reset()

            def _pop_free(self, n):
                self.popped += n
                return super()._pop_free(n)
        return Counting


def _serve_both(reqs_fn, *, slots=2, bs=4, width=8, num_blocks=16,
                radix=True, chunk=None, counting=False):
    """Serve ``reqs_fn(Request class)`` through both Schedulers. Returns
    ((requests, stats, pool, radix, stub) reference, ... port)."""
    out = []
    for pool_cls, radix_cls, req_cls, stub_fn, run in (
            (JBlockPool, JRadixCache, JRequest, _jstub, jserve_continuous),
            (BlockPool, RadixCache, Request, _tstub, serve_continuous)):
        if counting:
            pool_cls = _CountingPools.wrap(pool_cls)
        m = stub_fn()
        pool = pool_cls(num_blocks, bs, slots, width)
        rc = radix_cls(bs) if radix else None
        reqs = reqs_fn(req_cls)
        kw = dict(batch_slots=slots, block_pool=pool, chunk_fn=m.chunk,
                  radix_cache=rc, prefill_chunk=chunk)
        if run is serve_continuous:
            kw["device"] = CPU
        stats = run(m.admit, m.decode, m.init_cache, reqs, **kw)
        out.append((reqs, stats, pool, rc, m))
    return out


def _assert_same_runs(ref, port, golden=True):
    (jreqs, jstats, jpool, jrc, jm), (treqs, tstats, tpool, trc, tm) = \
        ref, port
    for jr, tr in zip(jreqs, treqs):
        assert tr.done == jr.done
        assert tr.tokens_out == jr.tokens_out, tr.rid
        if golden:
            assert tr.tokens_out == _golden(tr.prompt,
                                            max(tr.max_new_tokens, 0))
    for field in STAT_FIELDS:
        assert getattr(tstats, field) == getattr(jstats, field), field
    for rid, lat in jstats.request_latency.items():
        assert vars(tstats.request_latency[rid]) == vars(lat), rid
    assert _pool_state(tpool) == _pool_state(jpool)
    assert tm.calls == jm.calls
    if jrc is not None:
        assert trc.n_nodes == jrc.n_nodes


def _check_drained(pool, rc):
    """After the drain: refcounts back to 0, free + cached partition the
    pool, every cached block backs one radix node."""
    assert pool.blocks_reserved == 0
    assert all(pool.block_ref(b) == 0 for b in range(pool.num_blocks))
    assert (pool.table == -1).all()
    free = list(pool._free)
    cached = [b for b in range(pool.num_blocks) if pool.is_cached(b)]
    assert len(free) == len(set(free))
    assert sorted(free + cached) == list(range(pool.num_blocks))
    assert pool.blocks_in_use == len(cached)
    if rc is not None:
        assert pool.blocks_cached == rc.n_nodes


_P0 = _cat(PREFIX8, np.full(4, 10))
GOLDEN_CASES = {
    # r0 misses and donates 2 prompt blocks; r1 and r2 hit them
    "prefix_hits_golden_and_stats": (
        lambda cls: _prefix_reqs(cls, [(10, 3), (10, 2), (12, 4)]),
        dict(slots=1)),
    # r1 (r0's prompt) capped at (12-1)//4 blocks, r2 matches all 3
    "match_cap_and_deeper_prefix": (
        lambda cls: [cls(rid=0, prompt=_P0, max_new_tokens=2),
                     cls(rid=1, prompt=_P0.copy(), max_new_tokens=3),
                     cls(rid=2, prompt=_cat(_P0, np.full(4, 20)),
                         max_new_tokens=2)], dict(slots=1)),
    # distinct prompts overflow a small pool: LRU eviction serves them
    "eviction_under_pool_pressure": (
        lambda cls: [cls(rid=i, prompt=np.full(8, 3 + i, np.int32),
                         max_new_tokens=2) for i in range(4)],
        dict(slots=1, num_blocks=6)),
    "shared_prefix_two_lanes": (
        lambda cls: _prefix_reqs(cls, [(9, 3), (10, 2), (12, 4), (9, 1),
                                       (11, 5)]), dict(slots=2)),
    "chunked_hits": (
        lambda cls: _prefix_reqs(cls, [(13, 2), (12, 3), (14, 1), (15, 4)]),
        dict(slots=2, chunk=3)),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_prefix_serving_matches_reference(case):
    reqs_fn, kw = GOLDEN_CASES[case]
    ref, port = _serve_both(reqs_fn, **kw)
    _assert_same_runs(ref, port)
    _check_drained(port[2], port[3])
    assert "admit" not in port[4].calls      # radix mode always chunks


def test_prefix_hits_count_as_the_reference_counts_them():
    ref, port = _serve_both(GOLDEN_CASES["prefix_hits_golden_and_stats"][0],
                            slots=1)
    stats = port[1]
    assert stats.prefix_hit_tokens == stats.prefill_tokens_saved == 16
    assert stats.prefix_hit_rate == pytest.approx(16 / 32)
    assert stats.shared_blocks == 2


def test_o_suffix_block_draws_match_reference():
    """Hit lanes draw fresh blocks for their novel suffix only."""
    def reqs(cls):
        return _prefix_reqs(cls, [(12, 2)] * 4)
    pops = []
    for radix in (False, True):
        ref, port = _serve_both(reqs, slots=1, radix=radix, counting=True)
        _assert_same_runs(ref, port)
        assert port[2].popped == ref[2].popped
        pops.append(port[2].popped)
    assert pops == [4 * 4, 4 + 3 * (4 - 2)]


def test_shared_equals_unshared_tokens():
    def reqs(cls):
        return _prefix_reqs(cls, [(9, 3), (10, 2), (12, 4), (9, 1), (11, 5)])
    shared = _serve_both(reqs, slots=2)
    plain = _serve_both(reqs, slots=2, radix=False)
    _assert_same_runs(*plain)
    for s, p in zip(shared[1][0], plain[1][0]):
        assert s.tokens_out == p.tokens_out
    assert shared[1][1].prefill_tokens_saved > 0


def _invalid(run, pool_cls, radix_cls, stub, reqs):
    calls = {
        "block_pool": dict(batch_slots=1, chunk_fn=stub.chunk,
                           radix_cache=radix_cls(4)),
        "chunk_fn": dict(batch_slots=1, block_pool=pool_cls(8, 4, 1, 8),
                         radix_cache=radix_cls(4)),
        "block_size": dict(batch_slots=1, block_pool=pool_cls(8, 4, 1, 8),
                           chunk_fn=stub.chunk, radix_cache=radix_cls(8)),
        "copy_block_fn": dict(batch_slots=1,
                              block_pool=pool_cls(8, 4, 1, 8),
                              chunk_fn=stub.chunk, radix_cache=radix_cls(4),
                              write_caps=[16, 32]),
        "lane capacity": dict(batch_slots=1,
                              block_pool=pool_cls(8, 4, 1, 8),
                              chunk_fn=stub.chunk, write_caps=[16, 64]),
        "paged serving": dict(batch_slots=1, write_caps=[16])}
    out = {}
    for what, kw in calls.items():
        with pytest.raises(ValueError) as e:
            run(stub.admit, stub.decode, stub.init_cache, reqs, **kw)
        out[what] = str(e.value)
        assert what in out[what]
    return out


def test_invalid_configs_raise_the_reference_errors():
    jm, tm = _jstub(), _tstub()
    want = _invalid(jserve_continuous, JBlockPool, JRadixCache, jm,
                    _prefix_reqs(JRequest, [(9, 1)]))
    got = _invalid(lambda *a, **k: serve_continuous(*a, device=CPU, **k),
                   BlockPool, RadixCache, tm, _prefix_reqs(Request, [(9, 1)]))
    assert got == want
    with pytest.raises(ValueError, match="continuous-scheduler"):
        serve(None, tm.decode, tm.init_cache, None,
              _prefix_reqs(Request, [(9, 1)]), scheduler="static",
              batch_slots=1, radix_cache=RadixCache(4), device=CPU)


@pytest.mark.parametrize("seed", range(15))
def test_conservation_sweep_matches_reference(seed):
    """Seeded workloads x prefix depths x pool sizes, chunked or not:
    both Schedulers agree, goldens hold, refcounts drain to zero and the
    free list and the cache partition the pool."""
    rng = np.random.RandomState(11 + seed)
    shared_len = int(rng.choice([0, 4, 8]))
    pre = rng.randint(1, 30, size=shared_len).astype(np.int32)
    n = rng.randint(1, 7)
    specs = [(shared_len + rng.randint(1, 6), rng.randint(0, 6))
             for _ in range(n)]
    slots = int(rng.randint(1, 4))
    blocks = int(rng.randint(8, 17))
    chunk = int(rng.randint(1, 6)) if rng.rand() < 0.5 else None

    def reqs(cls):
        return _prefix_reqs(cls, specs, shared=pre)
    shared = _serve_both(reqs, slots=slots, num_blocks=blocks, chunk=chunk)
    _assert_same_runs(*shared)
    plain = _serve_both(reqs, slots=slots, num_blocks=blocks, chunk=chunk,
                        radix=False)
    for s, p in zip(shared[1][0], plain[1][0]):
        assert s.tokens_out == p.tokens_out
    _check_drained(shared[1][2], shared[1][3])


def test_steady_decode_skips_the_table_upload_as_the_reference():
    """The table is uploaded after block growth and admission only; the
    decode steps between block boundaries see the same device table."""
    def reqs(cls):
        return [cls(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                    max_new_tokens=4),
                cls(rid=1, prompt=np.arange(1, 5, dtype=np.int32),
                    max_new_tokens=2)]
    ref, port = _serve_both(reqs, slots=1, num_blocks=4, width=4,
                            radix=False)
    _assert_same_runs(ref, port)

    def reuses(m):
        d = m.tables["decode"]
        return [a is b for a, b in zip(d, d[1:])]
    assert reuses(port[4]) == reuses(ref[4]) == [True, True, False]
    d = port[4].tables["decode"]
    assert len(d) == 4 and d[0] is d[1] is d[2] and d[3] is not d[0]


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:                # pragma: no cover - dev-only dependency
    _HAVE_HYPOTHESIS = False


def _conserved(specs, slots, blocks, shared_len):
    pre = np.arange(1, shared_len + 1, dtype=np.int32)

    def reqs(cls):
        return _prefix_reqs(cls, [(shared_len + n, q) for n, q in specs],
                            shared=pre)
    ref, port = _serve_both(reqs, slots=slots, num_blocks=blocks)
    _assert_same_runs(ref, port)
    for r in port[0]:
        assert r.done
    _check_drained(port[2], port[3])


def _cow_never_remaps(k, extra, cols):
    """Both pools: the swapped-in block is fresh, the cached source never
    re-enters the lane's table, refcounts stay conserved."""
    pools = []
    for cls in (JBlockPool, BlockPool):
        pool = cls(2 * k + extra + 2, 4, 2, 2 * k + 2)
        assert pool.reserve_and_alloc(0, k, k)
        shared = [int(b) for b in pool.lane_blocks(0)]
        for b in shared:
            pool.set_cached(b)
        pool.free_lane(0)
        assert pool.map_shared(1, shared, n_alloc=extra,
                               n_reserve=extra + k, n_cols=2 * k + 2)
        for swapped, col in enumerate(cols, 1):
            src, dst = pool.cow(1, col)
            assert src == shared[col] and dst not in shared
            assert pool.lane_shared(1) == k - swapped
            assert pool.cow(1, col) is None
            assert src not in [int(b) for b in pool.lane_blocks(1)]
            assert pool.is_cached(src)
        assert all(pool.block_ref(b) == 0 for b in shared)
        pool.free_lane(1)
        _check_drained(pool, None)
        assert pool.blocks_cached == k
        pools.append(_pool_state(pool))
    assert pools[0] == pools[1]


if _HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None)
    @given(st.lists(st.tuples(st.integers(1, 5), st.integers(0, 6)),
                    min_size=1, max_size=8),
           st.integers(1, 3), st.integers(8, 16), st.sampled_from([0, 4, 8]))
    def test_refcounts_conserved_no_freelist_leak(specs, slots, blocks,
                                                  shared_len):
        _conserved(specs, slots, blocks, shared_len)

    @settings(max_examples=40, deadline=None)
    @given(st.integers(1, 3), st.integers(0, 2), st.data())
    def test_cow_never_remaps_shared_source(k, extra, data):
        _cow_never_remaps(k, extra,
                          data.draw(st.permutations(list(range(k)))))
else:                              # pragma: no cover - seeded stand-ins
    @pytest.mark.parametrize("seed", range(8))
    def test_refcounts_conserved_no_freelist_leak(seed):
        rng = np.random.RandomState(seed)
        specs = [(int(rng.randint(1, 6)), int(rng.randint(0, 7)))
                 for _ in range(int(rng.randint(1, 9)))]
        _conserved(specs, int(rng.randint(1, 4)), int(rng.randint(8, 17)),
                   int(rng.choice([0, 4, 8])))

    @pytest.mark.parametrize("k,extra", [(1, 0), (2, 1), (3, 2)])
    def test_cow_never_remaps_shared_source(k, extra):
        _cow_never_remaps(k, extra, list(range(k))[::-1])
