"""Over-commit admission, lane preemption, priority tiers and
``decode_ratio`` in the port against the reference.

* Stub-model cases of ``tests/test_preemption.py`` (``TestQueueWait``,
  ``TestTrackPoolFirstPeak``, ``TestZeroQuota``, ``TestOverCommitGolden``,
  ``TestPriorityTiers``, ``TestDecodeRatio``, ``TestDeadlockGuard`` and the
  seeded ``TestPreemptionRadixConservation`` sweep): the same specs go
  through both packages' continuous Schedulers, which must give the same
  tokens, ``ServeStats`` (latencies and tiers included), pool state and
  call sequence of the stub's steps; the reference test's own assertions
  then hold for the port.
* ``BlockPool.try_grow`` and ``cow(extend=True)`` against the reference's
  pool on seeded sequences of operations.
* The swap steps' gather and scatter on CPU arenas of every paged cache
  type against the reference's, bit for bit, with padded ids that leave
  the other blocks untouched.
* The reduced gemma2-2b (the reference's params through ``convert``),
  preempted against unpreempted in drop and swap modes at kv16 f32 and on
  the deploy path at kv8, and the launcher's runs A and B with
  ``--parity``: the reference launcher's counts, over-commit note, tier
  lines and four parity lines.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.runtime import BlockPool as JBlockPool
from repro.runtime import RadixCache as JRadixCache
from repro.runtime import Request as JRequest
from repro.runtime import blocks_for_tokens
from repro.runtime import serve_continuous as jserve_continuous
from repro.runtime.serve_loop import ServeStats as JServeStats
from repro.runtime.serve_loop import _Book as JBook
from repro_torch.configs import get_config
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy, ptq
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, RadixCache, Request,
                                 make_admit_step, make_chunk_prefill_step,
                                 make_decode_step, make_swap_steps, serve,
                                 serve_continuous)
from repro_torch.runtime.serve_loop import ServeStats, _Book

pytestmark = [pytest.mark.serve, pytest.mark.preempt, pytest.mark.paged]

VOCAB = 32
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    faster than a pool, and a pool's threads, oversubscribed by parallel
    test workers, slow them down by tens of times. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(prompt, n):
    out, tok = [], int(prompt[-1])
    for _ in range(n):
        tok = (2 * tok + 1) % VOCAB
        out.append(tok)
    return out


class _OCStub:
    """The reference test's OCStub: next token (2 * tok + 1) % VOCAB as
    one-hot logits, position-free; swap steps carry a dummy payload. Records
    every step call."""

    def __init__(self, zeros, onehot):
        self.zeros, self.onehot = zeros, onehot
        self.calls = []

    def init_cache(self, batch):
        return {"kv": self.zeros((batch, 4))}

    def _step(self, kind, tokens, cache):
        self.calls.append(kind)
        return self.onehot((2 * np.asarray(tokens) + 1) % VOCAB), cache

    def admit(self, tokens, positions, admit_mask, cache):
        return self._step("admit", tokens, cache)

    def chunk(self, tokens, positions, reset_mask, cache):
        return self._step("chunk", tokens, cache)

    def decode(self, tokens, pos, cache):
        return self._step("decode", tokens, cache)

    def swap_out(self, cache, ids):
        self.calls.append("swap_out")
        return {"blocks": self.zeros((len(ids), 1))}

    def swap_in(self, cache, ids, payload):
        self.calls.append("swap_in")
        return cache


def _jstub():
    return _OCStub(lambda s: jnp.zeros(s, jnp.float32),
                   lambda t: jnp.eye(VOCAB, dtype=jnp.float32)[
                       jnp.asarray(t) % VOCAB])


def _tstub():
    return _OCStub(lambda s: torch.zeros(s),
                   lambda t: torch.nn.functional.one_hot(
                       torch.as_tensor(t).long() % VOCAB, VOCAB).float())


def _reqs(cls, specs, priorities=None):
    """Distinct prompts (the head token varies per rid) of (prompt_len,
    quota), with optional priority tiers."""
    pri = priorities or [0] * len(specs)
    return [cls(rid=i, prompt=np.full(n, 3 + i, np.int32),
                max_new_tokens=q, priority=p)
            for i, ((n, q), p) in enumerate(zip(specs, pri))]


def _shared_reqs(cls, specs, shared):
    return [cls(rid=i, prompt=np.concatenate(
        [shared, np.full(n - len(shared), 10 + i, np.int32)]),
        max_new_tokens=q) for i, (n, q) in enumerate(specs)]


# the reference test's pool subclasses, for either package's pool

def _stingy(cls):
    """Passes the up-front capacity check but never supplies a block."""
    class Stingy(cls):
        def available_blocks(self):
            return 0
    return Stingy


def _checked(cls):
    """Asserts on every free-list draw that the block really is free:
    unmapped everywhere, not cached, refcount 0."""
    class Checked(cls):
        def _pop_free(self, n):
            blocks = super()._pop_free(n)
            mapped = {int(b) for b in self.table.ravel() if b >= 0}
            for b in blocks:
                assert b not in mapped, f"block {b} drawn while mapped"
                assert not self.is_cached(b), f"block {b} drawn while cached"
                assert self.block_ref(b) == 0, f"block {b} drawn with refs"
            return blocks
    return Checked


_PACKAGES = (
    (JBlockPool, JRadixCache, JRequest, _jstub, jserve_continuous, {}),
    (BlockPool, RadixCache, Request, _tstub, serve_continuous,
     {"device": CPU}))


def _serve_both(reqs_fn, *, slots=2, bs=4, width=8, num_blocks=8,
                swap=False, radix=False, prefill_chunk=4, decode_ratio=1,
                over_commit=True, paged=True, pool_wrap=None):
    """Serve ``reqs_fn(Request class)`` through the reference's and the
    port's Scheduler with the reference test's ``_serve_oc`` settings.
    Returns [(requests, stats, pool, radix, stub)] for (reference, port);
    ``paged=False`` serves without a pool (over_commit then off)."""
    out = []
    for pool_cls, radix_cls, req_cls, stub_fn, run, extra in _PACKAGES:
        m = stub_fn()
        pool = rc = None
        if paged:
            pool = (pool_wrap(pool_cls) if pool_wrap else pool_cls)(
                num_blocks, bs, slots, width)
            rc = radix_cls(bs) if radix else None
        reqs = reqs_fn(req_cls)
        stats = run(m.admit, m.decode, m.init_cache, reqs, batch_slots=slots,
                    block_pool=pool, chunk_fn=m.chunk,
                    prefill_chunk=prefill_chunk, radix_cache=rc,
                    over_commit=over_commit and paged,
                    swap_out_fn=m.swap_out if swap else None,
                    swap_in_fn=m.swap_in if swap else None,
                    decode_ratio=decode_ratio, **extra)
        out.append((reqs, stats, pool, rc, m))
    return out


def _stats(stats):
    d = dataclasses.asdict(stats)
    d.pop("wall_s"), d.pop("tokens_per_s")
    return d


def _pool_state(pool):
    return dict(table=pool.table.tolist(), free=list(pool._free),
                ref=pool._ref.tolist(), cached=pool._cached.tolist(),
                reserved=pool._reserved.tolist(),
                shared=pool._n_shared.tolist(),
                mapped=pool._n_mapped.tolist(), dirty=pool.dirty,
                gauges=[pool.blocks_in_use, pool.blocks_reserved,
                        pool.blocks_cached, pool.blocks_pinned,
                        pool.available_blocks(), pool.refcount_total])


def _same(runs):
    """The port's run equals the reference's: tokens, every ServeStats
    field but the walls, the drained pool and the stub's call sequence.
    Returns the port's (requests, stats, pool, radix, stub)."""
    (jreqs, jstats, jpool, jrc, jm), port = runs
    treqs, tstats, tpool, trc, tm = port
    for jr, tr in zip(jreqs, treqs):
        assert (tr.tokens_out, tr.done) == (jr.tokens_out, jr.done), tr.rid
    assert _stats(tstats) == _stats(jstats)
    assert tm.calls == jm.calls
    if jpool is not None:
        assert _pool_state(tpool) == _pool_state(jpool)
    if jrc is not None:
        assert trc.n_nodes == jrc.n_nodes
    return port


def _drained(pool, rc=None):
    """After the drain: refcounts back to 0, free + cached partition the
    pool (the reference test's _drained)."""
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


# ---------------------------------------------------------------------------
# Queue-wait accounting, the first-peak sample, zero-quota requests
# ---------------------------------------------------------------------------

QUEUE_WAIT = {
    # two lanes fill the pool under worst-case reservations: the third
    # request waits at the head until a lane retires
    "backpressure_accrues_queue_wait": (
        [(4, 5)] * 3, dict(slots=2, width=4, num_blocks=4,
                           over_commit=False)),
    "unpressured_requests_wait_zero": (
        [(4, 2), (4, 2)], dict(slots=2, num_blocks=8, over_commit=False)),
    "legacy_stats_stay_zero_without_over_commit": (
        [(4, 3)] * 3, dict(slots=2, width=4, num_blocks=4,
                           over_commit=False)),
}


@pytest.mark.parametrize("case", sorted(QUEUE_WAIT))
def test_queue_wait_matches_reference(case):
    specs, kw = QUEUE_WAIT[case]
    reqs, stats, _, _, _ = _same(_serve_both(
        lambda cls: _reqs(cls, specs), **kw))
    lat = stats.request_latency
    for r in reqs:
        assert r.tokens_out == _golden(r.prompt, r.max_new_tokens)
    assert stats.queue_wait_steps == sum(
        v.queue_wait_steps for v in lat.values())
    assert (stats.preemptions, stats.swapped_blocks,
            stats.recomputed_tokens) == (0, 0, 0)
    if case == "backpressure_accrues_queue_wait":
        assert lat[0].queue_wait_steps == lat[1].queue_wait_steps == 0
        assert lat[2].queue_wait_steps == (lat[2].admit_step
                                           - lat[2].enqueue_step) > 0
    elif case == "unpressured_requests_wait_zero":
        for v in lat.values():
            assert v.queue_wait_steps == 0
            assert v.admit_step == v.enqueue_step == 0


class _FakePool:
    def __init__(self):
        self.blocks_in_use, self.shared_blocks, self.frag = 0, 0, 0.0

    def fragmentation(self, live_tokens):
        return self.frag


def test_track_pool_keeps_the_first_peak_sample():
    """A later peak of the same height does not overwrite the first
    sample's fragmentation; a higher one does — in both _Books."""
    seen = []
    for book_cls, stats_cls in ((JBook, JServeStats), (_Book, ServeStats)):
        stats = stats_cls()
        book, pool = book_cls(stats, 2), _FakePool()
        trace = []
        for used, frag, live in ((4, 0.25, 10), (4, 0.9, 2), (6, 0.5, 20)):
            pool.blocks_in_use, pool.frag = used, frag
            book.track_pool(pool, live, 1)
            trace.append((stats.blocks_in_use, stats.block_fragmentation,
                          stats.cache_bytes))
        seen.append(trace)
    assert seen[1] == seen[0] == [(4, 0.25, 4), (4, 0.25, 4), (6, 0.5, 6)]


ZERO_QUOTA = {
    "zero_quota_mixed_into_over_commit_run": (
        [(4, 3), (4, 0), (4, 2), (3, 0)], dict(slots=2, num_blocks=6)),
    "all_zero_quota_finalizes_empty": (
        [(4, 0), (2, 0)], dict(slots=1, num_blocks=4)),
}


@pytest.mark.parametrize("case", sorted(ZERO_QUOTA))
def test_zero_quota_matches_reference(case):
    specs, kw = ZERO_QUOTA[case]
    reqs, stats, pool, _, _ = _same(_serve_both(
        lambda cls: _reqs(cls, specs), **kw))
    for r in reqs:
        assert r.done and r.tokens_out == _golden(r.prompt,
                                                  r.max_new_tokens)
    live = {r.rid for r in reqs if r.max_new_tokens > 0}
    assert set(stats.request_latency) == live
    assert set(stats.tier_latency) == ({0} if live else set())
    if live:
        assert stats.tier_latency[0].requests == len(live)
        _drained(pool)
    assert stats.tokens_generated == sum(r.max_new_tokens for r in reqs)


# ---------------------------------------------------------------------------
# Golden over-commit serving: drop and swap preemption, tiers, pacing
# ---------------------------------------------------------------------------

# four requests, each worst case 4 blocks of 4: a 6-block pool is below
# two lanes' combined demand, so growth must preempt
_OC_SPECS = [(4, 12)] * 4

_TIGHT = [(5, 9), (4, 11), (6, 7), (3, 10), (4, 8)]
# (specs, priorities, serving settings, whether it must preempt)
OVER_COMMIT = {
    "drop_mode_preempts_and_recomputes": (
        _OC_SPECS, None, dict(slots=2, num_blocks=6), True),
    "swap_mode_preempts_without_recompute": (
        _OC_SPECS, None, dict(slots=2, num_blocks=6, swap=True), True),
    # summed worst cases (2 + 3 blocks) exceed the 4-block pool, but the
    # instantaneous demand never does: both lanes run, nothing preempted
    "over_commit_admits_beyond_worst_case": (
        [(4, 2), (4, 6)], None, dict(slots=2, num_blocks=4), False),
    "worst_case_baseline_serializes": (
        [(4, 2), (4, 6)], None, dict(slots=2, num_blocks=4,
                                     over_commit=False), False),
    "tight_drop": (_TIGHT, None, dict(slots=2, num_blocks=5), True),
    "tight_swap": (_TIGHT, None, dict(slots=2, num_blocks=5, swap=True),
                   True),
    "roomy": (_TIGHT, None, dict(slots=2, num_blocks=16), False),
    "high_tier_jumps_fifo_queue": (
        [(4, 3), (4, 3)], [0, 1], dict(slots=1, num_blocks=8), False),
    "fifo_ignores_priority_without_over_commit": (
        [(4, 3), (4, 3)], [0, 1], dict(slots=1, num_blocks=8,
                                       over_commit=False), False),
    "growth_preempts_lowest_tier_first": (
        [(4, 16), (4, 8), (4, 8), (4, 8)], [1, 0, 0, 0],
        dict(slots=2, num_blocks=6), True),
    "growth_preempts_lowest_tier_first_swap": (
        [(4, 16), (4, 8), (4, 8), (4, 8)], [1, 0, 0, 0],
        dict(slots=2, num_blocks=6, swap=True), True),
}


@pytest.mark.parametrize("case", sorted(OVER_COMMIT))
def test_over_commit_serving_matches_reference(case):
    specs, pri, kw, tight = OVER_COMMIT[case]
    reqs, stats, pool, _, m = _same(_serve_both(
        lambda cls: _reqs(cls, specs, pri), **kw))
    for r in reqs:
        assert r.done and r.tokens_out == _golden(r.prompt,
                                                  r.max_new_tokens)
    _drained(pool)
    lat = stats.request_latency
    assert (stats.preemptions > 0) == tight, stats.preemptions
    if tight and kw.get("swap"):
        assert stats.swapped_blocks > 0 and stats.recomputed_tokens == 0
        assert "swap_out" in m.calls and "swap_in" in m.calls
    elif tight:
        assert stats.recomputed_tokens > 0 and stats.swapped_blocks == 0
    if case.startswith("drop_mode") or case.startswith("swap_mode"):
        assert lat[0].queue_wait_steps == 0      # oldest never evicted
        assert stats.queue_wait_steps > 0
    if case == "over_commit_admits_beyond_worst_case":
        assert lat[0].admit_step == lat[1].admit_step == 0
    if case == "worst_case_baseline_serializes":
        assert lat[1].admit_step > 0
    if case == "high_tier_jumps_fifo_queue":
        assert lat[1].admit_step == 0 and lat[1].queue_wait_steps == 0
        assert lat[0].admit_step > 0 and lat[0].queue_wait_steps > 0
        assert stats.tier_latency[1].first_token_p50 \
            < stats.tier_latency[0].first_token_p50
    if case == "fifo_ignores_priority_without_over_commit":
        assert lat[0].admit_step == 0 and lat[1].admit_step > 0
    if case.startswith("growth_preempts"):
        assert lat[0].queue_wait_steps == 0      # tier 1: never preempted
        assert any(lat[i].queue_wait_steps > 0 for i in (1, 2, 3))
        assert (stats.tier_latency[1].requests,
                stats.tier_latency[0].requests) == (1, 3)
        assert stats.tier_latency[1].first_token_p99 \
            <= stats.tier_latency[0].first_token_p99


def test_preempted_equals_unpreempted_on_the_stub():
    specs = [(5, 9), (4, 11), (6, 7), (3, 10), (4, 8)]
    roomy = _serve_both(lambda cls: _reqs(cls, specs), slots=2,
                        num_blocks=16)[1][0]
    for swap in (False, True):
        tight = _serve_both(lambda cls: _reqs(cls, specs), slots=2,
                            num_blocks=5, swap=swap)[1][0]
        for t, r in zip(tight, roomy):
            assert t.tokens_out == r.tokens_out, (swap, t.rid)


DECODE_RATIO = {
    "ratio_two_interleaves_two_decodes_per_chunk": (
        lambda cls: [cls(rid=0, prompt=np.asarray([3]), max_new_tokens=8),
                     cls(rid=1, prompt=np.asarray([5] * 12),
                         max_new_tokens=2)], 2),
    "ratio_one_is_legacy_interleave": (
        lambda cls: [cls(rid=i, prompt=np.full(n, 4 + i, np.int32),
                         max_new_tokens=q)
                     for i, (n, q) in enumerate([(1, 8), (12, 2)])], 1),
    "ratio_three_over_commit": (
        lambda cls: _reqs(cls, _OC_SPECS), 3),
}


@pytest.mark.parametrize("case", sorted(DECODE_RATIO))
def test_decode_ratio_matches_reference(case):
    reqs_fn, ratio = DECODE_RATIO[case]
    over = case.endswith("over_commit")
    reqs, _, _, _, m = _same(_serve_both(
        reqs_fn, slots=2, prefill_chunk=3 if not over else 4,
        decode_ratio=ratio, paged=over, num_blocks=6))
    for r in reqs:
        assert r.tokens_out == _golden(r.prompt, r.max_new_tokens)
    if ratio == 2:
        assert m.calls[:9] == ["chunk", "decode", "decode"] * 3


def _invalid_runs(run, stub, pool_cls, reqs):
    """The reference test's invalid configurations: the error each one
    raises (type and message)."""
    m = stub()
    cases = [dict(chunk_fn=m.chunk, decode_ratio=0),
             dict(decode_ratio=2),
             dict(chunk_fn=m.chunk, over_commit=True),
             dict(block_pool=pool_cls(8, 4, 1, 8), over_commit=True),
             dict(block_pool=pool_cls(8, 4, 1, 8), chunk_fn=m.chunk,
                  over_commit=True, swap_out_fn=m.swap_out),
             dict(block_pool=pool_cls(8, 4, 1, 8), chunk_fn=m.chunk,
                  swap_out_fn=m.swap_out, swap_in_fn=m.swap_in)]
    out = []
    for kw in cases:
        with pytest.raises(ValueError) as e:
            run(m.admit, m.decode, m.init_cache, reqs(), batch_slots=1, **kw)
        out.append(str(e.value))
    return out


def test_invalid_configs_raise_the_reference_errors():
    want = _invalid_runs(jserve_continuous, _jstub, JBlockPool,
                         lambda: _reqs(JRequest, [(4, 1)]))
    got = _invalid_runs(serve_continuous, _tstub, BlockPool,
                        lambda: _reqs(Request, [(4, 1)]))
    assert got == want
    for pat, msg in zip(("decode_ratio", "chunk_fn", "block_pool",
                         "chunk_fn", "pair", "over_commit"), got):
        assert pat in msg


def test_unseatable_queue_raises_the_deadlock_guard():
    for pool_cls, _, req_cls, stub, run, extra in _PACKAGES:
        m = stub()
        with pytest.raises(RuntimeError, match="deadlock"):
            run(m.admit, m.decode, m.init_cache, _reqs(req_cls, [(4, 2)]),
                batch_slots=1, block_pool=_stingy(pool_cls)(8, 4, 1, 8),
                chunk_fn=m.chunk, prefill_chunk=4, over_commit=True,
                **extra)


# ---------------------------------------------------------------------------
# Radix eviction racing preemption
# ---------------------------------------------------------------------------

def _preempt_radix(specs, slots, num_blocks, shared_len, swap=False):
    pre = np.arange(1, shared_len + 1, dtype=np.int32)
    reqs, stats, pool, rc, _ = _same(_serve_both(
        lambda cls: _shared_reqs(cls, [(shared_len + n, q)
                                       for n, q in specs], pre),
        slots=slots, num_blocks=num_blocks, radix=True, swap=swap,
        pool_wrap=_checked))
    for r in reqs:
        assert r.done and r.tokens_out == _golden(r.prompt,
                                                  r.max_new_tokens)
    _drained(pool, rc)
    return stats


@pytest.mark.parametrize("swap", [False, True])
def test_preemption_radix_sweep_matches_reference(swap):
    """The reference's seeded sweep (pools barely above the one-request
    worst case: preemption interleaves with LRU eviction and drop-mode
    donation) through both Schedulers; in swap mode too."""
    rng = np.random.RandomState(7)
    preempted = 0
    for _ in range(12):
        shared_len = int(rng.choice([0, 4, 8]))
        n = rng.randint(2, 6)
        specs = [(rng.randint(1, 6), rng.randint(1, 10)) for _ in range(n)]
        worst = max(blocks_for_tokens(shared_len + p + q - 1, 4)
                    for p, q in specs)
        slots = rng.randint(1, 4)
        blocks = worst + rng.randint(0, 3)
        preempted += _preempt_radix(specs, slots, blocks, shared_len,
                                    swap).preemptions
    assert preempted > 0


def test_preemption_with_prefix_hits_recomputes_suffix_only():
    stats = _preempt_radix([(4, 8)] * 3, 2, 7, 8)
    assert stats.preemptions > 0 and stats.prefix_hit_tokens > 0


# ---------------------------------------------------------------------------
# try_grow and cow(extend=True) against the reference's pool
# ---------------------------------------------------------------------------

def _pool_ops(seed, n_ops=60):
    """A seeded script over a 10-block pool of 3 lanes (table width 5) with
    a radix cache: admissions, on-demand growth past the reservation,
    donations, shared mappings and copy-on-write that extends the
    reservation."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        lane = int(rng.randint(3))
        kind = rng.choice(["alloc", "try_grow", "try_grow", "cow", "free",
                           "donate", "map_shared"])
        if kind == "alloc":
            n = int(rng.randint(0, 3))
            ops.append(("reserve_and_alloc", (lane, n, n)))
        elif kind == "try_grow":
            ops.append(("try_grow", (lane, int(rng.randint(0, 7)))))
        elif kind == "cow":
            ops.append(("cow", (lane, int(rng.randint(0, 5)), True)))
        elif kind == "free":
            ops.append(("free_lane", (lane,)))
        elif kind == "donate":
            ops.append(("donate", (lane, int(rng.randint(0, 3)))))
        else:
            ops.append(("map_shared", (lane, int(rng.randint(1, 3)),
                                       int(rng.randint(0, 2)))))
    return ops


def _pool_call(pool, rc, name, args):
    if name == "donate":
        lane, n = args
        blocks = [int(b) for b in pool.lane_blocks(lane)[:n]]
        if blocks:
            toks = np.repeat(np.arange(len(blocks)), 4) + 100 * lane
            for b in rc.insert(toks, blocks):
                pool.set_cached(b, True)
        return pool.free_lane(lane)
    if name == "map_shared":
        lane, k, n_alloc = args
        blocks, _ = rc.match(np.repeat(np.arange(k), 4) + 100 * (lane % 2))
        if pool.lane_mapped(lane) or not blocks:
            return None
        return pool.map_shared(lane, blocks, n_alloc, n_alloc,
                               n_cols=len(blocks) + n_alloc)
    if name == "reserve_and_alloc" and pool.lane_mapped(args[0]):
        return None
    try:
        return getattr(pool, name)(*args)
    except RuntimeError as e:
        return ("RuntimeError", str(e))


@pytest.mark.parametrize("seed", range(4))
def test_try_grow_and_cow_extend_match_reference(seed):
    jpool, tpool = JBlockPool(10, 4, 3, 5), BlockPool(10, 4, 3, 5)
    jrc, trc = JRadixCache(4), RadixCache(4)
    jpool.attach_cache(jrc)
    tpool.attach_cache(trc)
    grown = 0
    for name, args in _pool_ops(seed):
        before = int(tpool._reserved[args[0]])
        want = _pool_call(jpool, jrc, name, args)
        got = _pool_call(tpool, trc, name, args)
        assert got == want, (name, args)
        assert _pool_state(tpool) == _pool_state(jpool), (name, args)
        assert trc.n_nodes == jrc.n_nodes
        grown += name == "try_grow" and got is True \
            and int(tpool._reserved[args[0]]) > before
    assert grown > 0


def test_cow_extend_grows_the_reservation_instead_of_raising():
    """A shared column past the reservation: cow raises the reference's
    error, cow(extend=True) swaps in a private block and grows the
    reservation, in both pools."""
    for pool_cls, radix_cls in ((JBlockPool, JRadixCache),
                                (BlockPool, RadixCache)):
        pool, rc = pool_cls(8, 4, 2, 6), radix_cls(4)
        pool.attach_cache(rc)
        pool.reserve_and_alloc(0, 2, 2)
        for b in rc.insert(np.arange(8), [int(b) for b in
                                          pool.lane_blocks(0)]):
            pool.set_cached(b, True)
        pool.free_lane(0)
        blocks, _ = rc.match(np.arange(8))
        assert pool.map_shared(1, blocks, 1, 1, n_cols=3)
        with pytest.raises(RuntimeError, match="exceeds its reservation"):
            pool.cow(1, 0)
        src, dst = pool.cow(1, 0, extend=True)
        assert (src, int(pool.table[1, 0])) == (blocks[0], dst)
        assert int(pool._reserved[1]) == 2 and pool.lane_shared(1) == 1


# ---------------------------------------------------------------------------
# The swap steps' gather and scatter against the reference's
# ---------------------------------------------------------------------------

MAX_LEN, BS = 32, 8


@pytest.fixture(scope="module")
def cfgs():
    return (jget_config("gemma2-2b").reduced(),
            get_config("gemma2-2b").reduced())


def _filled(jcfg, kv_bits, stacked, seed, num_blocks=12):
    rng = np.random.RandomState(seed)
    jc = jtfm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32,
                         kv_bits=kv_bits, paged=True, block_size=BS,
                         num_blocks=num_blocks, stacked=stacked)
    return jax.tree.map(lambda x: jnp.asarray(
        (rng.randn(*x.shape) * 50).astype(x.dtype)), jc)


def _leaves(tc):
    """(tensor, block axis) of every paged arena leaf."""
    return [(x, 1 if key == "scan" else 0)
            for key in ("layers", "scan", "tail") for n in tc.get(key, [])
            for x in n]


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("stacked", [True, False])
def test_swap_round_trip_matches_reference(cfgs, kv_bits, stacked):
    """Gather blocks (5, 2, 9) from one seeded arena and scatter them into
    blocks (1, 7, 3) of another: the payload equals the reference's live
    rows and keeps the arena types (int4 stays PagedQuant4KVCache); the
    scatter writes in place, gives the reference's cache bit for bit, and
    with ids padded by repeating the first (payload rows repeated alike)
    leaves every other block as it was."""
    jcfg, _ = cfgs
    live, new = [5, 2, 9], [1, 7, 3]
    jsrc, jdst = (_filled(jcfg, kv_bits, stacked, kv_bits + s)
                  for s in (0, 1))
    src, dst = (caches_from_jax(jax.tree.map(np.asarray, c), CPU)
                for c in (jsrc, jdst))
    swap_out, swap_in = make_swap_steps()
    jpad = np.full((6,), 12, np.int32)
    jpad[:3] = live
    jpayload = jtfm.cache_gather_blocks(jsrc, jpad)
    payload = swap_out(src, torch.tensor(live))
    assert set(payload) == set(jpayload)
    for key in payload:
        for node, jnode, snode in zip(payload[key], jpayload[key],
                                      src[key]):
            assert type(node) is type(snode)
            axis = 1 if key == "scan" else 0
            for x, jx in zip(node, jnode):
                want = np.take(np.asarray(jx), range(3), axis=axis)
                np.testing.assert_array_equal(x.numpy(), want)
    jpad[:3] = new
    jout = jtfm.cache_scatter_blocks(jdst, jpad, jpayload)
    assert swap_in(dst, torch.tensor(new), payload) is dst
    for a, (b, _) in zip(jax.tree.leaves({k: jout[k] for k in payload}),
                         _leaves(dst)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # padded by repetition: the same bytes, and the rest untouched
    pdst = caches_from_jax(jax.tree.map(np.asarray, jdst), CPU)
    before = [x.clone() for x, _ in _leaves(pdst)]
    padded = swap_out(src, torch.tensor(live + [live[0]] * 3))
    swap_in(pdst, torch.tensor(new + [new[0]] * 3), padded)
    keep = torch.tensor([b for b in range(12) if b not in new])
    for (x, axis), (y, _), x0 in zip(_leaves(pdst), _leaves(dst), before):
        assert torch.equal(x, y)
        assert torch.equal(x.index_select(axis, keep),
                           x0.index_select(axis, keep))
        assert not torch.equal(x, x0)


def test_gather_and_scatter_reject_dense_caches(cfgs):
    jcfg, cfg = cfgs
    dense = tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32, kv_bits=8,
                           device=CPU)
    jdense = jtfm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32, kv_bits=8)
    nodes = {k: [None] * len(v) for k, v in jdense.items()}
    for fn, jfn, args in (
            (tfm.cache_gather_blocks, jtfm.cache_gather_blocks, ()),
            (tfm.cache_scatter_blocks, jtfm.cache_scatter_blocks, (nodes,))):
        with pytest.raises(ValueError) as want:
            jfn(jdense, jnp.zeros((1,), jnp.int32), *args)
        with pytest.raises(ValueError) as got:
            fn(dense, torch.zeros(1, dtype=torch.long), *args)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The reduced gemma2-2b, preempted against unpreempted
# ---------------------------------------------------------------------------

# 4 requests of up to 22 cells: 3 blocks of 8 a lane, so a 4-block pool is
# below two lanes' demand (6) and must preempt (the reference test's specs)
SPEC_OC = [(10, 12), (9, 12), (11, 10), (10, 11)]


@pytest.fixture(scope="module")
def models(cfgs):
    """The reference's reduced f32 params carried across, and the port's
    deploy path (PTQ with PEG, packed int8 weights) built on them."""
    jcfg, cfg = cfgs
    key = jax.random.PRNGKey(0)
    stacked = params_from_jax(jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, key, stacked=True, dtype=jnp.float32)), CPU)
    flat = params_from_jax(jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, key, stacked=False, dtype=jnp.float32)), CPU)
    rng = np.random.RandomState(10)
    calib = [{"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                                    (2, 8)))}]
    qm = ptq(lambda p, b, c: tfm.forward(cfg, p, b["tokens"], ctx=c)[0],
             flat, calib, peg_policy(4), collect_inputs=True)
    shared = {}
    for site, qp in qm.act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        shared.setdefault(base, qp)
    packed, acts = build_deploy(cfg, stacked, peg_policy(4), shared)

    def ctx():
        return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                        act_state=shared, deploy_acts=acts)
    return {"float": (stacked, None), "deploy": (packed, ctx)}


def _serve_real(cfg, params, ctx, kv_bits, *, num_blocks=None, swap=False,
                over_commit=True, slots=2, priorities=None):
    width = tfm.paged_lane_blocks(cfg, MAX_LEN, BS)
    num_blocks = num_blocks or slots * width
    pool = BlockPool(num_blocks, BS, slots, width)
    rng = np.random.RandomState(3)
    pri = priorities or [0] * len(SPEC_OC)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, size=n),
                    max_new_tokens=q, priority=p)
            for i, ((n, q), p) in enumerate(zip(SPEC_OC, pri))]
    so, si = make_swap_steps() if swap else (None, None)
    stats = serve(None, make_decode_step(cfg, ctx_factory=ctx),
                  lambda b: tfm.init_cache(
                      cfg, b, MAX_LEN, dtype=torch.float32, kv_bits=kv_bits,
                      paged=True, block_size=BS, num_blocks=num_blocks,
                      mapped=False, device=CPU),
                  params, reqs, scheduler="continuous", batch_slots=slots,
                  max_len=MAX_LEN,
                  admit_step=make_admit_step(cfg, ctx_factory=ctx),
                  chunk_step=make_chunk_prefill_step(cfg, ctx_factory=ctx),
                  block_pool=pool, prefill_chunk=BS,
                  over_commit=over_commit, swap_out_fn=so, swap_in_fn=si,
                  write_caps=tfm.attn_write_caps(cfg, MAX_LEN, BS),
                  ring_tokens=tfm.paged_ring_tokens(cfg, MAX_LEN, BS),
                  device=CPU)
    return reqs, stats, pool


@pytest.mark.parametrize("mode,kv_bits", [("float", 16), ("deploy", 8)])
@pytest.mark.parametrize("swap", [False, True])
def test_preempted_equals_unpreempted_real_model(cfgs, models, mode,
                                                 kv_bits, swap):
    """Over-commit on a 4-block pool preempts (swap mode moves blocks and
    recomputes nothing, drop mode recomputes) and emits the greedy tokens
    of worst-case reservations, token for token."""
    _, cfg = cfgs
    params, ctx = models[mode]
    base, bstats, _ = _serve_real(cfg, params, ctx, kv_bits,
                                  over_commit=False)
    reqs, stats, pool = _serve_real(cfg, params, ctx, kv_bits,
                                    num_blocks=4, swap=swap)
    assert stats.preemptions > 0 and bstats.preemptions == 0
    if swap:
        assert stats.swapped_blocks > 0 and stats.recomputed_tokens == 0
    else:
        assert stats.recomputed_tokens > 0 and stats.swapped_blocks == 0
    for b, r in zip(base, reqs):
        assert r.done and r.tokens_out == b.tokens_out, (mode, swap, r.rid)
    assert pool.blocks_reserved == 0


def test_priority_tiers_real_model(cfgs, models):
    _, cfg = cfgs
    params, ctx = models["deploy"]
    base, _, _ = _serve_real(cfg, params, ctx, 8, over_commit=False,
                             priorities=[1, 0, 0, 0])
    reqs, stats, _ = _serve_real(cfg, params, ctx, 8, num_blocks=4,
                                 swap=True, priorities=[1, 0, 0, 0])
    assert stats.preemptions > 0
    assert stats.request_latency[0].queue_wait_steps == 0
    assert stats.tier_latency[1].requests == 1
    for b, r in zip(base, reqs):
        assert b.tokens_out == r.tokens_out


# ---------------------------------------------------------------------------
# The launcher: the reference's runs A (drop) and B (swap, tiers, ratio 2)
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "gemma2-2b", "--reduced", "--quantize", "--deploy-int8",
          "--kv-bits", "8", "--scheduler", "continuous", "--paged-kv",
          "--block-size", "8", "--prefill-chunk", "8", "--requests", "6",
          "--new-tokens", "12", "--batch-slots", "4", "--num-blocks", "10",
          "--over-commit", "--parity"]
# the reference launcher's lines for runs A and B (a CPU run of
# repro.launch.serve with the same flags)
RUN_LINES = {
    "A": ([], "72 tokens, 27 decode steps, 17 prefills",
          "blocks 10/10 (frag 26%, block-size 8), chunked prefill (17 chunk "
          "steps @ <= 8 tokens), over-commit: 10 preemptions (0 blocks "
          "swapped, 117 tokens recomputed), queue-wait 50 steps",
          ["[tier 0] 6 requests, first-token p50/p99 2/21 steps, "
           "inter-token p50/p99 1.8/3.2 steps"], 10),
    "B": (["--swap-blocks", "--priority", "1", "--decode-ratio", "2"],
          "72 tokens, 28 decode steps, 5 prefills",
          "blocks 10/10 (frag 32%, block-size 8), chunked prefill (5 chunk "
          "steps @ <= 8 tokens), over-commit: 9 preemptions (16 blocks "
          "swapped, 0 tokens recomputed), queue-wait 43 steps",
          ["[tier 1] 3 requests, first-token p50/p99 2/2 steps, "
           "inter-token p50/p99 1.1/1.4 steps",
           "[tier 0] 3 requests, first-token p50/p99 15/19 steps, "
           "inter-token p50/p99 1.3/2.3 steps"], 9),
}


@pytest.mark.parametrize("run", sorted(RUN_LINES))
def test_launcher_serves_the_over_commit_runs_with_parity(capsys, run):
    from repro_torch.launch import serve as launcher
    extra, counts, note, tiers, preemptions = RUN_LINES[run]
    launcher.main(LAUNCH + extra, device=CPU)
    out = capsys.readouterr().out
    line = re.search(r"^\[serve:continuous\] (.*)$", out, re.M).group(1)
    assert line.startswith(counts) and f"{note}, cpu)" in line, line
    assert re.findall(r"^\[tier \d+\] .*$", out, re.M) == tiers
    oks = re.findall(r"^\[parity\] OK: (.+)$", out, re.M)
    assert [o.split(" ")[0] for o in oks] == [
        "continuous", "chunked", "paged", "preempted"], out
    assert oks[-1] == (f"preempted (over-commit, {preemptions} preemptions) "
                       f"and unpreempted serving emit identical greedy "
                       f"tokens for all 6 requests (kv-bits 8)")


def test_launcher_accepts_the_over_commit_flags_and_checks_them():
    """The over-commit flags parse and pass the reference's checks, with
    ``--tp 2 --reduced`` too (``tests/test_torch_tp_flags.py`` serves
    them); their misuse and ``--async`` with them stop the launcher, as
    does ``--tp`` without ``--reduced`` (the reference's check); ``--tp 2
    --reduced`` alone passes."""
    from repro_torch.launch.serve import _check_args, build_parser
    ap = build_parser()
    base = ["--arch", "gemma2-2b", "--reduced", "--scheduler", "continuous",
            "--paged-kv"]
    _check_args(ap, ap.parse_args(base + ["--over-commit", "--swap-blocks",
                                          "--priority", "2",
                                          "--decode-ratio", "3"]))
    _check_args(ap, ap.parse_args(base + ["--tp", "2"]))
    _check_args(ap, ap.parse_args(base + ["--over-commit", "--tp", "2"]))
    for bad in (["--swap-blocks"], ["--decode-ratio", "2"],
                ["--decode-ratio", "0", "--over-commit"],
                ["--over-commit", "--async"]):
        with pytest.raises(SystemExit):
            _check_args(ap, ap.parse_args(base + bad))
    with pytest.raises(SystemExit):
        _check_args(ap, ap.parse_args(["--arch", "gemma2-2b", "--paged-kv",
                                       "--scheduler", "continuous", "--tp",
                                       "2"]))
    with pytest.raises(SystemExit):
        _check_args(ap, ap.parse_args(["--arch", "gemma2-2b",
                                       "--over-commit"]))
