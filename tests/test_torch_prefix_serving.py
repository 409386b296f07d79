"""Prefix sharing on the port's paged serving path against the reference,
end to end on the reduced gemma2-2b (f32 params carried across from the
reference through ``repro_torch.convert``).

The workloads are the launcher's ``--prefix-cache`` ones (every prompt
opens with the same ``prompt_len // 2`` tokens): run A is ``--requests 8
--prompt-len 12 --new-tokens 4 --block-size 4 --max-len 32`` with 4 lanes
and chunks of 8; run B adds ``--skew 10``, whose long lanes decode past the
16-cell local window onto their shared prefix, so copy-on-write runs. Both
packages' continuous Schedulers serve them with a radix cache: the greedy
tokens, the serving counters, the prefix gauges and the copy-on-write
calls and copies must be equal, at kv16 (float params) and on the deploy
path at kv8; shared serving must equal unshared serving; a copy never
changes a cached block; a prefix-hit admission leaves the resident lanes'
blocks bitwise unchanged; ``cache_copy_block`` equals the reference's on
the same arenas. At kv4 the port is held to the reference at kv4 (its
counters exactly, its greedy tokens as a match rate: int4 parity is a rate,
as ROADMAP Queue 3 records).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import Mode as JMode
from repro.core import QuantCtx as JQuantCtx
from repro.core import build_deploy as jbuild_deploy
from repro.core import peg_policy as jpeg_policy
from repro.core.pipeline import ptq as jptq
from repro.models import transformer as jtfm
from repro.runtime import BlockPool as JBlockPool
from repro.runtime import RadixCache as JRadixCache
from repro.runtime import Request as JRequest
from repro.runtime import serve as jserve
from repro.runtime.steps import make_admit_step as jmake_admit
from repro.runtime.steps import make_chunk_prefill_step as jmake_chunk
from repro.runtime.steps import make_decode_step as jmake_decode
from repro_torch.configs import get_config
from repro_torch.convert import (act_state_from_jax, caches_from_jax,
                                 params_from_jax)
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, RadixCache, Request,
                                 make_admit_step, make_chunk_prefill_step,
                                 make_decode_step, serve)

pytestmark = [pytest.mark.prefix, pytest.mark.serve, pytest.mark.paged]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"
MAX_LEN, BS, CHUNK, SLOTS = 32, 4, 8, 4
RUNS = {"A": 0, "B": 10}            # --skew
# the reference's counts for the launcher's runs A and B: tokens, decode
# steps, prefills, peak blocks, chunk steps, prefix hit tokens, and
# BlockPool.cow calls (of which 2 copy, in run B)
COUNTS = {"A": (32, 6, 3, 21, 3, 16), "B": (56, 18, 5, 27, 5, 16)}
FRAG = {"A": 14, "B": 12}           # the serve line's fragmentation, %


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _requests(cls, vocab, skew, seed=0):
    """The launcher's --prefix-cache workload (8 x 12 tokens, 4 new, every
    other request ``skew`` new): the same RandomState draws."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(10, vocab, size=6)
    return [cls(rid=i, prompt=np.concatenate(
        [shared, rng.randint(10, vocab, size=6)]).astype(np.int64),
        max_new_tokens=skew if skew and i % 2 else 4) for i in range(8)]


def _counting(cls):
    """A pool class that counts its ``cow`` calls and the copies they
    ask for."""
    class Counting(cls):
        def reset(self):
            self.cow_calls, self.copies = 0, []
            super().reset()

        def cow(self, lane, col):
            pair = super().cow(lane, col)
            self.cow_calls += 1
            if pair is not None:
                self.copies.append(pair)
            return pair
    return Counting


@pytest.fixture(scope="module")
def models():
    """The reduced gemma2-2b's f32 params, and its deploy path (PTQ with
    PEG, packed int8 weights) built by the reference and carried across,
    with the reference's jitted steps."""
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, stacked=True, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    rng = np.random.RandomState(10)
    calib = [{"tokens": jnp.asarray(rng.randint(0, cfg.vocab_size, (2, 12)))}
             for _ in range(2)]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, calib, jpeg_policy(4), collect_inputs=True)
    jshared = {}
    for site, qp in jqm.act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        jshared.setdefault(base, qp)
    params = params_from_jax(_np_tree(jstacked), CPU)
    shared = act_state_from_jax(_np_tree(jshared), CPU)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4), jshared)
    packed, acts = build_deploy(cfg, params, peg_policy(4), shared)

    def ctx():
        return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                        act_state=shared, deploy_acts=acts)

    def jctx():
        return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                         act_state=jshared, deploy_acts=jacts)

    def jsteps(ctx_factory):
        return dict(
            admit=jax.jit(jmake_admit(jcfg, ctx_factory=ctx_factory)),
            chunk=jax.jit(jmake_chunk(jcfg, ctx_factory=ctx_factory)),
            decode=jax.jit(jmake_decode(jcfg, ctx_factory=ctx_factory)))
    return {
        "float": dict(jcfg=jcfg, cfg=cfg, jparams=jstacked, params=params,
                      jctx=None, ctx=None, jsteps=jsteps(None)),
        "deploy": dict(jcfg=jcfg, cfg=cfg, jparams=jpacked, params=packed,
                       jctx=jctx, ctx=ctx, jsteps=jsteps(jctx)),
        "copy_block": jax.jit(jtfm.cache_copy_block)}


def _serve_ref(models, mode, kv_bits, skew):
    m = models[mode]
    nb_lane = jtfm.paged_lane_blocks(m["jcfg"], MAX_LEN, BS)
    pool = _counting(JBlockPool)(SLOTS * nb_lane, BS, SLOTS, nb_lane)
    reqs = _requests(JRequest, m["cfg"].vocab_size, skew)
    stats = jserve(
        None, m["jsteps"]["admit"], m["jsteps"]["decode"],
        lambda b: jtfm.init_cache(m["jcfg"], b, MAX_LEN, dtype=jnp.float32,
                                  kv_bits=kv_bits, paged=True, block_size=BS,
                                  num_blocks=SLOTS * nb_lane, mapped=False),
        m["jparams"], reqs, scheduler="continuous", batch_slots=SLOTS,
        max_len=MAX_LEN, block_pool=pool, chunk_step=m["jsteps"]["chunk"],
        prefill_chunk=CHUNK, radix_cache=JRadixCache(BS),
        write_caps=jtfm.attn_write_caps(m["jcfg"], MAX_LEN, BS),
        copy_block_fn=models["copy_block"])
    return reqs, stats, pool


def _serve_port(models, mode, kv_bits, skew, prefix=True, chunk_fn=None,
                decode_fn=None, pool=None, copy_fn=None):
    """The port's Scheduler on the same workload (``chunk_fn`` /
    ``decode_fn`` wrap the steps, ``copy_fn`` replaces
    ``cache_copy_block``)."""
    m = models[mode]
    cfg = m["cfg"]
    nb_lane = tfm.paged_lane_blocks(cfg, MAX_LEN, BS)
    pool = pool or _counting(BlockPool)(SLOTS * nb_lane, BS, SLOTS,
                                        nb_lane)
    reqs = _requests(Request, cfg.vocab_size, skew)
    chunk = make_chunk_prefill_step(cfg, ctx_factory=m["ctx"])
    decode = make_decode_step(cfg, ctx_factory=m["ctx"])

    def init(b):
        return tfm.init_cache(cfg, b, MAX_LEN, dtype=torch.float32,
                              kv_bits=kv_bits, paged=True, block_size=BS,
                              num_blocks=SLOTS * nb_lane, mapped=False,
                              device=CPU)
    stats = serve(
        None, decode_fn(decode) if decode_fn else decode, init, m["params"],
        reqs, scheduler="continuous", batch_slots=SLOTS, max_len=MAX_LEN,
        admit_step=make_admit_step(cfg, ctx_factory=m["ctx"]),
        chunk_step=chunk_fn(chunk) if chunk_fn else chunk, block_pool=pool,
        prefill_chunk=CHUNK, radix_cache=RadixCache(BS) if prefix else None,
        write_caps=tfm.attn_write_caps(cfg, MAX_LEN, BS),
        copy_block_fn=(copy_fn or tfm.cache_copy_block) if prefix else None,
        device=CPU)
    return reqs, stats, pool


FIELDS = ("tokens_generated", "decode_steps", "prefill_calls", "chunk_steps",
          "blocks_in_use", "block_fragmentation", "cache_bytes",
          "slot_utilization", "queue_wait_steps", "prefix_hit_tokens",
          "prefill_tokens_saved", "shared_blocks", "prefix_hit_rate")


@pytest.mark.parametrize("mode,kv_bits", [("float", 16), ("deploy", 8)])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_prefix_serving_matches_reference(models, run, mode, kv_bits):
    """Runs A and B through both Schedulers: the same greedy tokens,
    counters and prefix gauges, the same copy-on-write calls and copies
    (the port's through ``cache_copy_block``), and the port's prefix-shared
    tokens equal to its unshared ones."""
    jreqs, jstats, jpool = _serve_ref(models, mode, kv_bits, RUNS[run])
    copies_before = tfm.cache_copy_block.calls
    treqs, tstats, tpool = _serve_port(models, mode, kv_bits, RUNS[run])
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.tokens_out == jr.tokens_out, tr.rid
    for field in FIELDS:
        assert getattr(tstats, field) == getattr(jstats, field), field
    assert (tpool.cow_calls, tpool.copies) == (jpool.cow_calls, jpool.copies)
    assert tfm.cache_copy_block.calls - copies_before == len(tpool.copies)
    assert (tstats.tokens_generated, tstats.decode_steps,
            tstats.prefill_calls, tstats.blocks_in_use, tstats.chunk_steps,
            tstats.prefix_hit_tokens) == COUNTS[run]
    assert tstats.prefill_tokens_saved == 16 and tstats.shared_blocks == 1
    if run == "B":
        assert (tpool.cow_calls, len(tpool.copies)) == (26, 2)
    ureqs, ustats, _ = _serve_port(models, mode, kv_bits, RUNS[run],
                                   prefix=False)
    for tr, ur in zip(treqs, ureqs):
        assert tr.tokens_out == ur.tokens_out, tr.rid
    assert ustats.prefix_hit_tokens == 0


def _block_bytes(cache, blocks):
    """The bytes of physical ``blocks`` in every paged arena leaf."""
    idx = torch.as_tensor(np.asarray(blocks, np.int64))
    parts = [leaf.index_select(1, idx).numpy().tobytes()
             for c in cache["scan"] for leaf in c]
    parts += [leaf.index_select(0, idx).numpy().tobytes()
              for c in cache["tail"] for leaf in c]
    return b"".join(parts)


@pytest.mark.parametrize("mode,kv_bits", [("float", 16), ("deploy", 8)])
def test_cow_never_mutates_a_cached_block(models, mode, kv_bits):
    """Run B: after every chunk and decode step (and so after every
    copy-on-write) each cached block holds the bytes it held when it was
    first seen cached; the copies happened, and each copy's target
    started as its source's bytes."""
    nb_lane = tfm.paged_lane_blocks(models[mode]["cfg"], MAX_LEN, BS)
    pool = _counting(BlockPool)(SLOTS * nb_lane, BS, SLOTS, nb_lane)
    seen = {}

    def check(cache):
        for b in range(pool.num_blocks):
            if not pool.is_cached(b):
                seen.pop(b, None)
                continue
            cur = _block_bytes(cache, [b])
            assert seen.setdefault(b, cur) == cur, f"cached block {b}"

    def wrap(step):
        def run(params, *args):
            logits, cache = step(params, *args)
            check(cache)
            return logits, cache
        return run
    copied = []

    def copy_block(cache, src, dst):
        out = tfm.cache_copy_block(cache, src, dst)
        copied.append(_block_bytes(out, [int(src)]) ==
                      _block_bytes(out, [int(dst)]))
        return out
    _, stats, _ = _serve_port(models, mode, kv_bits, RUNS["B"],
                              chunk_fn=wrap, decode_fn=wrap, pool=pool,
                              copy_fn=copy_block)
    assert len(pool.copies) == 2 and copied == [True, True]
    assert stats.prefill_tokens_saved == 16 and seen


@pytest.mark.parametrize("mode,kv_bits", [("float", 16), ("deploy", 8)])
def test_prefix_hit_admission_leaves_residents_bitwise_unchanged(
        models, mode, kv_bits):
    """Run B: every chunk step that appends a prefix-hit lane's suffix (its
    first position past 0, no reset) beside resident lanes leaves the
    blocks of every lane that is not prefilling bit for bit as they
    were."""
    nb_lane = tfm.paged_lane_blocks(models[mode]["cfg"], MAX_LEN, BS)
    pool = _counting(BlockPool)(SLOTS * nb_lane, BS, SLOTS, nb_lane)
    hit_chunks = []

    def wrap(step):
        def run(params, t, pm, m, c):
            pm_np, m_np = pm.numpy(), m.numpy()
            resident = [i for i in range(pm_np.shape[0])
                        if (pm_np[i] < 0).all() and pool.lane_mapped(i)]
            before = {i: _block_bytes(c, pool.lane_blocks(i))
                      for i in resident}
            logits, c2 = step(params, t, pm, m, c)
            for i in resident:
                assert _block_bytes(c2, pool.lane_blocks(i)) == before[i], i
            hits = [i for i in range(pm_np.shape[0])
                    if (pm_np[i] >= 0).any() and not m_np[i]
                    and int(pm_np[i][pm_np[i] >= 0].min()) > 0]
            if hits and resident:
                hit_chunks.append(hits)
            return logits, c2
        return run
    _serve_port(models, mode, kv_bits, RUNS["B"], chunk_fn=wrap, pool=pool)
    assert hit_chunks, "no prefix-hit admission landed beside residents"


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("stacked", [True, False])
def test_cache_copy_block_matches_reference(models, kv_bits, stacked):
    """Reference paged arenas filled with seeded values, converted: copying
    blocks (ids as Python ints or 0-d tensors) gives the reference's cache
    bit for bit, in place; a dense cache raises the reference's error."""
    jcfg, cfg = models["float"]["jcfg"], models["float"]["cfg"]
    rng = np.random.RandomState(kv_bits + stacked)
    jc = jtfm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32,
                         kv_bits=kv_bits, paged=True, block_size=BS,
                         stacked=stacked)
    jc = jax.tree.map(lambda x: jnp.asarray(
        (rng.randn(*x.shape) * 50).astype(x.dtype)), jc)
    tc = caches_from_jax(_np_tree(jc), CPU)
    for src, dst in ((1, 9), (2, 3), (9, 0)):
        jc = jtfm.cache_copy_block(jc, src, dst)
        ids = (src, dst) if src != 2 else (torch.tensor(src),
                                           torch.tensor(dst))
        assert tfm.cache_copy_block(tc, *ids) is tc
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(
            {k: tc[k] for k in jc})):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    dense = tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32,
                           kv_bits=kv_bits, stacked=stacked, device=CPU)
    jdense = jtfm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32,
                             kv_bits=kv_bits, stacked=stacked)
    with pytest.raises(ValueError) as want:
        jtfm.cache_copy_block(jdense, 0, 1)
    with pytest.raises(ValueError) as got:
        tfm.cache_copy_block(dense, 0, 1)
    assert str(got.value) == str(want.value)


def test_kv4_prefix_serving_against_reference_kv4(models):
    """Run B on the deploy path with int4 caches (dynamic int4 grids)
    through both Schedulers: the counters, prefix gauges and copy-on-write
    calls are equal and so are the greedy tokens (a rate of 100 %; kv4
    parity with the reference is a rate, here it is exact). Shared against
    unshared serving at kv4 is a rate, printed: the int4 grids round-trip
    a prefix read from the cache approximately."""
    jreqs, jstats, jpool = _serve_ref(models, "deploy", 4, RUNS["B"])
    treqs, tstats, tpool = _serve_port(models, "deploy", 4, RUNS["B"])
    for field in FIELDS:
        assert getattr(tstats, field) == getattr(jstats, field), field
    assert (tpool.cow_calls, tpool.copies) == (jpool.cow_calls, jpool.copies)

    def rate(a, b):
        pairs = [(x, y) for r, s in zip(a, b)
                 for x, y in zip(r.tokens_out, s.tokens_out)]
        return sum(x == y for x, y in pairs) / len(pairs)
    ureqs, _, _ = _serve_port(models, "deploy", 4, RUNS["B"], prefix=False)
    print(f"kv4 run B: port vs reference {rate(treqs, jreqs):.1%}, "
          f"shared vs unshared {rate(treqs, ureqs):.1%}")
    assert rate(treqs, jreqs) == 1.0


LAUNCH = ["--arch", "gemma2-2b", "--reduced", "--batch-slots", "4",
          "--quantize", "--deploy-int8", "--scheduler", "continuous",
          "--paged-kv", "--prefill-chunk", "8", "--prefix-cache",
          "--requests", "8", "--prompt-len", "12", "--new-tokens", "4",
          "--block-size", "4", "--max-len", "32", "--kv-bits", "8",
          "--parity"]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_launcher_serves_the_prefix_cache_runs_with_parity(capsys,
                                                           monkeypatch, run):
    """``main`` with run A's and run B's flags and ``--parity`` on the CPU
    prints the reference launcher's serve line (counts, blocks, chunk
    steps, prefix-cache hits) and its four parity lines, the last
    "prefix-shared and unshared serving"; run B calls ``BlockPool.cow``
    52 times and copies 4 blocks, as the reference does."""
    from repro_torch.launch import serve as launcher
    calls = []
    orig_cow = BlockPool.cow

    def cow(self, lane, col):
        calls.append(orig_cow(self, lane, col))
        return calls[-1]
    monkeypatch.setattr(BlockPool, "cow", cow)
    copies = tfm.cache_copy_block.calls
    argv = LAUNCH + (["--skew", "10"] if RUNS[run] else [])
    launcher.main(argv, device=CPU)
    out = capsys.readouterr().out
    tokens, steps, prefills, blocks, chunks, hits = COUNTS[run]
    assert re.search(
        rf"\[serve:continuous\] {tokens} tokens, {steps} decode steps, "
        rf"{prefills} prefills, .* blocks {blocks}/32 \(frag {FRAG[run]}%, "
        rf"block-size 4\), chunked prefill \({chunks} chunk steps @ <= 8 "
        rf"tokens\), prefix-cache hits {hits} tokens \(rate 17%, 16 prefill "
        rf"tokens saved, peak 1 shared blocks\)", out), out
    oks = re.findall(r"^\[parity\] OK: (.+)$", out, re.M)
    assert [o.split(" ")[0] for o in oks] == [
        "continuous", "chunked", "paged", "prefix-shared"], out
    assert "prefix-shared and unshared serving emit identical" in oks[-1]
    n_copies = sum(pair is not None for pair in calls)
    assert tfm.cache_copy_block.calls - copies == n_copies
    if run == "B":
        assert (len(calls), n_copies) == (52, 4)
