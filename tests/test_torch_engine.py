"""The engine's decomposed API in the port (``repro_torch.runtime.engine``:
``prefill`` / ``insert`` / ``release``, ``make_engine``, ``serve_engine``;
``models.transformer.cache_extract_lane`` / ``cache_insert_lane``) against
the reference, on the CPU.

* The unsharded cases of ``tests/test_engine.py``: the port's
  ``serve_engine`` tokens equal the port's continuous Scheduler's in every
  mode the reference checks (dense kv16/8/4, paged, prefix cache,
  over-commit drop and swap, deploy int8) AND the reference's
  ``serve_engine`` on the same params (carried over through ``convert``;
  the deploy cases also carry the reference's calibration over). kv4 is
  held to the reference's 0.9 match floor.
* The recompile guard as a shape-signature guard: each of prefill /
  extract / insert / generate sees one input shape signature over varying
  prompts, quotas and lane compositions (and an engine without a prompt
  pad shows the guard can fail).
* Lane bit isolation: ``insert`` overwrites its lane and leaves every other
  lane's bytes as they were.
* ``cache_extract_lane`` / ``cache_insert_lane`` against the reference's,
  bit for bit, on every dense cache type in both layouts; a payload does
  not change when the scratch cache is prefilled again.
* The error cases with the reference's messages.
"""
import functools

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
from repro.runtime import Request as JRequest
from repro.runtime import serve_engine as jserve_engine
from repro.runtime.engine import _lane_rows as j_lane_rows
from repro.runtime.engine import make_engine as jmake_engine
from repro_torch.configs import get_config
from repro_torch.convert import (act_state_from_jax, caches_from_jax,
                                 params_from_jax)
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, Engine, RadixCache, Request,
                                 make_engine, serve_continuous, serve_engine)
from repro_torch.runtime.engine import _lane_rows
from repro_torch.runtime.steps import (make_admit_step,
                                       make_chunk_prefill_step,
                                       make_decode_step, make_swap_steps)
from repro_torch.runtime.telemetry import QuantHealth

pytestmark = [pytest.mark.engine, pytest.mark.serve]

CPU = "cpu"
MAX_LEN = 32
PAD = 8
BLOCK = 4
SPEC = [(4, 2), (8, 6), (3, 1), (6, 4), (5, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module: the reduced model's ops are tiny,
    and a pool's threads, oversubscribed by parallel test workers, slow
    them down by tens of times. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """{"float": the reference's reduced f32 params and the port's copy,
    "deploy": the reference test's PTQ calibration (PEG, packed int8) built
    in both packages on the same params and act state} as
    {kind: (jparams, jctx, params, ctx)}; and the two configs."""
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, stacked=True, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    calib = [{"tokens": jax.random.randint(jax.random.PRNGKey(10), (2, 8),
                                           0, jcfg.vocab_size)}]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, calib, jpeg_policy(4), collect_inputs=True)
    jshared = {}
    for site, qp in jqm.act_state.items():
        base = ("layer/" + site.split("/", 1)[1]
                if site.startswith("layer") else site)
        jshared.setdefault(base, qp)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4), jshared)
    stacked = params_from_jax(_np_tree(jstacked), CPU)
    shared = act_state_from_jax(_np_tree(jshared), CPU)
    packed, acts = build_deploy(cfg, stacked, peg_policy(4), shared)

    def jctx():
        return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                         act_state=jshared, deploy_acts=jacts)

    def ctx():
        return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                        act_state=shared, deploy_acts=acts)
    return jcfg, cfg, {"float": (jstacked, None, stacked, None),
                       "deploy": (jpacked, jctx, packed, ctx)}


@pytest.fixture(scope="module")
def jengine(models):
    """One reference engine per (model, kv_bits, paged), built once and
    reused across request sets (each traces once)."""
    jcfg, _, kinds = models

    @functools.lru_cache(maxsize=None)
    def get(kind, kv_bits, paged):
        jparams, jctx, _, _ = kinds[kind]
        return jmake_engine(jcfg, jparams, batch_slots=2,
                            prompt_pad_len=PAD, max_len=MAX_LEN,
                            dtype=jnp.float32, kv_bits=kv_bits, paged=paged,
                            block_size=BLOCK, ctx_factory=jctx)
    return get


def _mk_reqs(cls, seed, vocab, spec=SPEC):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(1, vocab, size=n).astype(np.int32),
                max_new_tokens=q)
            for i, (n, q) in enumerate(spec)]


def _engine(cfg, params, *, kv_bits=16, paged=False, ctx=None,
            batch_slots=2, **kw):
    return make_engine(cfg, params, batch_slots=batch_slots,
                       prompt_pad_len=PAD, max_len=MAX_LEN,
                       dtype=torch.float32, kv_bits=kv_bits, paged=paged,
                       block_size=BLOCK, ctx_factory=ctx, device=CPU, **kw)


def _scheduler_tokens(cfg, params, reqs, *, kv_bits=16, ctx=None,
                      batch_slots=2, paged=False, prefix=False,
                      over_commit=False, swap=False, num_blocks=None):
    """The port's continuous Scheduler in the reference test's modes."""
    admit = make_admit_step(cfg, ctx_factory=ctx)
    decode = make_decode_step(cfg, ctx_factory=ctx)
    chunk = None
    if prefix or over_commit:
        chunk_step = make_chunk_prefill_step(cfg, ctx_factory=ctx)
        chunk = lambda t, pm, m, c: chunk_step(params, t, pm, m, c)  # noqa
    nb_lane = tfm.paged_lane_blocks(cfg, MAX_LEN, BLOCK)
    pool = (BlockPool(num_blocks or batch_slots * nb_lane, BLOCK,
                      batch_slots, nb_lane) if paged else None)
    swap_out, swap_in = make_swap_steps() if swap else (None, None)

    def init(b):
        if not paged:
            return tfm.init_cache(cfg, b, MAX_LEN, dtype=torch.float32,
                                  kv_bits=kv_bits, device=CPU)
        return tfm.init_cache(cfg, b, MAX_LEN, dtype=torch.float32,
                              kv_bits=kv_bits, paged=True, block_size=BLOCK,
                              num_blocks=pool.num_blocks, mapped=False,
                              device=CPU)

    serve_continuous(
        lambda t, pm, m, c: admit(params, t, pm, m, c),
        lambda t, p, c: decode(params, t, p, c), init, reqs,
        batch_slots=batch_slots, max_len=MAX_LEN, block_pool=pool,
        chunk_fn=chunk, prefill_chunk=PAD if chunk is not None else None,
        radix_cache=RadixCache(BLOCK) if prefix else None,
        write_caps=(tfm.attn_write_caps(cfg, MAX_LEN, BLOCK)
                    if paged else None),
        ring_tokens=(tfm.paged_ring_tokens(cfg, MAX_LEN, BLOCK)
                     if paged else None),
        copy_block_fn=tfm.cache_copy_block if prefix else None,
        over_commit=over_commit, swap_out_fn=swap_out, swap_in_fn=swap_in,
        device=CPU)
    return [r.tokens_out for r in reqs]


def _assert_same_tokens(got, want, kv_bits):
    if kv_bits == 4:
        # int4 per-slot dynamic grids round-trip prefill reads
        # approximately (the reference's rule): a match-rate floor
        matched = sum(1 for a, b in zip(got, want)
                      for x, y in zip(a, b) if x == y)
        total = sum(min(len(a), len(b)) for a, b in zip(got, want))
        assert matched / max(total, 1) >= 0.9, (matched, total)
        return
    assert got == want


def _check_parity(models, jengine, kind, seed, reqs_fn, kv_bits=16,
                  engine_paged=False, **sched):
    """serve_engine on the port (a paged engine with ``engine_paged``) ==
    the port's Scheduler (``sched`` modes) == the reference's
    serve_engine, on the same requests."""
    jcfg, cfg, kinds = models
    _, _, params, ctx = kinds[kind]
    reqs = reqs_fn(Request, seed)
    eng = _engine(cfg, params, kv_bits=kv_bits, paged=engine_paged, ctx=ctx)
    serve_engine(eng, reqs)
    got = [r.tokens_out for r in reqs]
    assert all(r.done for r in reqs)
    want = _scheduler_tokens(cfg, params, reqs_fn(Request, seed),
                             kv_bits=kv_bits, ctx=ctx, **sched)
    _assert_same_tokens(got, want, kv_bits)
    jreqs = reqs_fn(JRequest, seed)
    jserve_engine(jengine(kind, kv_bits, engine_paged), jreqs)
    _assert_same_tokens(got, [r.tokens_out for r in jreqs], kv_bits)
    assert eng.signature_counts == {"prefill": 1, "extract": 1, "insert": 1,
                                    "generate": 1}


class TestEngineSchedulerParity:
    @pytest.mark.parametrize("kv_bits", [16, 8, 4])
    def test_dense(self, models, jengine, kv_bits):
        vocab = models[1].vocab_size
        _check_parity(models, jengine, "float", 7,
                      lambda cls, s: _mk_reqs(cls, s, vocab), kv_bits)

    @pytest.mark.paged
    @pytest.mark.parametrize("kv_bits", [16, 8])
    def test_paged(self, models, jengine, kv_bits):
        """The identity-mapped paged engine against the pool-managed paged
        Scheduler."""
        vocab = models[1].vocab_size
        _check_parity(models, jengine, "float", 8,
                      lambda cls, s: _mk_reqs(cls, s, vocab), kv_bits,
                      engine_paged=True, paged=True)

    @pytest.mark.prefix
    def test_prefix_cache(self, models, jengine):
        """The Scheduler with a radix cache (shared-prefix workload, real
        hits) against the bare dense engine."""
        vocab = models[1].vocab_size

        def mk(cls, seed):
            r = np.random.RandomState(seed)
            shared = r.randint(1, vocab, size=4).astype(np.int32)
            return [cls(rid=i, prompt=np.concatenate(
                [shared, r.randint(1, vocab, size=4)]).astype(np.int32),
                max_new_tokens=4) for i in range(4)]
        _check_parity(models, jengine, "float", 9, mk, paged=True,
                      prefix=True)

    @pytest.mark.preempt
    @pytest.mark.parametrize("swap", [False, True])
    def test_over_commit(self, models, jengine, swap):
        """Over-commit on a starved pool (drop and swap resume) against the
        bare dense engine."""
        cfg = models[1]
        nb_lane = tfm.paged_lane_blocks(cfg, MAX_LEN, BLOCK)
        _check_parity(models, jengine, "float", 10,
                      lambda cls, s: _mk_reqs(cls, s, cfg.vocab_size),
                      paged=True, over_commit=True, swap=swap,
                      num_blocks=nb_lane + nb_lane // 2)

    @pytest.mark.deploy
    @pytest.mark.parametrize("kv_bits", [16, 8])
    def test_deploy_int8(self, models, jengine, kv_bits):
        vocab = models[1].vocab_size
        _check_parity(models, jengine, "deploy", 11,
                      lambda cls, s: _mk_reqs(cls, s, vocab, SPEC[:4]),
                      kv_bits)


def test_zero_and_one_token_quotas(models):
    """Quota 0 retires untouched; quota 1 is served by the prefill alone
    (released at once, no decode step): the Scheduler's tokens."""
    _, cfg, kinds = models
    params = kinds["float"][2]
    spec = [(4, 0), (5, 1), (3, 2), (6, 1)]
    reqs = _mk_reqs(Request, 5, cfg.vocab_size, spec)
    serve_engine(_engine(cfg, params), reqs)
    want = _scheduler_tokens(cfg, params,
                             _mk_reqs(Request, 5, cfg.vocab_size, spec))
    assert [r.tokens_out for r in reqs] == want
    assert [len(t) for t in want] == [0, 1, 2, 1]
    assert all(r.done for r in reqs)


class TestRecompileGuard:
    @pytest.mark.parametrize("paged", [False, True])
    def test_each_step_sees_one_shape_signature(self, models, paged):
        """Over varying prompt lengths, quotas, lane compositions and a
        second wave on the same state, each of prefill / extract / insert /
        generate (and chunk, when built) is called with one input shape
        signature: the shapes a captured graph would need fixed."""
        _, cfg, kinds = models
        eng = _engine(cfg, kinds["float"][2], batch_slots=3, paged=paged,
                      with_chunk_fn=True)
        rng = np.random.RandomState(12)
        state = serve_engine(eng, _mk_reqs(Request, 12, cfg.vocab_size,
                                           [(4, 2), (7, 5)]))
        serve_engine(eng, _mk_reqs(Request, 13, cfg.vocab_size,
                                   [(3, 1), (8, 3), (5, 4)]), state=state)
        for _ in range(2):      # all-dead rows: the chunk writes nothing
            toks = rng.randint(1, cfg.vocab_size, (3, 4)).astype(np.int32)
            eng.chunk(toks, np.full((3, 4), -1, np.int32),
                      np.zeros(3, bool), state.cache)
        assert eng.signature_counts == {"prefill": 1, "generate": 1,
                                        "extract": 1, "insert": 1,
                                        "chunk": 1}, eng.signature_counts

    def test_guard_sees_a_second_shape(self, models):
        """Without a prompt pad, prompts of two lengths give the prefill
        two signatures: the record does tell shapes apart."""
        _, cfg, kinds = models
        eng = make_engine(cfg, kinds["float"][2], batch_slots=2,
                          prompt_pad_len=None, max_len=MAX_LEN,
                          dtype=torch.float32, device=CPU)
        serve_engine(eng, _mk_reqs(Request, 3, cfg.vocab_size,
                                   [(4, 2), (6, 2)]))
        assert eng.signature_counts["prefill"] == 2
        assert eng.signature_counts["generate"] == 1


def _lane_bytes(cache, lane):
    """Raw bytes of one batch lane across every cache leaf (scan leaves
    carry the batch on axis 1, tail leaves on axis 0)."""
    parts = []
    for c in cache["scan"]:
        parts.extend(leaf[:, lane].numpy().tobytes() for leaf in c)
    for c in cache["tail"]:
        parts.extend(leaf[lane].numpy().tobytes() for leaf in c)
    return b"".join(parts)


class TestLaneBitIsolation:
    @pytest.mark.parametrize("kv_bits", [16, 8, 4])
    def test_insert_touches_only_target_lane(self, models, kv_bits):
        """``insert`` into lane 1 leaves lanes 0 and 2 bit-identical (after
        they already hold live requests), in place (the cache keeps its
        tensors), and really replaces lane 1."""
        _, cfg, kinds = models
        _, _, params, ctx = kinds["deploy" if kv_bits < 16 else "float"]
        eng = _engine(cfg, params, kv_bits=kv_bits, ctx=ctx, batch_slots=3)
        rng = np.random.RandomState(13)
        state = eng.init_state()
        ptrs = [x.data_ptr() for n in tfm._cache_nodes(state.cache)
                for x in n]
        for slot, n in ((0, 5), (2, 7)):
            _, payload = eng.prefill(
                rng.randint(1, cfg.vocab_size, size=n).astype(np.int32))
            state = eng.insert(payload, slot, state)
        before = {i: _lane_bytes(state.cache, i) for i in (0, 2)}
        _, payload = eng.prefill(
            rng.randint(1, cfg.vocab_size, size=6).astype(np.int32))
        state = eng.insert(payload, 1, state)
        for i in (0, 2):
            assert _lane_bytes(state.cache, i) == before[i]
        mid = _lane_bytes(state.cache, 1)
        _, payload = eng.prefill(
            rng.randint(1, cfg.vocab_size, size=4).astype(np.int32))
        state = eng.insert(payload, 1, state)
        assert _lane_bytes(state.cache, 1) != mid
        for i in (0, 2):
            assert _lane_bytes(state.cache, i) == before[i]
        assert ptrs == [x.data_ptr() for n in tfm._cache_nodes(state.cache)
                        for x in n]
        released = eng.release(1, state)
        assert released.pos[1, 0] == -1 and state.pos[1, 0] == 4
        assert released.cache is state.cache


def _filled(jcfg, kv_bits, stacked, seed, batch=3):
    rng = np.random.RandomState(seed)
    jc = jtfm.init_cache(jcfg, batch, MAX_LEN, dtype=jnp.float32,
                         kv_bits=kv_bits, stacked=stacked)
    return jax.tree.map(lambda x: jnp.asarray(
        (rng.randn(*x.shape) * 50).astype(x.dtype)), jc)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("stacked", [True, False])
def test_extract_and_insert_lane_match_reference(models, kv_bits, stacked):
    """Extract lane 1 of one seeded cache and insert it into lane 2 of
    another: the payload is the reference's, bit for bit, with the cache
    types (int4 stays Quant4KVCache) and every leaf a copy; the insert
    writes in place and gives the reference's cache."""
    jcfg = models[0]
    jsrc, jdst = (_filled(jcfg, kv_bits, stacked, kv_bits + s)
                  for s in (0, 1))
    src, dst = (caches_from_jax(_np_tree(c), CPU) for c in (jsrc, jdst))
    jpayload = jtfm.cache_extract_lane(jsrc, 1)
    payload = tfm.cache_extract_lane(src, 1)
    assert set(payload) == set(jpayload)
    for key in payload:
        for node, jnode, snode in zip(payload[key], jpayload[key], src[key]):
            assert type(node) is type(snode)
            for x, jx, sx in zip(node, jnode, snode):
                np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
                assert x.untyped_storage().data_ptr() != \
                    sx.untyped_storage().data_ptr()
    jout = jtfm.cache_insert_lane(jdst, 2, jpayload)
    assert tfm.cache_insert_lane(dst, 2, payload) is dst
    want = caches_from_jax(_np_tree(jout), CPU)
    for a, b in zip(tfm._cache_nodes(dst), tfm._cache_nodes(want)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_payload_survives_the_next_prefill(models):
    """The scratch cache is written in place by every prefill: a payload
    taken earlier keeps its bytes."""
    _, cfg, kinds = models
    eng = _engine(cfg, kinds["float"][2], kv_bits=8)
    rng = np.random.RandomState(14)
    _, first = eng.prefill(rng.randint(1, cfg.vocab_size, size=6))
    kept = tfm.clone_cache(first.kv)
    eng.prefill(rng.randint(1, cfg.vocab_size, size=7))
    for a, b in zip(tfm._cache_nodes(first.kv), tfm._cache_nodes(kept)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_match_reference(models):
    """The reference's messages: paged caches and non-attention nodes in
    the lane functions, empty and over-long prompts, a slot out of range,
    an unmapped paged row, a paged scratch too small for one lane; on a
    mesh in the reference's default layout (caches on the sequence dim) a
    config the sharded forward cannot run (recurrent blocks; MoE blocks
    serve expert-parallel) is not yet ported."""
    jcfg, cfg, kinds = models
    jpaged = jtfm.init_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32,
                             paged=True, block_size=BLOCK)
    paged = tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32, paged=True,
                           block_size=BLOCK, device=CPU)
    # paged arenas in a dict without a block table
    jstray = {k: jpaged[k] for k in ("scan", "tail")}
    stray = {k: paged[k] for k in ("scan", "tail")}
    for jcache, cache in ((jpaged, paged), (jstray, stray)):
        assert _message(lambda: tfm.cache_extract_lane(cache, 0)) == \
            _message(lambda: jtfm.cache_extract_lane(jcache, 0))
        assert _message(lambda: tfm.cache_insert_lane(cache, 0, cache)) == \
            _message(lambda: jtfm.cache_insert_lane(jcache, 0, jcache))
    for prompt, width in (([], 4), ([1, 2, 3], 2)):
        assert _message(lambda: _lane_rows(np.array(prompt), width)) == \
            _message(lambda: j_lane_rows(np.array(prompt), width))
    toks, pos = _lane_rows(np.array([5, 6]), 4)
    jtoks, jpos = j_lane_rows(np.array([5, 6]), 4)
    assert toks.tolist() == jtoks.tolist() and pos.tolist() == jpos.tolist()

    params = kinds["float"][2]
    eng = _engine(cfg, params)
    state = eng.init_state()
    _, payload = eng.prefill(np.array([3, 4, 5]))
    assert _message(lambda: eng.insert(payload, 2, state)) == \
        "slot 2 outside 0..1"
    nb = tfm.paged_lane_blocks(cfg, MAX_LEN, BLOCK)

    def unmapped(b):
        return tfm.init_cache(cfg, b, MAX_LEN, dtype=torch.float32,
                              paged=True, block_size=BLOCK,
                              num_blocks=b * nb, mapped=False, device=CPU)
    eng = Engine(None, None, unmapped, batch_slots=2, device=CPU)
    assert _message(lambda: eng.insert(payload, 1, eng.init_state())) == (
        "slot 1's block-table row is not fully mapped — decomposed insert "
        "needs the identity-mapped paged layout (init_cache(paged=True) "
        "default)")
    small = Engine(None, None, lambda b: tfm.init_cache(
        cfg, b, MAX_LEN, dtype=torch.float32, paged=True, block_size=BLOCK,
        num_blocks=nb - 1, mapped=False, device=CPU), batch_slots=2,
        device=CPU)
    assert _message(small._ensure_scratch) == (
        f"decomposed prefill needs {nb} scratch blocks for one lane but "
        f"the paged arena holds {nb - 1}")
    from repro_torch.parallel.sharding import make_abstract_mesh, make_dist
    seq_dist = make_dist(make_abstract_mesh((1, 2), ("data", "model")))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_engine(get_config("rwkv6-1p6b").reduced(), params,
                    batch_slots=2, prompt_pad_len=PAD, max_len=MAX_LEN,
                    dist=seq_dist, device=CPU)


@pytest.mark.deploy
def test_armed_engine_feeds_its_sink_and_keeps_the_tokens(models):
    """``quant_telemetry`` and ``telemetry_sink`` pass through
    ``make_engine``: the sink gets the armed steps' site vectors and the
    tokens are the plain engine's."""
    _, cfg, kinds = models
    _, _, params, ctx = kinds["deploy"]
    health = QuantHealth()
    armed = _engine(cfg, params, kv_bits=8, ctx=ctx, quant_telemetry=True,
                    telemetry_sink=health.update)
    plain = _engine(cfg, params, kv_bits=8, ctx=ctx)
    runs = []
    for eng in (armed, plain):
        reqs = _mk_reqs(Request, 15, cfg.vocab_size, SPEC[:3])
        serve_engine(eng, reqs)
        runs.append([r.tokens_out for r in reqs])
    assert runs[0] == runs[1]
    rep = health.report()
    assert rep["steps_observed"] > 0
    assert "layer0/attn/wo_in" in rep["sites"]
