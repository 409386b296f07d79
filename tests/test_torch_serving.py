"""The port's serving slice 2 against the reference, end to end, on the
gemma2-2b reduced config (f32): int8 and block-paged KV caches, decode
through K5/K6, continuous batching with paged admission and chunked
prefill, and the README quickstart's launcher with ``--parity``.

Weights and the calibrated act state are carried across from the
reference (``repro_torch.convert``), as in ``tests/test_torch_slice.py``,
so each check holds one layer of the stack: a 1e-7 difference in a
calibrated scale could move a value on a rounding tie to the next grid
step. Logits agree within 1e-4 of max|logits|; greedy tokens and the
scheduler's counters are equal.
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
from repro.runtime import Request as JRequest
from repro.runtime import serve as jserve
from repro.runtime.steps import make_admit_step as jmake_admit
from repro.runtime.steps import make_chunk_prefill_step as jmake_chunk
from repro.runtime.steps import make_decode_step as jmake_decode
from repro_torch.configs import get_config
from repro_torch.convert import act_state_from_jax, params_from_jax
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.launch import serve as launcher
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, Request, make_admit_step,
                                 make_chunk_prefill_step, make_decode_step,
                                 serve)

pytestmark = [pytest.mark.deploy, pytest.mark.serve, pytest.mark.paged]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"
# the README quickstart's workload
QUICKSTART = ["--arch", "gemma2-2b", "--reduced", "--requests", "6",
              "--prompt-len", "24", "--new-tokens", "6", "--max-len", "64",
              "--quantize", "--deploy-int8", "--kv-bits", "8",
              "--scheduler", "continuous", "--paged-kv", "--block-size", "8",
              "--prefill-chunk", "8"]
MAX_LEN, BS, CHUNK, SLOTS = 64, 8, 8, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """Reference params, PTQ calibration and deploy packing; the port gets
    the packed params and the shared act state carried across."""
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
    shared = act_state_from_jax(_np_tree(jshared), CPU)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4), jshared)
    packed, acts = build_deploy(
        cfg, params_from_jax(_np_tree(jstacked), CPU), peg_policy(4), shared)
    assert "layer/attn/kv" in acts and "layer/attn/kv" in jacts

    def ctx():
        return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                        act_state=shared, deploy_acts=acts)

    def jctx():
        return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                         act_state=jshared, deploy_acts=jacts)
    return dict(jcfg=jcfg, cfg=cfg, jpacked=jpacked, packed=packed, ctx=ctx,
                jctx=jctx)


@pytest.fixture(scope="module")
def jsteps(setup):
    """The reference's jitted deploy steps, shared by every check here."""
    s = setup
    return dict(
        admit=jax.jit(jmake_admit(s["jcfg"], ctx_factory=s["jctx"])),
        chunk=jax.jit(jmake_chunk(s["jcfg"], ctx_factory=s["jctx"])),
        decode=jax.jit(jmake_decode(s["jcfg"], ctx_factory=s["jctx"])))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


@pytest.mark.parametrize("paged", [False, True])
def test_deploy_logits_with_int8_caches_match_reference(setup, jsteps,
                                                        paged):
    """Prefill (one lane left-padded with dead cells) through the admit
    step, then 4 greedy decode steps through K5 (dense) or K6 (paged, the
    identity table) — teacher-forced on the reference's argmax. 22 prompt
    tokens + 4 wrap the local layers' 16-cell ring.

    The prompt's seed puts no int8 site within float rounding of a grid
    tie: XLA and PyTorch sum f32 rows in other orders, and an input with a
    tie (seed 7 here) moves one activation by one grid step in both the
    dense and the int8 cache paths alike (1.7 % of max|logits| at the
    head)."""
    s = setup
    B, T, steps = 2, 22, 4
    toks = np.random.RandomState(8).randint(0, s["cfg"].vocab_size, (B, T))
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, :3] = -1
    pos[1, 3:] = np.arange(T - 3)
    mask = np.ones((B,), bool)
    kw = dict(kv_bits=8, paged=paged, block_size=BS)
    jc = jtfm.init_cache(s["jcfg"], B, MAX_LEN, dtype=jnp.float32, **kw)
    tc = tfm.init_cache(s["cfg"], B, MAX_LEN, dtype=torch.float32,
                        device=CPU, **kw)
    admit = make_admit_step(s["cfg"], ctx_factory=s["ctx"])
    decode = make_decode_step(s["cfg"], ctx_factory=s["ctx"])
    jl, jc = jsteps["admit"](s["jpacked"], jnp.asarray(toks),
                             jnp.asarray(pos), jnp.asarray(mask), jc)
    tl, tc = admit(s["packed"], torch.as_tensor(toks), torch.as_tensor(pos),
                   torch.as_tensor(mask), tc)
    assert _rel(jl, tl.numpy()) <= 1e-4
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    nxt = (pos.max(axis=1, keepdims=True) + 1).astype(np.int32)
    for step in range(steps):
        jl, jc = jsteps["decode"](s["jpacked"], jnp.asarray(cur),
                                  jnp.asarray(nxt), jc)
        tl, tc = decode(s["packed"], torch.as_tensor(cur),
                        torch.as_tensor(nxt), tc)
        assert _rel(jl, tl.numpy()) <= 1e-4, (step, _rel(jl, tl.numpy()))
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        nxt = nxt + 1


def _requests(cls, cfg):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(10, cfg.vocab_size, size=24),
                max_new_tokens=6) for i in range(6)]


def test_continuous_paged_chunked_scheduler_matches_reference(setup,
                                                              jsteps):
    """The quickstart workload through both packages' continuous Scheduler
    with a block pool and chunked prefill: the same greedy tokens and the
    same counters (steps, prefills, chunk steps, blocks, cache bytes)."""
    s = setup
    nb_lane = jtfm.paged_lane_blocks(s["jcfg"], MAX_LEN, BS)
    n_blocks = SLOTS * nb_lane
    jreqs, treqs = _requests(JRequest, s["cfg"]), _requests(Request,
                                                           s["cfg"])
    jstats = jserve(
        None, jsteps["admit"], jsteps["decode"],
        lambda b: jtfm.init_cache(s["jcfg"], b, MAX_LEN, dtype=jnp.float32,
                                  kv_bits=8, paged=True, block_size=BS,
                                  num_blocks=n_blocks, mapped=False),
        s["jpacked"], jreqs, scheduler="continuous", batch_slots=SLOTS,
        max_len=MAX_LEN, block_pool=JBlockPool(n_blocks, BS, SLOTS, nb_lane),
        chunk_step=jsteps["chunk"], prefill_chunk=CHUNK,
        write_caps=jtfm.attn_write_caps(s["jcfg"], MAX_LEN, BS))
    tstats = serve(
        None, make_decode_step(s["cfg"], ctx_factory=s["ctx"]),
        lambda b: tfm.init_cache(s["cfg"], b, MAX_LEN, dtype=torch.float32,
                                 kv_bits=8, paged=True, block_size=BS,
                                 num_blocks=n_blocks, mapped=False,
                                 device=CPU),
        s["packed"], treqs, scheduler="continuous", batch_slots=SLOTS,
        max_len=MAX_LEN,
        admit_step=make_admit_step(s["cfg"], ctx_factory=s["ctx"]),
        chunk_step=make_chunk_prefill_step(s["cfg"], ctx_factory=s["ctx"]),
        block_pool=BlockPool(n_blocks, BS, SLOTS, nb_lane),
        prefill_chunk=CHUNK, device=CPU)
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.tokens_out) == 6
        assert tr.tokens_out == jr.tokens_out, tr.rid
    for field in ("tokens_generated", "decode_steps", "prefill_calls",
                  "chunk_steps", "blocks_in_use", "block_fragmentation",
                  "cache_bytes", "slot_utilization", "queue_wait_steps"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    for rid, lat in jstats.request_latency.items():
        assert vars(tstats.request_latency[rid]) == vars(lat), rid
    assert (tstats.tokens_generated, tstats.decode_steps,
            tstats.prefill_calls, tstats.chunk_steps,
            tstats.blocks_in_use) == (36, 10, 6, 6, 16)


@pytest.mark.parametrize("kv_bits", ["8", "16"])
def test_launcher_serves_the_quickstart_with_parity(capsys, kv_bits):
    """``main`` with the README quickstart flags and ``--parity`` on the
    CPU, with the int8 cache (K5/K6) and with the f32 one (K7): the serve
    line's counts are the reference's and every parity comparison (static
    scheduler, unchunked prefill, dense cache) holds."""
    argv = [kv_bits if a == "8" and QUICKSTART[i - 1] == "--kv-bits" else a
            for i, a in enumerate(QUICKSTART)]
    stats = launcher.main(argv + ["--parity"], device=CPU)
    out = capsys.readouterr().out
    assert stats.tokens_generated == 36
    assert re.search(r"\[serve:continuous\] 36 tokens, 10 decode steps, "
                     r"6 prefills, .* blocks 16/32 \(frag 22%, block-size "
                     r"8\), chunked prefill \(6 chunk steps @ <= 8 tokens\)",
                     out), out
    if kv_bits == "8":
        m = re.search(r"\[kv-int8\] .*: (\S+)%", out)
        assert m is not None and float(m.group(1)) <= 1e-2, out
    oks = re.findall(r"^\[parity\] OK: (\w+)", out, re.M)
    assert oks == ["continuous", "chunked", "paged"], out


# ---------------------------------------------------------------------------
# The Scheduler alone, against the reference's, on a stub model
# ---------------------------------------------------------------------------

V = 17


def _tnext(tokens, positions):
    """Stub model: next token (2 tok + 3 pos + 1) mod V from the last
    column, as one-hot logits (B, 1, V)."""
    nxt = (2 * tokens[:, -1:].long() + 3 * positions[:, -1:].long() + 1) % V
    return torch.nn.functional.one_hot(nxt, V).float()


def _jnext(tokens, positions):
    nxt = (2 * tokens[:, -1:] + 3 * positions[:, -1:] + 1) % V
    return jax.nn.one_hot(nxt, V)


def _stub_steps(next_fn):
    return (lambda t, pm, m, c: (next_fn(t, pm), c),     # admit
            lambda t, p, c: (next_fn(t, p), c),           # decode
            lambda t, pm, m, c: (next_fn(t, pm), c))      # chunk


def _workload(seed):
    rng = np.random.RandomState(seed)
    slots, bs = int(rng.randint(1, 5)), int(rng.randint(2, 5))
    max_len = 24
    prompts = [rng.randint(0, V, size=int(rng.randint(1, 13)))
               for _ in range(int(rng.randint(1, 8)))]
    quotas = [int(rng.randint(0, 7)) for _ in prompts]
    nb_lane = -(-max_len // bs)
    need = max(-(-(len(p) + q - 1) // bs) for p, q in zip(prompts, quotas))
    num_blocks = int(rng.randint(max(need, 1), slots * nb_lane + 1))
    chunk = int(rng.randint(1, 6)) if rng.rand() < 0.6 else None
    if rng.rand() < 0.25:
        num_blocks = None                       # dense: no block pool
    return slots, bs, max_len, prompts, quotas, nb_lane, num_blocks, chunk


@pytest.mark.parametrize("seed", range(24))
def test_scheduler_matches_reference_on_a_stub_model(seed):
    """Random workloads (prompt lengths 1-12, quotas 0-6 including
    zero-quota and quota-1 requests, 1-4 lanes, pools from the smallest
    that fits one request to the worst case or no pool at all, chunked or
    not): the port's
    Scheduler admits, grows, retires and backpressures exactly as the
    reference's — the same tokens and the same counters."""
    (slots, bs, max_len, prompts, quotas, nb_lane, num_blocks,
     chunk) = _workload(seed)
    kw = dict(scheduler="continuous", batch_slots=slots, max_len=max_len,
              prefill_chunk=chunk)

    def requests(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=q)
                for i, (p, q) in enumerate(zip(prompts, quotas))]

    def bind(fn):
        return lambda params, *args: fn(*args)

    jadmit, jdecode, jchunk = _stub_steps(_jnext)
    jreqs = requests(JRequest)
    jstats = jserve(None, bind(jadmit), bind(jdecode), lambda b: {}, None,
                    jreqs, block_pool=num_blocks and JBlockPool(
                        num_blocks, bs, slots, nb_lane),
                    chunk_step=bind(jchunk) if chunk else None, **kw)
    tadmit, tdecode, tchunk = _stub_steps(_tnext)
    treqs = requests(Request)
    tstats = serve(None, bind(tdecode), lambda b: {}, None, treqs,
                   admit_step=bind(tadmit),
                   block_pool=num_blocks and BlockPool(num_blocks, bs,
                                                       slots, nb_lane),
                   chunk_step=bind(tchunk) if chunk else None, device=CPU,
                   **kw)
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens_out == jr.tokens_out, tr.rid
    for field in ("tokens_generated", "decode_steps", "prefill_calls",
                  "chunk_steps", "blocks_in_use", "block_fragmentation",
                  "slot_utilization", "queue_wait_steps"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    for rid, lat in jstats.request_latency.items():
        assert vars(tstats.request_latency[rid]) == vars(lat), rid
