"""The int8 emit of the decode-attention kernels (K5, K6, K7): the
``wo_in`` quantize (K4) folded into their merge at decode rows, on the CPU.

* The emitting plain versions (``ops.int8_attend_decode`` /
  ``ops.paged_int8_attend_decode`` / ``ops.paged_attend_decode`` with
  ``out_scale``) equal the reference's (dequantize-then-)attend oracles
  followed by its ``peg_quantize_ref``, bit for bit, at kv 8 and 4 and on
  f32 and bf16 arenas, with each site: the f32 outputs of the two packages
  differ in the last bits (their float reductions run in other orders), so
  the output grid is one on which no value lies within that difference of
  a rounding tie.
* A deploy decode step of the reduced gemma2-2b through ``attention_block``
  with the fused path equals the same step with it turned off (the f32
  output, then ``quantize_act``): every int8 matmul input, the ``wo`` input
  among them, and the logits are the same; the fused path is taken at
  every attention layer (int8 and int4 caches, dense and paged, and the
  paged f32 cache of ``--kv-bits 16``).
* The same deploy model serving the README quickstart's workload through
  the in-place cache writers gives the greedy tokens and the final caches
  of the functional writers they replaced (``tests/torch_cache_oracle.py``),
  continuous and static, paged and dense, kv 8 and 16.

The on-card comparison of the emit with K4's kernel on the same call's
f32 output is in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core import Mode, QTensor, QuantCtx, build_deploy, ptq
from repro_torch.core import deploy, peg_policy
from repro_torch.kernels import nibble, ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm

pytestmark = [pytest.mark.deploy, pytest.mark.paged]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SITES = {
    "none": {},
    "softmax_in": dict(sm_quant=np.array([0.05, 128.0], np.float32),
                       sm_qmin=0, sm_qmax=255),
    "softmax_out": dict(sm_quant=np.array([0.05, 128.0], np.float32),
                        sm_qmin=0, sm_qmax=255,
                        smo_quant=np.array([1 / 255, 0.0], np.float32),
                        smo_qmin=0, smo_qmax=255),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tie_free_grid(want, got):
    """An int8 output scale (a divisor of max|want| near 1/40 of it) on
    which no value of ``want`` lies within |want - got| of a rounding
    tie, so both quantize to the same grid point."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    margin = np.abs(want - got).max()
    for c in range(37, 80):
        s = np.float32(np.abs(want).max() / c)
        frac = np.abs(np.abs(want / s) % 1.0 - 0.5)
        if (frac * s).min() > 2 * margin + 1e-6 * s:
            return s
    raise AssertionError("no tie-free output grid")


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_emitting_plain_versions_match_reference_oracles(paged, kv_bits,
                                                         site):
    """An empty prefix, an idle lane, zero-points with the sites; paged: a
    permuted table with an unmapped tail and a lane past its ring."""
    rng = np.random.RandomState(11 + kv_bits + 3 * paged)
    b, kv, g, hd, s_len = 4, 2, 2, 16, 64
    nb, bs = 8, 8
    cells = (b * nb + 2, bs) if paged else (b, s_len)
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)

    def payload():
        x = rng.randint(lo, hi, (*cells, kv, hd)).astype(np.int8)
        return nibble.pack_nibbles(_t(x)).numpy() if kv_bits == 4 else x
    zlim = 3 if kv_bits == 4 else 20
    zps = {}
    if site != "none":
        zps = dict(q_zp=np.round(rng.uniform(-20, 20, (b, kv, g))),
                   k_zp=np.round(rng.uniform(-zlim, zlim, (b, kv))),
                   v_zp=np.round(rng.uniform(-zlim, zlim, (b, kv))))
        zps = {k: v.astype(np.float32) for k, v in zps.items()}
    args = [rng.randint(-128, 128, (b, kv, g, hd)).astype(np.int8),
            (rng.uniform(0.01, 0.03, (b, kv, g)) / 4).astype(np.float32),
            payload(), rng.uniform(0.01, 0.05, (*cells, kv)).astype(
                np.float32),
            payload(), rng.uniform(0.01, 0.05, (*cells, kv)).astype(
                np.float32)]
    kw = dict(window=None, logit_softcap=50.0, kv_bits=kv_bits)
    if paged:
        table = rng.permutation(cells[0])[:b * nb].reshape(b, nb).astype(
            np.int32)
        table[0, -1] = -1
        args += [table, np.array([nb * bs + 9, 3, nb * bs - 1, -1],
                                 np.int32)]
        kw["s_cap"] = nb * bs
        fn, oracle = ops.paged_int8_attend_decode, \
            jref.paged_int8_attend_decode_ref
    else:
        k_pos = np.tile(np.arange(s_len, dtype=np.int32), (b, 1))
        k_pos[1, :5] = -1
        args += [k_pos, np.array([s_len - 1, s_len - 7, 20, -1], np.int32)]
        fn, oracle = ops.int8_attend_decode, jref.int8_attend_decode_ref
    tkw = dict(kw, **{k: _t(v) for k, v in zps.items()},
               **{k: _t(v) if isinstance(v, np.ndarray) else v
                  for k, v in SITES[site].items()})
    jkw = dict(kw, **{k: jnp.asarray(v) for k, v in zps.items()},
               **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in SITES[site].items()})
    f = fn(*map(_t, args), **tkw).numpy()
    want_f = np.asarray(oracle(*map(jnp.asarray, args), **jkw))
    s_o = _tie_free_grid(want_f, f)
    z_o = np.float32(-3.0)
    got = fn(*map(_t, args), **tkw, out_scale=_t(s_o), out_zp=_t(z_o),
             qmin=-128, qmax=127)
    want = jref.peg_quantize_ref(jnp.asarray(want_f.reshape(b, -1)),
                                 jnp.asarray([s_o]), jnp.asarray([z_o]),
                                 qmin=-128, qmax=127)
    assert got.dtype == torch.int8 and got.shape == (b, kv * g * hd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emitting_k7_plain_version_matches_reference_oracle(dtype, site):
    """K7 (paged f32 / bf16 arenas): a permuted table with an unmapped
    tail, a lane past its ring, an idle lane."""
    rng = np.random.RandomState(23 + len(site))
    b, kv, g, hd, nb, bs = 4, 2, 2, 16, 8, 8
    n_blocks = b * nb + 2
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    q = (rng.randn(b, kv, g, hd) * 0.3).astype(np.float32)
    k, v = (_t(rng.randn(n_blocks, bs, kv, hd).astype(np.float32)).to(
        tdt).float().numpy() for _ in range(2))
    table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[0, -1] = -1
    q_pos = np.array([nb * bs + 9, 3, nb * bs - 1, -1], np.int32)
    kw = dict(s_cap=nb * bs, window=None, logit_softcap=50.0)
    tkw = dict(kw, **{k_: _t(v_) if isinstance(v_, np.ndarray) else v_
                      for k_, v_ in SITES[site].items()})
    jkw = dict(kw, **{k_: jnp.asarray(v_) if isinstance(v_, np.ndarray)
                      else v_ for k_, v_ in SITES[site].items()})
    targs = (_t(q), _t(k).to(tdt), _t(v).to(tdt), _t(table), _t(q_pos))
    f = ops.paged_attend_decode(*targs, **tkw).numpy()
    want_f = np.asarray(jref.paged_attend_decode_ref(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(table), jnp.asarray(q_pos), **jkw))
    s_o = _tie_free_grid(want_f, f)
    z_o = np.float32(-3.0)
    got = ops.paged_attend_decode(*targs, **tkw, out_scale=_t(s_o),
                                  out_zp=_t(z_o), qmin=-128, qmax=127)
    want = jref.peg_quantize_ref(jnp.asarray(want_f.reshape(b, -1)),
                                 jnp.asarray([s_o]), jnp.asarray([z_o]),
                                 qmin=-128, qmax=127)
    assert got.dtype == torch.int8 and got.shape == (b, kv * g * hd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def reduced_deploy():
    """The reduced gemma2-2b, PTQ-calibrated with the PEG recipe and packed
    for the integer deploy path, as the launcher builds it."""
    cfg = get_config("gemma2-2b").reduced()
    pol = peg_policy(4)
    flat = tfm.init_params(cfg, 0, stacked=False, dtype=torch.float32,
                           device="cpu")
    rng = np.random.RandomState(10)
    calib = [{"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                                    (2, 12)))}
             for _ in range(2)]
    qm = ptq(lambda p, b, c: tfm.forward(cfg, p, b["tokens"], ctx=c)[0],
             flat, calib, pol, collect_inputs=True)
    shared = {}
    for site, qp in qm.act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        shared.setdefault(base, qp)
    params = tfm.init_params(cfg, 0, stacked=True, dtype=torch.float32,
                             device="cpu")
    packed, acts = build_deploy(cfg, params, pol, shared)
    assert acts["layer/attn/wo_in"].per_tensor

    def ctx():
        return QuantCtx(policy=pol, mode=Mode.DEPLOY, act_state=shared,
                        deploy_acts=acts)
    return cfg, packed, ctx


@pytest.mark.parametrize("paged,kv_bits", [
    (False, 8), (True, 8), (False, 4), (True, 4), (True, 16)])
def test_fused_wo_emit_matches_the_unfused_decode_step(reduced_deploy,
                                                       monkeypatch, paged,
                                                       kv_bits):
    cfg, packed, ctx = reduced_deploy
    B, T = 3, 20
    toks = torch.as_tensor(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (B, T)))
    cache = tfm.init_cache(cfg, B, 64, dtype=torch.float32, kv_bits=kv_bits,
                           paged=paged, block_size=8, device="cpu")
    logits, cache = tfm.prefill(cfg, packed, toks, cache, ctx=ctx())
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.full((B, 1), T, dtype=torch.int32)
    pos[2] = -1                                          # an idle lane

    inputs, results = [], []
    matmul, decode_attend = deploy.matmul, attn._kernel_decode_attend

    def record_matmul(x, w, **kw):
        inputs.append(x.q.clone())
        return matmul(x, w, **kw)

    def record_attend(*args):
        out = decode_attend(*args)
        results.append(isinstance(out, QTensor))
        return out

    def unfused_attend(*args):       # the call without wo's quantizer
        out = decode_attend(*args[:8])
        results.append(isinstance(out, QTensor))
        return out
    monkeypatch.setattr(deploy, "matmul", record_matmul)
    monkeypatch.setattr(attn, "_kernel_decode_attend", record_attend)
    # each step on its own copy: a step writes its cache in place
    fused, _ = tfm.decode_step(cfg, packed, cur, pos,
                               tfm.clone_cache(cache), ctx=ctx())
    fused_inputs, inputs[:] = list(inputs), []
    assert results == [True] * cfg.num_layers
    results.clear()
    monkeypatch.setattr(attn, "_kernel_decode_attend", unfused_attend)
    unfused, _ = tfm.decode_step(cfg, packed, cur, pos,
                                 tfm.clone_cache(cache), ctx=ctx())
    assert results == [False] * cfg.num_layers
    assert len(fused_inputs) == len(inputs) > 4 * cfg.num_layers - 1
    for a, b in zip(fused_inputs, inputs):
        assert torch.equal(a, b)
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("scheduler,kv_bits,paged", [
    ("continuous", 8, True), ("continuous", 16, True),
    ("continuous", 8, False), ("static", 8, False), ("static", 16, True)])
def test_in_place_writes_serve_as_the_functional_writers(reduced_deploy,
                                                         monkeypatch,
                                                         scheduler, kv_bits,
                                                         paged):
    """The quickstart workload (6 requests x 24 prompt tokens x 6 new, 4
    lanes, block size 8, chunks of 8, max_len 64) served once with the
    in-place cache writers and once through the functional writers: the
    same greedy tokens and the final caches equal bit for bit."""
    from torch_cache_oracle import use_functional_writers
    from repro_torch.runtime import (BlockPool, Request, make_admit_step,
                                     make_chunk_prefill_step,
                                     make_decode_step, make_prefill_step,
                                     serve)
    cfg, packed, ctx = reduced_deploy
    max_len, bs, slots = 64, 8, 4
    nb_lane = tfm.paged_lane_blocks(cfg, max_len, bs)
    pool_kw = (dict(num_blocks=slots * nb_lane, mapped=False)
               if paged and scheduler == "continuous" else {})

    def run():
        caches = []

        def init(b):
            caches.append(tfm.init_cache(
                cfg, b, max_len, dtype=torch.float32, kv_bits=kv_bits,
                paged=paged, block_size=bs, device="cpu", **pool_kw))
            return caches[-1]
        rng = np.random.RandomState(0)
        reqs = [Request(rid=i, prompt=rng.randint(10, cfg.vocab_size,
                                                  size=24),
                        max_new_tokens=6) for i in range(6)]
        serve(make_prefill_step(cfg, ctx_factory=ctx),
              make_decode_step(cfg, ctx_factory=ctx), init, packed, reqs,
              scheduler=scheduler, batch_slots=slots, max_len=max_len,
              admit_step=make_admit_step(cfg, ctx_factory=ctx),
              chunk_step=make_chunk_prefill_step(cfg, ctx_factory=ctx),
              block_pool=(BlockPool(slots * nb_lane, bs, slots, nb_lane)
                          if pool_kw else None),
              prefill_chunk=8 if scheduler == "continuous" else None,
              device="cpu")
        return [r.tokens_out for r in reqs], caches
    got_tokens, got = run()
    use_functional_writers(monkeypatch)
    want_tokens, want = run()
    assert got_tokens == want_tokens
    assert all(len(t) == 6 for t in got_tokens)
    for a, b in zip(got, want):
        leaves = [(x, y) for m, n in zip(tfm._cache_nodes(a),
                                         tfm._cache_nodes(b))
                  for x, y in zip(m, n)]
        assert leaves and all(torch.equal(x, y) for x, y in leaves)
