"""The single-device variants against the reference, on the CPU: banded
sliding-window attention (``attention._banded_attend`` and the
``chunked="banded"`` dispatch of ``attend``), int8 weight storage
(``common.quantize_weight_int8`` through ``resolve_weight`` at every
attention and FFN site), the window-sized paged arenas of an all-window
model (h2o-danube3-4b reduced: every layer windowed at 16) and
``examples/torch_serve_quantized.py``.

Weights are carried across from the reference (``repro_torch.convert``):
the two packages draw different random numbers. Inputs come from numpy
seeds. Tolerances: attention outputs within 1e-5 (absolute and relative,
the reference's test), model logits within 1e-4 of max|logits|, int8
payloads bit for bit, greedy tokens identical.
"""
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.models.common import quantize_weight_int8 as jquantize
from repro.models.common import resolve_weight as jresolve
from repro.runtime import BlockPool as JBlockPool
from repro.runtime import Request as JRequest
from repro.runtime.serve_loop import _check_capacity as j_check_capacity
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import Mode, QuantCtx, w8a8_policy
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (quantize_stacked_int8,
                                       quantize_weight_int8, resolve_weight)
from repro_torch.runtime import (BlockPool, RadixCache, Request,
                                 make_admit_step, make_chunk_prefill_step,
                                 make_decode_step, make_prefill_step, serve)
from repro_torch.runtime.serve_loop import _check_capacity
from test_prefix_cache import _mk_shared_reqs as jmk_shared_reqs
from test_prefix_cache import _serve_real as jserve_real

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, port cfg, reference f32 params, the same
    carried across)} for the reduced configs, stacked."""
    made = {}

    def get(arch, seed=0):
        if (arch, seed) not in made:
            jcfg = jget_config(arch).reduced()
            cfg = get_config(arch).reduced()
            jp = jtfm.init_params(jcfg, jax.random.PRNGKey(seed),
                                  stacked=True, dtype=jnp.float32)
            made[arch, seed] = (jcfg, cfg, jp, params_from_jax(_np(jp), CPU))
        return made[arch, seed]
    return get


# ---------------------------------------------------------------------------
# Banded sliding-window attention
# ---------------------------------------------------------------------------

def _qkv(B, T, S, H, KV, hd, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H, hd).astype(np.float32),
            rng.randn(B, S, KV, hd).astype(np.float32),
            rng.randn(B, S, KV, hd).astype(np.float32))


class TestBandedAttention:
    @pytest.mark.parametrize("T,W,block", [(96, 24, 16), (128, 32, 32),
                                           (90, 17, 16)])
    def test_matches_reference_and_dense(self, T, W, block):
        """The reference's three shapes (one not a multiple of the block):
        the port's banded attend against the reference's and against the
        port's dense attend."""
        B, H, KV, hd = 2, 4, 2, 16
        q, k, v = _qkv(B, T, T, H, KV, hd)
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
        want = jattn._banded_attend(
            *(jnp.asarray(a) for a in (q, k, v, pos, pos)),
            jattn.AttnConfig(H, KV, hd, window=W), block=block)
        cfg = attn.AttnConfig(H, KV, hd, window=W)
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (q, k, v, pos, pos)]
        got = attn._banded_attend(*args, cfg, block=block)
        dense = attn._dense_attend(*args, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_model_level_banded_matches(self, models):
        """Reduced h2o-danube3-4b (window 16) at T 40: the port's
        ``forward(chunked="banded")`` against the reference's and against
        the port's default forward."""
        jcfg, cfg, jp, tp = models("h2o-danube3-4b")
        toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 40))
        want, _ = jtfm.forward(jcfg, jp, jnp.asarray(toks), chunked="banded")
        with torch.no_grad():
            got, _ = tfm.forward(cfg, tp, torch.as_tensor(toks),
                                 chunked="banded")
            plain, _ = tfm.forward(cfg, tp, torch.as_tensor(toks))
        assert _rel(got, want) <= 1e-4
        assert _rel(got, plain) <= 1e-4

    @pytest.mark.parametrize("layout", ["stacked", "unrolled", "remat"])
    def test_forward_reaches_the_banded_attend(self, models, monkeypatch,
                                               layout):
        """``chunked="banded"`` reaches ``attend`` in every layer on the
        stacked, unrolled and remat paths, and the banded attend runs."""
        _, cfg, _, tp = models("h2o-danube3-4b")
        if layout == "unrolled":
            tp = tfm.init_params(cfg, 0, stacked=False, dtype=torch.float32,
                                 device=CPU)
        calls = []
        real = attn._banded_attend

        def counted(*a, **kw):
            calls.append(a[0].shape)
            return real(*a, **kw)
        monkeypatch.setattr(attn, "_banded_attend", counted)
        toks = torch.as_tensor(np.random.RandomState(2).randint(
            0, cfg.vocab_size, (2, 24)))
        if layout == "remat":
            loss = tfm.train_loss(cfg, tp, {"tokens": toks, "labels": toks},
                                  remat=True, chunked="banded")
            assert torch.isfinite(loss)
        else:
            with torch.no_grad():
                tfm.forward(cfg, tp, toks, chunked="banded")
        n_attn = sum(k in tfm.ATTN_KINDS for k in cfg.layer_plan)
        assert n_attn == cfg.num_layers
        assert len(calls) >= n_attn

    def test_banded_falls_back_when_T_differs_from_S(self, monkeypatch):
        """``attend(chunked="banded")`` with T != S (a cached or appended
        prefill) takes the reference's automatic choice, the dense attend
        at this size, and never the banded one."""
        B, T, S, H, KV, hd, W = 2, 24, 40, 4, 2, 16, 8
        q, k, v = _qkv(B, T, S, H, KV, hd, seed=3)
        qp = np.broadcast_to(np.arange(S - T, S, dtype=np.int32), (B, T))
        kp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                            jattn.AttnConfig(H, KV, hd, window=W),
                            chunked="banded")
        cfg = attn.AttnConfig(H, KV, hd, window=W)
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (q, k, v, qp, kp)]

        def refuse(*a, **kw):
            raise AssertionError("the banded attend ran with T != S")
        monkeypatch.setattr(attn, "_banded_attend", refuse)
        got = attn.attend(*args, cfg, chunked="banded")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.numpy(),
                                      attn._dense_attend(*args, cfg).numpy())

    @pytest.mark.parametrize("T,S,W,banded_runs", [
        (40, 40, 8, True),         # self-attention past the window
        (24, 40, 8, False),        # a cached or appended prefill
        (16, 16, 16, False)])      # within the window
    def test_banded_flag_dispatches_as_chunked_banded(self, monkeypatch, T,
                                                      S, W, banded_runs):
        """``attend(banded=True)`` (the reference's signature) takes the
        same path as ``chunked="banded"``, with and without ``chunked=True``
        beside it, and both give the reference's ``attend(banded=True)``:
        the banded attend where T == S > window, the automatic choice
        otherwise."""
        B, H, KV, hd = 2, 4, 2, 16
        q, k, v = _qkv(B, T, S, H, KV, hd, seed=5)
        qp = np.broadcast_to(np.arange(S - T, S, dtype=np.int32), (B, T))
        kp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                            jattn.AttnConfig(H, KV, hd, window=W),
                            banded=True)
        cfg = attn.AttnConfig(H, KV, hd, window=W)
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (q, k, v, qp, kp)]
        calls, real = [], attn._banded_attend

        def counted(*a, **kw):
            calls.append(a[0].shape)
            return real(*a, **kw)
        monkeypatch.setattr(attn, "_banded_attend", counted)
        outs = [attn.attend(*args, cfg, **kw).numpy()
                for kw in (dict(banded=True), dict(chunked="banded"),
                           dict(banded=True, chunked=True))]
        assert len(calls) == (3 if banded_runs else 0)
        np.testing.assert_array_equal(outs[0], outs[1])
        if banded_runs:
            np.testing.assert_array_equal(outs[0], outs[2])
        np.testing.assert_allclose(outs[0], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    def test_cached_prefill_given_banded_equals_plain(self, models):
        """A prefill into a cache (T != S) given ``chunked="banded"``
        falls back as the reference does: the same logits as without."""
        _, cfg, _, tp = models("h2o-danube3-4b")
        toks = torch.as_tensor(np.random.RandomState(4).randint(
            0, cfg.vocab_size, (2, 20)))
        outs = []
        with torch.no_grad():
            for chunked in ("banded", None):
                cache = tfm.init_cache(cfg, 2, 32, dtype=torch.float32,
                                       device=CPU)
                outs.append(tfm.prefill(cfg, tp, toks, cache,
                                        chunked=chunked)[0])
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Int8 weight storage
# ---------------------------------------------------------------------------

def _quantize_tree(params, fn):
    """Every stacked attention and FFN weight (L, in, out) of width >= 64
    stored as int8 through ``fn`` (the reference test's rule)."""
    out = {k: v for k, v in params.items() if k != "scan"}
    out["scan"] = []
    for g in params["scan"]:
        g = dict(g)
        for blk in ("attn", "ffn"):
            if blk in g:
                g[blk] = {name: fn(w) if w.ndim == 3 and w.shape[-1] >= 64
                          else w for name, w in g[blk].items()}
        out["scan"].append(g)
    return out


class TestInt8WeightStorage:
    @pytest.mark.parametrize("shape", [(128, 64), (96, 40)])
    def test_quantize_weight_int8_bit_for_bit(self, shape):
        w = (np.random.RandomState(0).randn(*shape) / 8).astype(np.float32)
        want = jquantize(jnp.asarray(w))
        got = quantize_weight_int8(torch.from_numpy(w))
        assert got["q"].dtype == torch.int8 and got["s"].dtype == \
            torch.float32
        np.testing.assert_array_equal(got["q"].numpy(),
                                      np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(),
                                      np.asarray(want["s"]))

    def test_resolve_weight_roundtrip(self):
        """The reference's test on its own input: per-out-channel int8 is
        within half a scale plus the bf16 dequantization's 2^-8 relative
        rounding. On a numpy input (where the reference's result exceeds
        that bound too: its two bf16 roundings, of the scale and of the
        product, add up to more than 2^-8 of a value just above a power of
        two) the port's bf16 and f32 dequantizations equal the reference's
        eager and compiled ones bit for bit."""
        w = np.array(jax.random.normal(jax.random.PRNGKey(0), (128, 64))
                     / 8)
        qw = quantize_weight_int8(torch.from_numpy(w))
        assert qw["q"].dtype == torch.int8
        err = np.abs(w - resolve_weight(qw).float().numpy())
        amax = np.abs(w).max(axis=0)
        bound = qw["s"].numpy()[0] * 0.51 + amax * 2.0 ** -8 + 1e-4
        assert np.all(err <= bound[None, :])
        w = (np.random.RandomState(0).randn(128, 64) / 8).astype(np.float32)
        qw = quantize_weight_int8(torch.from_numpy(w))
        jq = jquantize(jnp.asarray(w))
        np.testing.assert_array_equal(resolve_weight(qw).float().numpy(),
                                      np.asarray(jresolve(jq), np.float32))
        np.testing.assert_array_equal(
            resolve_weight(qw, torch.float32).numpy(),
            np.asarray(jax.jit(lambda p: jresolve(p).astype(jnp.float32))(
                jq)))

    def test_stacked_payloads_slice_per_layer(self, models):
        """``quantize_stacked_int8`` is the reference's ``jax.vmap`` of
        the quantizer, and the layer views of the forward (``_unstack``)
        and of the cached steps (``_layer``) slice its payloads."""
        jcfg, cfg, jp, tp = models("internlm2-20b")
        w = jp["scan"][0]["attn"]["wq"]
        want = jax.vmap(jquantize)(w)
        got = quantize_stacked_int8(tp["scan"][0]["attn"]["wq"])
        for k in ("q", "s"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        tree = {"attn": {"wq": got}}
        n = got["q"].shape[0]
        for s, view in enumerate(tfm._unstack(tree, n)):
            one = quantize_weight_int8(tp["scan"][0]["attn"]["wq"][s])
            for src in (view, tfm._layer(tree, s)):
                for k in ("q", "s"):
                    torch.testing.assert_close(src["attn"]["wq"][k], one[k],
                                               rtol=0, atol=0)

    def test_forward_with_int8_weights(self, models):
        """Reduced internlm2-20b with int8-stored weights: the port's
        forward within 1e-4 of max|logits| of the reference's on the same
        params and payloads, and correlated > 0.99 with the f32 forward
        (the reference's gate)."""
        jcfg, cfg, jp, tp = models("internlm2-20b")
        toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 12))
        jpq = _quantize_tree(jp, jax.vmap(jquantize))
        tpq = _quantize_tree(tp, quantize_stacked_int8)
        assert isinstance(tpq["scan"][0]["ffn"]["w_gate"], dict)
        want, _ = jtfm.forward(jcfg, jpq, jnp.asarray(toks))
        with torch.no_grad():
            got, _ = tfm.forward(cfg, tpq, torch.as_tensor(toks))
            ref, _ = tfm.forward(cfg, tp, torch.as_tensor(toks))
        assert _rel(got, want) <= 1e-4
        corr = np.corrcoef(ref.numpy().reshape(-1),
                           got.numpy().reshape(-1))[0, 1]
        assert corr > 0.99

    def test_every_site_dequantizes(self, models):
        """The float and fake-quant (APPLY) paths and the cached steps on
        int8-stored weights equal the same paths on the weights
        dequantized up front: every attention and FFN site resolves its
        payload before its matmul."""
        _, cfg, _, tp = models("internlm2-20b")
        tpq = _quantize_tree(tp, quantize_stacked_int8)
        deq = dict(tpq, scan=[dict(g, **{
            blk: {n: resolve_weight(w, torch.float32)
                  for n, w in g[blk].items()} for blk in ("attn", "ffn")})
            for g in tpq["scan"]])
        toks = torch.as_tensor(np.random.RandomState(5).randint(
            0, cfg.vocab_size, (2, 10)))

        def apply_ctx():
            return QuantCtx(policy=w8a8_policy(), mode=Mode.APPLY,
                            act_state={})
        with torch.no_grad():
            for ctx in (None, apply_ctx):
                a = tfm.forward(cfg, tpq, toks, ctx=ctx and ctx())[0]
                b = tfm.forward(cfg, deq, toks, ctx=ctx and ctx())[0]
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            logits = []
            for p in (tpq, deq):
                cache = tfm.init_cache(cfg, 2, 16, dtype=torch.float32,
                                       device=CPU)
                lp, cache = tfm.prefill(cfg, p, toks[:, :8], cache)
                pos = torch.full((2, 1), 8, dtype=torch.int32)
                ld, _ = tfm.decode_step(cfg, p, toks[:, 8:9], pos, cache)
                logits.append((lp, ld))
        for a, b in zip(*logits):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Window-sized arenas (the reference's TestWindowArenaSizing): every layer
# of the reduced h2o-danube3-4b is windowed at 16, so a paged lane needs
# only ceil(16 / 8) = 2 blocks however long the decode
# ---------------------------------------------------------------------------

MAX_LEN, BS = 32, 8


def _mk_shared_reqs(seed, cfg, specs, shared=8):
    """The reference helper's prompts (the same RandomState draws) as the
    port's requests."""
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens)
            for r in jmk_shared_reqs(seed, cfg, specs, shared)]


def _serve_port(cfg, params, reqs, *, batch_slots=2,
                scheduler="continuous", prefix=True, num_blocks=None):
    """The reference's ``_serve_real`` on the port: paged continuous
    serving (with or without the radix cache), or the dense static
    scheduler."""
    pool = radix = None
    if scheduler == "continuous":
        width = tfm.paged_lane_blocks(cfg, MAX_LEN, BS)
        num_blocks = num_blocks or batch_slots * width
        pool = BlockPool(num_blocks, BS, batch_slots, width)
        radix = RadixCache(BS) if prefix else None

    def init(b):
        if pool is None:
            return tfm.init_cache(cfg, b, MAX_LEN, dtype=torch.float32,
                                  device=CPU)
        return tfm.init_cache(cfg, b, MAX_LEN, dtype=torch.float32,
                              paged=True, block_size=BS,
                              num_blocks=num_blocks, mapped=False, device=CPU)
    paged = pool is not None
    stats = serve(
        make_prefill_step(cfg), make_decode_step(cfg), init, params, reqs,
        scheduler=scheduler, batch_slots=batch_slots, max_len=MAX_LEN,
        admit_step=make_admit_step(cfg),
        chunk_step=make_chunk_prefill_step(cfg) if paged else None,
        block_pool=pool, radix_cache=radix,
        write_caps=tfm.attn_write_caps(cfg, MAX_LEN, BS) if paged else None,
        ring_tokens=tfm.paged_ring_tokens(cfg, MAX_LEN, BS) if paged
        else None,
        copy_block_fn=tfm.cache_copy_block if radix is not None else None,
        device=CPU)
    return stats, pool


@pytest.mark.serve
@pytest.mark.paged
class TestWindowArenaSizing:
    def test_sizing_helpers(self):
        g, jg = get_config("gemma2-2b").reduced(), \
            jget_config("gemma2-2b").reduced()    # window 16 + global mix
        h, jh = get_config("h2o-danube3-4b").reduced(), \
            jget_config("h2o-danube3-4b").reduced()   # all layers window 16
        for fn, want_g, want_h in (("paged_lane_blocks", 4, 2),
                                   ("attn_write_caps", [16, 32], [16]),
                                   ("paged_ring_tokens", None, 16)):
            port, ref = getattr(tfm, fn), getattr(jtfm, fn)
            assert port(g, MAX_LEN, BS) == ref(jg, MAX_LEN, BS) == want_g
            assert port(h, MAX_LEN, BS) == ref(jh, MAX_LEN, BS) == want_h

    def test_init_cache_table_width_is_ring_bound(self, models):
        jcfg, cfg, _, _ = models("h2o-danube3-4b", 1)
        want = jtfm.init_cache(jcfg, 1, MAX_LEN, dtype=jnp.float32,
                               paged=True, block_size=BS, num_blocks=4,
                               mapped=False)
        got = tfm.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32,
                             paged=True, block_size=BS, num_blocks=4,
                             mapped=False, device=CPU)
        assert tuple(got["block_table"].shape) == \
            tuple(want["block_table"].shape) == (1, 2)
        np.testing.assert_array_equal(got["block_table"].numpy(),
                                      np.asarray(want["block_table"]))

    def test_capacity_check_uses_ring_clamp(self):
        """A request that needs 24 cells unclamped does not fit a 4-block
        pool of 2-block lanes; ring-clamped at 16 it does, in both
        packages."""
        for cls, pool, check in (
                (Request, BlockPool(4, BS, 2, 2), _check_capacity),
                (JRequest, JBlockPool(4, BS, 2, 2), j_check_capacity)):
            reqs = [cls(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                        max_new_tokens=20)]
            with pytest.raises(ValueError, match="blocks"):
                check(reqs, MAX_LEN, pool)
            check(reqs, MAX_LEN, pool, ring_tokens=16)

    def test_ring_clamped_serving_matches_dense(self, models):
        """Decodes far past the window serve from 2-block lanes (the
        unclamped worst case, 3 blocks, would not even admit): the port's
        continuous paged run equals its dense static run and the
        reference's runs, token for token."""
        jcfg, cfg, jp, tp = models("h2o-danube3-4b", 1)
        specs = [(5, 20), (3, 18), (7, 12)]
        ref = jmk_shared_reqs(2, jcfg, specs, shared=2)
        jserve_real(jcfg, jp, ref, scheduler="static", prefix=False)
        jreqs = jmk_shared_reqs(2, jcfg, specs, shared=2)
        _, jpool = jserve_real(jcfg, jp, jreqs, prefix=False, num_blocks=4)
        base = _mk_shared_reqs(2, cfg, specs, shared=2)
        _serve_port(cfg, tp, base, scheduler="static", prefix=False)
        reqs = _mk_shared_reqs(2, cfg, specs, shared=2)
        _, pool = _serve_port(cfg, tp, reqs, prefix=False, num_blocks=4)
        assert pool.max_blocks_per_lane == jpool.max_blocks_per_lane == 2
        for r0, r1, b, r in zip(ref, jreqs, base, reqs):
            assert r0.tokens_out == r1.tokens_out
            assert b.tokens_out == r.tokens_out == list(r0.tokens_out), r.rid
            assert r.done
        assert pool.blocks_in_use == jpool.blocks_in_use == 0

    def test_prefix_sharing_with_ring_clamped_reservations(self, models):
        """Radix hits on the all-window model: reservations and
        copy-on-write allowances are ring-clamped; shared serving equals
        unshared serving and the reference's, and saves the same prefill
        tokens."""
        jcfg, cfg, jp, tp = models("h2o-danube3-4b", 1)
        specs = [(10, 2), (12, 3), (11, 4), (12, 2)]
        jreqs = jmk_shared_reqs(4, jcfg, specs)
        jstats, jpool = jserve_real(jcfg, jp, jreqs, num_blocks=6)
        plain = _mk_shared_reqs(4, cfg, specs)
        _serve_port(cfg, tp, plain, prefix=False, num_blocks=6)
        reqs = _mk_shared_reqs(4, cfg, specs)
        stats, pool = _serve_port(cfg, tp, reqs, num_blocks=6)
        for p, r, j in zip(plain, reqs, jreqs):
            assert p.tokens_out == r.tokens_out == list(j.tokens_out), r.rid
        assert stats.prefill_tokens_saved == jstats.prefill_tokens_saved > 0
        assert pool.blocks_reserved == jpool.blocks_reserved == 0


# ---------------------------------------------------------------------------
# examples/torch_serve_quantized.py
# ---------------------------------------------------------------------------

LABELS = ("FP32", "W8A8 PEG (K=4+P)", "int8 deploy")


def _load_example(name):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / "examples"))


def test_serve_quantized_example_on_the_cpu(monkeypatch):
    """At its defaults (reduced h2o-danube3-4b, 8 requests of 12 tokens, 8
    new), on the reference example's weights (``PRNGKey(0)``, both
    layouts) and calibration prompts (``PRNGKey(10 + i)``), carried across:
    the reference example's three lines, 64 tokens each, simulated
    against int8 deploy agreement of 100.0 %, and every label's greedy
    tokens equal to the reference example's."""
    ref, example = _load_example("serve_quantized"), \
        _load_example("torch_serve_quantized")
    jcfg = jget_config("h2o-danube3-4b").reduced()
    layouts = {stacked: params_from_jax(_np(jtfm.init_params(
        jcfg, jax.random.PRNGKey(0), stacked=stacked, dtype=jnp.float32)),
        CPU) for stacked in (True, False)}
    calib = [np.array(jax.random.randint(jax.random.PRNGKey(10 + i),
                                           (2, 12), 0, jcfg.vocab_size))
             for i in range(2)]
    monkeypatch.setattr(
        example.tfm, "init_params",
        lambda cfg, seed, *, stacked=True, **kw: layouts[stacked])
    monkeypatch.setattr(example, "calibration_tokens",
                        lambda cfg, prompt_len: calib)
    served, real_serve = [], ref.serve_batch

    def recorded(*a, **kw):
        out = real_serve(*a, **kw)
        served.append([list(map(int, r.tokens_out)) for r in a[3]])
        return out
    monkeypatch.setattr(ref, "serve_batch", recorded)
    ref_text, text = io.StringIO(), io.StringIO()
    with redirect_stdout(ref_text):
        ref.main([])
    with redirect_stdout(text):
        out = example.main([], device=CPU)
    text, ref_text = text.getvalue(), ref_text.getvalue()
    for label in LABELS:
        assert f"{label:<18s} 64 tokens in " in text, text
        assert f"{label:<18s} 64 tokens in " in ref_text, ref_text
    for line in ("greedy-token agreement FP32 vs quantized: ",
                 "greedy-token agreement simulated vs int8 deploy: "):
        got = [t for t in text.splitlines() if t.startswith(line)]
        want = [t for t in ref_text.splitlines() if t.startswith(line)]
        assert got == want and len(got) == 1, (got, want)
    assert "greedy-token agreement simulated vs int8 deploy: 100.0%" in text
    assert list(out.tokens) == list(LABELS)
    assert [[list(map(int, t)) for t in out.tokens[label]]
            for label in LABELS] == served
    assert all(sum(map(len, t)) == 64 for t in out.tokens.values())
