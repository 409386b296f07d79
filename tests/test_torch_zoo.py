"""The attention-decoder zoo against the reference, on the CPU: the four
configs (internlm2-20b and granite-20b with untied heads, GQA and MQA;
qwen3-moe-235b with QK-norm and 128-expert top-8 MoE; grok1-314b with
top-2 GELU experts, softcaps and scaled embeddings) at their reduced
widths, the MoE unit functions, the decode oracles past 8 query heads a
kv head, the launcher's quickstart and the deploy path's greedy tokens.

Weights and calibrated act states are carried across from the reference
(``repro_torch.convert``): the two packages draw different random numbers.
Tolerances: f32 logits within 1e-5 of max|logits| (XLA and PyTorch sum
rows in other orders); the train loss within rel 1e-6 and its gradients
within rel 1e-4 plus 1e-5 of the leaf's largest magnitude (elements near
zero carry only rounding); the MoE dispatch integers bit for bit; decode
against the dense forward below 5e-5 (the reference's bound).
"""
import dataclasses
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
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.runtime.steps import make_decode_step as jmake_decode
from repro.runtime.steps import make_prefill_step as jmake_prefill
from repro_torch.configs import get_config
from repro_torch.convert import act_state_from_jax, params_from_jax
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.kernels import int8_attend_decode as iad
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves, value_and_grad

pytestmark = [pytest.mark.deploy, pytest.mark.serve]

CPU = "cpu"
ARCHS = ["internlm2-20b", "granite-20b", "qwen3-moe-235b", "grok1-314b"]


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _close(got, want, rtol, atol=0.0):
    """|got - want| <= rtol |want| + atol max|want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.fixture(scope="module")
def models():
    """Per arch, built once: (reference cfg, port cfg, reference stacked
    params, the port's copy of them)."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jget_config(arch).reduced()
            jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
            built[arch] = (jcfg, get_config(arch).reduced(), jp,
                           params_from_jax(_np(jp), CPU))
        return built[arch]
    return get


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(arch):
    """Every field of the full and the reduced config, the MoE config's
    too, and the layer plan."""
    for full in (True, False):
        j, t = jget_config(arch), get_config(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_plan == j.layer_plan and t.hd == j.hd


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_layout(arch, models):
    """init_params draws the reference's tree: untied (d, V) lm_head,
    stacked (n, E, ...) experts, (n, hd) q_norm / k_norm, same shapes and
    dtypes in both layouts."""
    jcfg, cfg, jp, _ = models(arch)
    for stacked in (True, False):
        want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                            jtfm.init_params(jcfg, jax.random.PRNGKey(0),
                                             stacked=stacked,
                                             dtype=jnp.float32))
        got = tfm.init_params(cfg, 0, stacked=stacked, dtype=torch.float32,
                              device=CPU)
        got = jax.tree.map(lambda x: (tuple(x.shape), "float32"), got)
        assert got == want


def test_params_carry_across_lm_head(models):
    """The untied head crosses as a contiguous (d, V) tensor, values
    unchanged."""
    jcfg, cfg, jp, tp = models("internlm2-20b")
    head = tp["lm_head"]
    assert head.shape == (cfg.d_model, cfg.vocab_size) and \
        head.is_contiguous()
    np.testing.assert_array_equal(head.numpy(), np.asarray(jp["lm_head"]))


def test_params_carry_across_moe_leaves(models):
    """router (n, D, E) and the stacked experts (n, E, D, F) / (n, E, F, D)
    cross unchanged."""
    jcfg, cfg, jp, tp = models("qwen3-moe-235b")
    n, e, d, f = cfg.n_super, cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    shapes = {"router": (n, d, e), "w_gate": (n, e, d, f),
              "w_up": (n, e, d, f), "w_out": (n, e, f, d)}
    for name, shape in shapes.items():
        got = tp["scan"][0]["moe"][name]
        assert tuple(got.shape) == shape, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jp["scan"][0]["moe"][name]))


def test_params_carry_across_qk_norm(models):
    jcfg, cfg, jp, tp = models("qwen3-moe-235b")
    for name in ("q_norm", "k_norm"):
        got = tp["scan"][0]["attn"][name]
        assert tuple(got.shape) == (cfg.n_super, cfg.hd)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jp["scan"][0]["attn"][name]))


def test_qk_norm_gains_reach_the_forward(models):
    """A nonzero q_norm / k_norm gain moves the logits as in the
    reference (the per-head RMSNorm runs before RoPE)."""
    jcfg, cfg, jp, _ = models("qwen3-moe-235b")
    rng = np.random.RandomState(4)
    jp = jax.tree.map(lambda x: x, jp)
    for name in ("q_norm", "k_norm"):
        jp["scan"][0]["attn"][name] = jnp.asarray(
            rng.randn(cfg.n_super, cfg.hd).astype(np.float32) * 0.5)
    toks = rng.randint(0, cfg.vocab_size, (2, 10))
    jl, _ = jtfm.forward(jcfg, jp, jnp.asarray(toks))
    tl, _ = tfm.forward(cfg, params_from_jax(_np(jp), CPU),
                        torch.as_tensor(toks))
    assert _rel(jl, tl.numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# The reference's model tests on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, stacked, models):
    jcfg, cfg, jp, tp = models(arch)
    if not stacked:
        jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0), stacked=False,
                              dtype=jnp.float32)
        tp = params_from_jax(_np(jp), CPU)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 12))
    jl, _ = jtfm.forward(jcfg, jp, jnp.asarray(toks))
    tl, _ = tfm.forward(cfg, tp, torch.as_tensor(toks))
    assert tl.shape == (2, 12, cfg.vocab_size)
    assert _rel(jl, tl.numpy()) <= 1e-5


def _lm_batch(vocab, B=2, T=12, seed=2):
    toks = np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        np.int32)
    return toks


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_finite_and_grads_flow(arch, models):
    """The reference's test on the port, then the loss and every gradient
    against ``jax.value_and_grad`` of the reference's loss."""
    jcfg, cfg, jp, tp = models(arch)
    toks = _lm_batch(cfg.vocab_size)
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    loss, grads = value_and_grad(
        lambda p: tfm.train_loss(cfg, p, batch, remat=False), tp)
    assert torch.isfinite(loss)
    assert sum(float(torch.sum(torch.abs(g)))
               for g in tree_leaves(grads)) > 0
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.train_loss(jcfg, p, jb, remat=False)))(jp)
    _close(loss, jl, rtol=1e-6)
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(jg)}
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree_util.tree_leaves_with_path(
               jax.tree.map(lambda g: g.detach().numpy(), grads))}
    assert set(got) == set(want)
    for key, g in got.items():
        _close(g, want[key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_dense_forward(arch, models):
    """Prefill + T decode steps must equal the cache-free forward (the
    reference's test and bound, on the port)."""
    _, cfg, _, tp = models(arch)
    B, T, extra = 2, 12, 4
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, T + extra)))
    with torch.no_grad():
        full, _ = tfm.forward(cfg, tp, toks)
        cache = tfm.init_cache(cfg, B, 64, dtype=torch.float32, device=CPU)
        lp, cache = tfm.prefill(cfg, tp, toks[:, :T], cache)
        errs = [float((lp[:, -1] - full[:, T - 1]).abs().max())]
        for t in range(extra):
            pos = torch.full((B, 1), T + t, dtype=torch.int32)
            lg, cache = tfm.decode_step(cfg, tp, toks[:, T + t:T + t + 1],
                                        pos, cache)
            errs.append(float((lg[:, 0] - full[:, T + t]).abs().max()))
    assert max(errs) < 5e-5


# ---------------------------------------------------------------------------
# MoE units, bit for bit where integer
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    cfgs = [get_config(a).moe for a in ("qwen3-moe-235b", "grok1-314b")]
    cfgs += [c and get_config(a).reduced().moe
             for a, c in zip(("qwen3-moe-235b", "grok1-314b"), cfgs)]
    cfgs.append(moe.MoEConfig(num_experts=16, top_k=3, d_ff=8,
                              capacity_factor=0.7, min_capacity=2))
    for c in cfgs:
        jc = jmoe.MoEConfig(**dataclasses.asdict(c))
        for t in list(range(1, 130)) + [255, 256, 1000, 4096, 12345]:
            assert moe._capacity(t, c) == jmoe._capacity(t, jc), (c, t)


def _moe_params(rng, d, cfg):
    e, f = cfg.num_experts, cfg.d_ff
    return {"router": rng.randn(d, e).astype(np.float32) / np.sqrt(d),
            "w_gate": rng.randn(e, d, f).astype(np.float32) / np.sqrt(d),
            "w_up": rng.randn(e, d, f).astype(np.float32) / np.sqrt(d),
            "w_out": rng.randn(e, f, d).astype(np.float32) / np.sqrt(f)}


@pytest.mark.parametrize("norm_topk", [True, False])
def test_router_probs_keep_the_lower_expert_on_ties(norm_topk):
    """Duplicated router columns plant exact ties: top-k keeps the lower
    expert id first, as ``jax.lax.top_k`` does."""
    rng = np.random.RandomState(0)
    cfg = moe.MoEConfig(num_experts=8, top_k=4, d_ff=8, norm_topk=norm_topk)
    p = _moe_params(rng, 16, cfg)
    p["router"][:, 5] = p["router"][:, 2]
    p["router"][:, 7] = p["router"][:, 1]
    p["router"][:, 6] = p["router"][:, 1]
    x = rng.randn(32, 16).astype(np.float32)
    jc = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    jprobs, jtp, jte = jmoe.router_probs(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc)
    probs, tp, te = moe.router_probs(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x),
        cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    _close(probs, jprobs, rtol=1e-6)
    _close(tp, jtp, rtol=1e-6)
    assert (te.numpy()[:, :, None] == np.array([2, 5])).any(-1).sum() > 0


@pytest.mark.parametrize("capacity", [5, 2])
def test_dispatch_indices_match_reference_with_drops(capacity):
    """A skewed routing over 16 experts with capacity 5 or 2: order, slot,
    keep and token_of_row equal the reference's bit for bit, and rows
    drop."""
    rng = np.random.RandomState(1)
    t, k, e = 40, 8, 16
    w = np.linspace(3, 0.2, e)
    top_e = np.stack([rng.choice(e, k, replace=False, p=w / w.sum())
                      for _ in range(t)]).astype(np.int32)
    got = moe._dispatch_indices(torch.as_tensor(top_e), e, capacity)
    want = jmoe._dispatch_indices(jnp.asarray(top_e), e, capacity)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert not bool(got[2].all())


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_moe_apply_matches_reference(norm_topk, activation):
    """Top 3 of 8 experts, capacity 6 of 24 tokens (rows drop), with and
    without the top-k renormalisation."""
    rng = np.random.RandomState(2)
    cfg = moe.MoEConfig(num_experts=8, top_k=3, d_ff=32, norm_topk=norm_topk,
                        activation=activation, capacity_factor=0.75,
                        min_capacity=2)
    p = _moe_params(rng, 24, cfg)
    x = rng.randn(24, 24).astype(np.float32)
    jc = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    want = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jc)
    got = moe.moe_apply({k: torch.as_tensor(v) for k, v in p.items()},
                        torch.as_tensor(x), cfg)
    assert moe._capacity(24, cfg) < 24 * 3 // 8 + 8
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_moe_combine_is_deterministic_and_drops_rows():
    """Two calls give the same bits; a dropped row contributes nothing."""
    rng = np.random.RandomState(3)
    cfg = moe.MoEConfig(num_experts=4, top_k=2, d_ff=16, capacity_factor=0.5,
                        min_capacity=1)
    p = {k: torch.as_tensor(v) for k, v in _moe_params(rng, 8, cfg).items()}
    x = torch.as_tensor(rng.randn(20, 8).astype(np.float32))
    a, b = moe.moe_apply(p, x, cfg), moe.moe_apply(p, x, cfg)
    assert torch.equal(a, b)
    _, _, top_e = moe.router_probs(p, x, cfg)
    _, _, keep, _ = moe._dispatch_indices(top_e, 4, moe._capacity(20, cfg))
    assert int((~keep).sum()) > 0


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.RandomState(4)
    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_ff=8)
    logits = rng.randn(30, 8).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top_e = np.argsort(-probs, -1, kind="stable")[:, :2].astype(np.int32)
    want = jmoe.aux_load_balance_loss(
        jnp.asarray(probs), jnp.asarray(top_e),
        jmoe.MoEConfig(**dataclasses.asdict(cfg)))
    got = moe.aux_load_balance_loss(torch.as_tensor(probs),
                                    torch.as_tensor(top_e), cfg)
    _close(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The decode oracles past 8 query heads a kv head (hd 128)
# ---------------------------------------------------------------------------

SITES = {
    "one-pass": dict(sm_quant=np.array([0.05, 128.0], np.float32)),
    "two-pass": dict(sm_quant=np.array([0.05, 128.0], np.float32),
                     smo_quant=np.array([1 / 255, 0.0], np.float32)),
}


def _site(name, conv):
    return {k: conv(v) for k, v in SITES[name].items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_attend(got, want, smo_step, v_absmax):
    """Within 1e-5 of max|out|; two-pass: at most 0.1 % of the rows one
    softmax_out step x max|v| off (a probability on a grid tie)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    tol = 1e-5 * np.abs(want).max()
    if smo_step is None:
        assert err.max() <= tol, (err.max(), tol)
        return
    assert (err.max(axis=-1) > tol).sum() <= 1e-3 * err[..., 0].size
    assert err.max() <= smo_step * v_absmax * (1 + 1e-5)


def _int8_kv(rng, cells, kv, hd, kv_bits):
    """K/V payloads over ``cells`` (int8, or int4 values nibble-packed the
    reference's way), their scales and the int8 values for max|v|."""
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    k, v = (rng.randint(lo, hi, (*cells, kv, hd)).astype(np.int8)
            for _ in range(2))
    if kv_bits == 4:
        from repro.kernels.nibble import pack_nibbles as jpack
        kp, vp = (np.asarray(jpack(jnp.asarray(a))) for a in (k, v))
    else:
        kp, vp = k, v
    ks, vs = (rng.uniform(0.01, 0.05, (*cells, kv)).astype(np.float32)
              for _ in range(2))
    return kp, ks, vp, vs, v


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("kv,g", [(4, 16), (1, 48)])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_decode_plain_matches_oracle_past_8_heads(paged, kv, g,
                                                       kv_bits, site):
    """K5 / K6 (kv 8 and 4, one and two passes) at G = 16 and 48, hd 128:
    the port's plain version (the wrapper on the CPU) against the
    reference's oracle, with zero-points, a softcap, a short lane and an
    idle one."""
    rng = np.random.RandomState(g + kv_bits + 7 * paged)
    b, hd, s_len, bs = 3, 128, 40, 8
    q = rng.randint(-128, 128, (b, kv, g, hd)).astype(np.int8)
    q_s = (rng.uniform(0.01, 0.03, (b, kv, g)) / 16).astype(np.float32)
    zps = dict(q_zp=np.round(rng.uniform(-20, 20, (b, kv, g))),
               k_zp=np.round(rng.uniform(-3, 3, (b, kv))),
               v_zp=np.round(rng.uniform(-3, 3, (b, kv))))
    zps = {k: v.astype(np.float32) for k, v in zps.items()}
    q_pos = np.array([s_len - 1, 13, -1], np.int32)
    kw = dict(logit_softcap=30.0, kv_bits=kv_bits)
    if paged:
        nb = s_len // bs
        n_blocks = b * nb + 2
        kp, ks, vp, vs, v = _int8_kv(rng, (n_blocks, bs), kv, hd, kv_bits)
        table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(
            np.int32)
        table[1, 2:] = -1
        args = [q, q_s, kp, ks, vp, vs, table, q_pos]
        kw["s_cap"] = s_len
        got = ops.paged_int8_attend_decode(
            *map(_t, args), **kw, **{k: _t(x) for k, x in zps.items()},
            **_site(site, _t))
        want = jref.paged_int8_attend_decode_ref(
            *map(jnp.asarray, args), **kw,
            **{k: jnp.asarray(x) for k, x in zps.items()},
            **_site(site, jnp.asarray))
    else:
        kp, ks, vp, vs, v = _int8_kv(rng, (b, s_len), kv, hd, kv_bits)
        k_pos = np.tile(np.arange(s_len, dtype=np.int32), (b, 1))
        args = [q, q_s, kp, ks, vp, vs, k_pos, q_pos]
        got = ops.int8_attend_decode(
            *map(_t, args), **kw, **{k: _t(x) for k, x in zps.items()},
            **_site(site, _t))
        want = jref.int8_attend_decode_ref(
            *map(jnp.asarray, args), **kw,
            **{k: jnp.asarray(x) for k, x in zps.items()},
            **_site(site, jnp.asarray))
    assert got.shape == (b, kv, g, hd)
    v_abs = float((np.abs(v.astype(np.float32)).max()
                   + np.abs(zps["v_zp"]).max()) * vs.max())
    # the idle lane is a mean over every cell in both
    _assert_attend(got.numpy(), want, 1 / 255 if site == "two-pass" else
                   None, v_abs)


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv,g", [(4, 16), (1, 48)])
def test_float_decode_plain_matches_oracle_past_8_heads(kv, g, site):
    """K7 on bf16 arenas at G = 16 and 48, hd 128, against the oracle."""
    rng = np.random.RandomState(g)
    b, nb, bs, hd = 3, 5, 8, 128
    n_blocks = b * nb + 1
    q = (rng.randn(b, kv, g, hd) * 0.3 / np.sqrt(hd)).astype(np.float32)
    k, v = (rng.randn(n_blocks, bs, kv, hd).astype(np.float32)
            for _ in range(2))
    table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[0, -1] = -1
    q_pos = np.array([nb * bs + 3, 11, -1], np.int32)
    kw = dict(s_cap=nb * bs, logit_softcap=30.0)
    got = ops.paged_attend_decode(
        _t(q), _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16),
        _t(table), _t(q_pos), **kw, **_site(site, _t))
    want = jref.paged_attend_decode_ref(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(q_pos), **kw, **_site(site, jnp.asarray))
    _assert_attend(got.numpy(), want, 1 / 255 if site == "two-pass" else
                   None, float(np.abs(v).max()))


@pytest.mark.parametrize("g,hd,ok", [(16, 128, True), (48, 128, True),
                                     (8, 256, True), (49, 128, False),
                                     (16, 256, True), (17, 256, False),
                                     (12, 132, True), (20, 132, False)])
def test_decode_kernels_refuse_shapes_past_their_limit(g, hd, ok):
    """The split kernels take G <= 16 at hd <= 256 and G <= 48 at hd <=
    128; a query past that raises before any launch (no fallback)."""
    q = torch.zeros((2, 1, g, hd), dtype=torch.int8)
    if ok:
        assert iad.check_query(q, torch.int8) == (2, 1, g, hd)
    else:
        with pytest.raises(ValueError, match="attention decode kernel"):
            iad.check_query(q, torch.int8)


# ---------------------------------------------------------------------------
# The launcher's quickstart and the deploy path's greedy tokens
# ---------------------------------------------------------------------------

# Printed on the CPU by the reference launcher, for each arch:
#   PYTHONPATH=src python -m repro.launch.serve --arch ARCH --reduced \
#       --requests 6 --prompt-len 24 --new-tokens 6 --max-len 64 \
#       --quantize --deploy-int8 --kv-bits 8 --scheduler continuous \
#       --paged-kv --block-size 8 --prefill-chunk 8 --parity
REF_SERVE_LINE = (
    "[serve:continuous] 36 tokens, 10 decode steps, 6 prefills, {wall}, "
    "slot-utilization 75%, peak kv-cache {kib} KiB (kv-bits 8, blocks 16/32 "
    "(frag 22%, block-size 8), chunked prefill (6 chunk steps @ <= 8 "
    "tokens){device})")
REF_KIB = {"qwen3-moe-235b": 21, "granite-20b": 11}
REF_PARITY = [
    "[parity] OK: continuous and static schedulers emit identical greedy "
    "tokens for all 6 requests",
    "[parity] OK: chunked (<= 8 tokens) and unchunked prefill emit "
    "identical greedy tokens for all 6 requests",
    "[parity] OK: paged and dense caches emit identical greedy tokens for "
    "all 6 requests (kv-bits 8)"]
QUICKSTART = ("--reduced --requests 6 --prompt-len 24 --new-tokens 6 "
              "--max-len 64 --quantize --deploy-int8 --kv-bits 8 --scheduler "
              "continuous --paged-kv --block-size 8 --prefill-chunk 8 "
              "--parity").split()


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "granite-20b"])
def test_launcher_quickstart_prints_the_reference_lines(arch, capsys):
    """The serve line's counts and the three parity lines are the
    reference launcher's (the two draw other random weights, so tokens are
    not compared here); the fallback note names the MoE experts."""
    stats = launcher.main(["--arch", arch] + QUICKSTART, device=CPU)
    out = capsys.readouterr().out
    assert stats.tokens_generated == 36
    line = re.search(r"^\[serve:continuous\].*$", out, re.M).group(0)
    want = re.escape(REF_SERVE_LINE).replace(r"\{wall\}",
                                             r"\S+s \(\S+ tok/s\)")
    want = want.replace(r"\{kib\}", str(REF_KIB[arch]))
    want = want.replace(r"\{device\}", ", cpu")
    assert re.fullmatch(want, line), line
    assert re.findall(r"^\[parity\] OK.*$", out, re.M) == REF_PARITY
    assert re.search(r"\[kv-int8\] .*: 0\.0000%", out), out
    moe_note = "fake-quant fallback: MoE experts in 2 layers"
    assert (moe_note in out) == (arch == "qwen3-moe-235b"), out
    if arch == "granite-20b":
        assert "FFN in 2/2 layers" in out, out


def _share(act_state):
    shared = {}
    for site, qp in act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        shared.setdefault(base, qp)
    return shared


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "granite-20b"])
def test_deploy_greedy_tokens_match_reference(arch):
    """W8A8 PEG calibration in the reference, its act state and params
    carried across, both packages' build_deploy, then 2 prompts prefilled
    into an int8 KV cache and 4 greedy tokens decoded, each package on its
    own argmax: the same tokens, logits within 1e-4 of max|logits|. The
    prompts' seed puts no int8 site on a rounding tie."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    rng = np.random.RandomState(10)
    calib = [{"tokens": jnp.asarray(rng.randint(0, cfg.vocab_size, (2, 12)))}
             for _ in range(2)]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, calib, jpeg_policy(4), collect_inputs=True)
    jshared = _share(jqm.act_state)
    shared = act_state_from_jax(_np(jshared), CPU)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4), jshared)
    packed, acts = build_deploy(cfg, params_from_jax(_np(jstacked), CPU),
                                peg_policy(4), shared)
    assert set(acts) == set(jacts)

    def jctx():
        return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                         act_state=jshared, deploy_acts=jacts)

    def ctx():
        return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                        act_state=shared, deploy_acts=acts)
    jpre = jax.jit(jmake_prefill(jcfg, ctx_factory=jctx))
    jdec = jax.jit(jmake_decode(jcfg, ctx_factory=jctx))
    B, T, steps = 2, 9, 4
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (B, T))
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jc = jtfm.init_cache(jcfg, B, 32, dtype=jnp.float32, kv_bits=8)
    tc = tfm.init_cache(cfg, B, 32, dtype=torch.float32, kv_bits=8,
                        device=CPU)
    jl, jc = jpre(jpacked, jnp.asarray(toks), jc, jnp.asarray(positions))
    with torch.no_grad():
        tl, tc = tfm.prefill(cfg, packed, torch.as_tensor(toks), tc,
                             ctx=ctx())
    jtoks, ttoks = [], []
    for step in range(steps + 1):
        assert _rel(jl, tl.numpy()) <= 1e-4, (step, _rel(jl, tl.numpy()))
        jcur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tcur = torch.argmax(tl, -1).to(torch.int32)
        jtoks.append(jcur[:, 0].tolist())
        ttoks.append(tcur[:, 0].tolist())
        if step == steps:
            break
        pos = np.full((B, 1), T + step, np.int32)
        jl, jc = jdec(jpacked, jnp.asarray(jcur), jnp.asarray(pos), jc)
        with torch.no_grad():
            tl, tc = tfm.decode_step(cfg, packed, tcur, torch.as_tensor(pos),
                                     tc, ctx=ctx())
    assert ttoks == jtoks


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_the_zoo(arch, tmp_path, capsys):
    """``launch/train.py --arch`` trains each new config (reduced, two
    steps, a checkpoint): finite losses on every step's line and the
    reference launcher's closing line."""
    from repro_torch.launch import train
    lines = []
    out = train.main(["--arch", arch, "--reduced", "--steps", "2",
                      "--checkpoint-dir", str(tmp_path)], device=CPU,
                     log_every=1, log=lines.append)
    assert out["step"] == 2
    assert [ln.split(" loss ")[0] for ln in lines] == [
        "[train] step 1", "[train] step 2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1].split()[0]))
               for ln in lines)
    assert capsys.readouterr().out == \
        "[train] finished at step 2; 0 straggler events\n"
