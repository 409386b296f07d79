"""The port's serving slice against the reference, end to end, on the
gemma2-2b reduced config (f32): weights carried across from the reference,
PTQ calibration with the paper's PEG recipe, ``build_deploy`` packing, the
``Mode.DEPLOY`` forward (prefill + decode) and static greedy serving.

Both packages calibrate on the same numpy prompts. The act states they
compute agree to rel 1e-6 (f32 reductions run in another order). The
packing, logits and serving checks then use the reference's act state
carried across (``repro_torch.convert.act_state_from_jax``), so each check
holds one layer of the stack: a 1e-7 difference in a calibrated scale can
move a value that sits on a rounding tie to the neighbouring grid step,
and any such step would show in the logits.
"""
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
from repro.runtime import serve as jserve
from repro.runtime.steps import make_decode_step as jmake_decode
from repro.runtime.steps import make_prefill_step as jmake_prefill
from repro_torch.configs import get_config
from repro_torch.convert import act_state_from_jax, params_from_jax
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy, ptq
from repro_torch.models import transformer as tfm
from repro_torch.runtime import Request, make_decode_step, make_prefill_step
from repro_torch.runtime import serve

pytestmark = [pytest.mark.deploy, pytest.mark.serve]

CPU = "cpu"


def _share(act_state):
    """Collapse per-layer sites onto the shared ``layer/...`` names, layer
    0's params winning (the launchers' rule)."""
    shared = {}
    for site, qp in act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        shared.setdefault(base, qp)
    return shared


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, stacked=True, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    rng = np.random.RandomState(10)
    calib = [rng.randint(0, cfg.vocab_size, (2, 12)) for _ in range(2)]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, [{"tokens": jnp.asarray(c)} for c in calib],
               jpeg_policy(4), collect_inputs=True)
    stacked = params_from_jax(_np_tree(jstacked), CPU)
    flat = params_from_jax(_np_tree(jflat), CPU)
    tqm = ptq(lambda p, b, c: tfm.forward(cfg, p, b["tokens"], ctx=c)[0],
              flat, [{"tokens": torch.as_tensor(c)} for c in calib],
              peg_policy(4), collect_inputs=True)
    jshared = _share(jqm.act_state)
    shared = act_state_from_jax(_np_tree(jshared), CPU)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4), jshared)
    packed, acts = build_deploy(cfg, stacked, peg_policy(4), shared)
    return dict(jcfg=jcfg, cfg=cfg, jqm=jqm, tqm=tqm, jstacked=jstacked,
                stacked=stacked, flat=flat, jshared=jshared, shared=shared,
                jpacked=jpacked, jacts=jacts, packed=packed, acts=acts)


def _deploy_ctx(s):
    return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                    act_state=s["shared"], deploy_acts=s["acts"])


def _jdeploy_ctx(s):
    return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                     act_state=s["jshared"], deploy_acts=s["jacts"])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def test_calibrated_act_state_matches(slice_setup):
    jst, tst = slice_setup["jqm"].act_state, slice_setup["tqm"].act_state
    assert set(jst) == set(tst) and len(tst) == 54
    for site, jqp in jst.items():
        tqp = tst[site]
        np.testing.assert_allclose(tqp.scale.numpy(), np.asarray(jqp.scale),
                                   rtol=1e-6, atol=0, err_msg=site)
        np.testing.assert_allclose(tqp.zero_point.numpy(),
                                   np.asarray(jqp.zero_point), rtol=1e-6,
                                   atol=0, err_msg=site)
        if jqp.group_index is None:
            assert tqp.group_index is None, site
        else:
            np.testing.assert_array_equal(tqp.group_index.numpy(),
                                          np.asarray(jqp.group_index))


def test_deploy_payloads_bit_exact(slice_setup):
    s = slice_setup
    n = 0
    for jblk, blk in zip(s["jpacked"]["scan"], s["packed"]["scan"]):
        for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                            ("ffn", ("w_gate", "w_up", "w_out"))):
            for name in names:
                jp, tp = jblk[part][name], blk[part][name]
                for field in ("q", "colsum", "s"):
                    np.testing.assert_array_equal(tp[field].numpy(),
                                                  np.asarray(jp[field]))
                n += 1
    assert n == 14
    assert set(s["acts"]) == set(s["jacts"])
    np.testing.assert_array_equal(s["acts"]["layer/ffn_in"].perm.numpy(),
                                  np.asarray(s["jacts"]["layer/ffn_in"].perm))


@pytest.fixture(scope="module")
def jax_steps(slice_setup):
    """The reference's jitted deploy prefill / decode steps, shared by the
    logits and serving checks so each traces once (B = 2, T = 7)."""
    s = slice_setup
    return (jax.jit(jmake_prefill(s["jcfg"],
                                  ctx_factory=lambda: _jdeploy_ctx(s))),
            jax.jit(jmake_decode(s["jcfg"],
                                 ctx_factory=lambda: _jdeploy_ctx(s))))


@pytest.fixture(scope="module")
def deploy_logits(slice_setup, jax_steps):
    """Prefill + 4 greedy decode steps through both packages' DEPLOY path
    (teacher-forced on the reference's argmax) and the port's APPLY path."""
    s = slice_setup
    jpre, jdec = jax_steps
    B, T, steps = 2, 7, 4
    toks = np.random.RandomState(7).randint(0, s["cfg"].vocab_size, (B, T))
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    apply_ctx = QuantCtx(policy=peg_policy(4), mode=Mode.APPLY,
                         act_state=s["shared"])
    jc = jtfm.init_cache(s["jcfg"], B, 32, dtype=jnp.float32)
    dc = tfm.init_cache(s["cfg"], B, 32, dtype=torch.float32, device=CPU)
    ac = tfm.init_cache(s["cfg"], B, 32, dtype=torch.float32, device=CPU)
    jl, jc = jpre(s["jpacked"], jnp.asarray(toks), jc, jnp.asarray(positions))
    with torch.no_grad():
        dl, dc = tfm.prefill(s["cfg"], s["packed"], torch.as_tensor(toks),
                             dc, ctx=_deploy_ctx(s))
        al, ac = tfm.prefill(s["cfg"], s["stacked"], torch.as_tensor(toks),
                             ac, ctx=apply_ctx)
    out = [(np.asarray(jl), dl.numpy(), al.numpy())]
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.full((B, 1), T, np.int32)
    for _ in range(steps):
        jl, jc = jdec(s["jpacked"], jnp.asarray(cur), jnp.asarray(pos), jc)
        with torch.no_grad():
            dl, dc = tfm.decode_step(s["cfg"], s["packed"],
                                     torch.as_tensor(cur),
                                     torch.as_tensor(pos), dc,
                                     ctx=_deploy_ctx(s))
            al, ac = tfm.decode_step(s["cfg"], s["stacked"],
                                     torch.as_tensor(cur),
                                     torch.as_tensor(pos), ac, ctx=apply_ctx)
        out.append((np.asarray(jl), dl.numpy(), al.numpy()))
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    return out


def test_deploy_logits_match_reference(deploy_logits):
    for step, (jl, dl, _) in enumerate(deploy_logits):
        assert _rel(jl, dl) <= 1e-4, (step, _rel(jl, dl))


def test_deploy_logits_match_fake_quant(deploy_logits):
    for step, (_, dl, al) in enumerate(deploy_logits):
        assert _rel(al, dl) <= 1e-4, (step, _rel(al, dl))


def test_unrolled_layout_matches_stacked(slice_setup):
    s = slice_setup
    toks = torch.as_tensor(np.random.RandomState(8).randint(0, 128, (2, 6)))
    with torch.no_grad():
        a, _ = tfm.forward(s["cfg"], s["stacked"], toks)
        b, _ = tfm.forward(s["cfg"], s["flat"], toks)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_static_serve_greedy_tokens_match_reference(slice_setup, jax_steps):
    """4 requests x 6 new tokens through both packages' static schedulers on
    the deploy path: 2 lanes, so two groups, each left-padding its shorter
    prompt with dead cells."""
    s = slice_setup
    rng = np.random.RandomState(0)
    prompts = [rng.randint(10, s["cfg"].vocab_size, size=n)
               for n in (7, 5, 4, 7)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    jpre, jdec = jax_steps
    jserve(jpre, None, jdec,
           lambda b: jtfm.init_cache(s["jcfg"], b, 32, dtype=jnp.float32),
           s["jpacked"], jreqs, scheduler="static", batch_slots=2,
           max_len=32)
    stats = serve(make_prefill_step(s["cfg"],
                                    ctx_factory=lambda: _deploy_ctx(s)),
                  make_decode_step(s["cfg"],
                                   ctx_factory=lambda: _deploy_ctx(s)),
                  lambda b: tfm.init_cache(s["cfg"], b, 32,
                                           dtype=torch.float32, device=CPU),
                  s["packed"], treqs, scheduler="static", batch_slots=2,
                  max_len=32, device=CPU)
    assert stats.tokens_generated == 24 and stats.prefill_calls == 2
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.tokens_out) == 6
        assert tr.tokens_out == jr.tokens_out, tr.rid


def test_float_path_ring_window_and_dead_cells_match_reference(slice_setup):
    """No quantization: a ragged prefill (one lane left-padded with -1
    dead cells) longer than the local layers' 16-slot window ring, then
    greedy decode steps across the ring — float logits agree closely."""
    s = slice_setup
    B, T, steps = 2, 20, 3
    toks = np.random.RandomState(9).randint(0, 128, (B, T))
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, :4] = -1
    pos[1, 4:] = np.arange(T - 4)
    jc = jtfm.init_cache(s["jcfg"], B, 32, dtype=jnp.float32)
    tc = tfm.init_cache(s["cfg"], B, 32, dtype=torch.float32, device=CPU)
    assert tc["scan"][0].pos.shape == (2, B, 16)      # local ring: window 16
    jl, jc = jtfm.prefill(s["jcfg"], s["jstacked"], jnp.asarray(toks), jc,
                          positions=jnp.asarray(pos))
    with torch.no_grad():
        tl, tc = tfm.prefill(s["cfg"], s["stacked"], torch.as_tensor(toks),
                             tc, positions=torch.as_tensor(pos))
    assert _rel(jl, tl.numpy()) <= 1e-5
    np.testing.assert_array_equal(tc["scan"][0].pos.numpy(),
                                  np.asarray(jc["scan"][0].pos))
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    nxt = (pos.max(axis=1, keepdims=True) + 1).astype(np.int32)
    for _ in range(steps):
        jl, jc = jtfm.decode_step(s["jcfg"], s["jstacked"], jnp.asarray(cur),
                                  jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = tfm.decode_step(s["cfg"], s["stacked"],
                                     torch.as_tensor(cur),
                                     torch.as_tensor(nxt), tc)
        assert _rel(jl, tl.numpy()) <= 1e-5
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        nxt = nxt + 1


def test_chunked_attend_matches_dense():
    """The online-softmax path (long contexts) equals the dense path."""
    from repro_torch.models.attention import (AttnConfig, _chunked_attend,
                                              _dense_attend)
    rng = np.random.RandomState(12)
    cfg = AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16, window=24,
                     logit_softcap=50.0)
    q = torch.as_tensor(rng.randn(2, 5, 4, 16).astype(np.float32))
    k = torch.as_tensor(rng.randn(2, 40, 2, 16).astype(np.float32))
    v = torch.as_tensor(rng.randn(2, 40, 2, 16).astype(np.float32))
    kpos = torch.as_tensor(np.tile(np.arange(40, dtype=np.int32), (2, 1)))
    kpos[0, :3] = -1
    qpos = torch.as_tensor(np.array([[35, 36, 37, 38, 39]] * 2, np.int32))
    dense = _dense_attend(q, k, v, qpos, kpos, cfg)
    chunked = _chunked_attend(q, k, v, qpos, kpos, cfg, kv_chunk=16)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-6)
