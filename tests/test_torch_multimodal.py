"""The multimodal and encoder-decoder configs against the reference, on
the CPU: seamless-m4t-medium (encoder-decoder, LayerNorm, ReLU MLP),
phi3-vision-4p2b (front-end patch embeddings, MHA at hd 96 when full) and
bert-base (LayerNorm, GELU MLP) at their reduced widths; the MLP FFN in
float, fake-quant and integer deploy; its packing; forward / prefill /
train_loss with front-end embeddings; every function and step of the
encoder-decoder; ``caches_from_jax`` on a ``DecoderCache``.

Weights, calibrations and embeddings are carried across from the reference
(``repro_torch.convert``): the two packages draw different random numbers.
The biases, zeros at init, are drawn for these checks so that they count.
Tolerances: f32 logits and encoder outputs within 1e-5 of max|.| (XLA and
PyTorch sum rows in other orders); the integer deploy path's logits within
1e-4 of max|logits| (the calibration, made by the port's PTQ and handed to
both packages, puts no int8 site on a rounding tie); packed payloads bit for bit; train losses within rel 1e-6 and
gradients within rel 1e-4 plus 1e-5 of the leaf's largest magnitude;
decode against the dense forward below 5e-5 (the reference's bound); one
``make_train_step`` step at the training tests' bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import Mode as JMode
from repro.core import QuantCtx as JQuantCtx
from repro.core import build_deploy as jbuild_deploy
from repro.core import peg_policy as jpeg_policy
from repro.core.pipeline import ptq as jptq
from repro.models import encdec as jencdec
from repro.models import ffn as jffn
from repro.models import frontends as jfrontends
from repro.models import transformer as jtfm
from repro.optim import adam_init as jadam_init
from repro.optim import linear_warmup_linear_decay as jlwld
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (act_state_from_jax, caches_from_jax,
                                 params_from_jax)
from repro_torch.core import Mode, QuantCtx, build_deploy, deploy, \
    peg_policy, ptq
from repro_torch.models import encdec, ffn, frontends
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.optim import (adam_init, linear_warmup_linear_decay,
                               tree_leaves, value_and_grad)
from repro_torch.runtime import (make_decode_step, make_encoder_forward,
                                 make_prefill_step, make_train_step)

pytestmark = [pytest.mark.deploy]

CPU = "cpu"
ARCHS = ["seamless-m4t-medium", "phi3-vision-4p2b", "bert-base"]
LM_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


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


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _with_biases(tree, seed):
    """The reference's tree with every MLP bias drawn (normal, 0.1)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.randn(*v.shape) * 0.1, v.dtype)
                        if k in ("b_in", "b_out") else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(tree)


@pytest.fixture(scope="module")
def models():
    """Per arch, built once: (reference cfg, port cfg, the reference's
    stacked decoder-only params with drawn biases, the port's copy)."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jget_config(arch).reduced()
            jp = _with_biases(jtfm.init_params(
                jcfg, jax.random.PRNGKey(0), dtype=jnp.float32), 1)
            built[arch] = (jcfg, get_config(arch).reduced(), jp,
                           params_from_jax(_np(jp), CPU))
        return built[arch]
    return get


@pytest.fixture(scope="module")
def seamless():
    """Reduced seamless-m4t-medium as the encoder-decoder: (reference cfg,
    port cfg, reference params with drawn biases, the port's copy, frames
    (B 2, S 8), tokens (B 2, T 10))."""
    jcfg = jget_config("seamless-m4t-medium").reduced()
    jp = _with_biases(jencdec.init_params(jcfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32), 2)
    frames = jax.random.normal(jax.random.PRNGKey(1),
                               (2, 8, jcfg.d_model)) * 0.02
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 10), 0,
                              jcfg.vocab_size)
    return (jcfg, get_config("seamless-m4t-medium").reduced(), jp,
            params_from_jax(_np(jp), CPU), frames, toks)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

def test_arch_ids_are_the_reference():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(arch):
    """Every field of the full and the reduced config."""
    for full in (True, False):
        j, t = jget_config(arch), get_config(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_plan == j.layer_plan and t.hd == j.hd


def _layout(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_layout(arch):
    """init_params draws the reference's tree (MLP biases, stacked encoder
    and decoder layers, position tables), shapes and dtypes alike."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    pairs = [(tfm.init_params(cfg, 0, dtype=torch.float32, device=CPU),
              jax.eval_shape(lambda: jtfm.init_params(jcfg, key,
                                                      dtype=jnp.float32)))]
    if cfg.encoder_layers:
        pairs.append((encdec.init_params(cfg, 0, dtype=torch.bfloat16,
                                         device=CPU),
                      jax.eval_shape(lambda: jencdec.init_params(jcfg,
                                                                 key))))
    for got, want in pairs:
        got = jax.tree.map(lambda x: (tuple(x.shape),
                                      str(x.dtype).replace("torch.", "")),
                           got)
        assert got == _layout(want)


def test_frontend_embeddings_are_the_reference_distribution():
    """Deterministic from the generator, (B, N, D) of the asked dtype,
    N(0, 0.02) as the reference's stubs."""
    for fn, jfn in ((frontends.synth_patch_embeddings,
                     jfrontends.synth_patch_embeddings),
                    (frontends.synth_frame_embeddings,
                     jfrontends.synth_frame_embeddings)):
        a = fn(torch.Generator().manual_seed(3), 2, 512, 64)
        b = fn(torch.Generator().manual_seed(3), 2, 512, 64)
        want = jfn(jax.random.PRNGKey(3), 2, 512, 64)
        assert torch.equal(a, b) and a.dtype == torch.bfloat16
        assert tuple(a.shape) == want.shape
        assert abs(float(a.float().std()) - 0.02) < 1e-3
        assert fn(torch.Generator().manual_seed(3), 1, 2, 8,
                  torch.float32).dtype == torch.float32


# ---------------------------------------------------------------------------
# The MLP FFN
# ---------------------------------------------------------------------------

def _mlp_params(d, f, seed):
    rng = np.random.RandomState(seed)
    return {"w_in": rng.randn(d, f).astype(np.float32) / np.sqrt(d),
            "b_in": rng.randn(f).astype(np.float32) * 0.1,
            "w_out": rng.randn(f, d).astype(np.float32) / np.sqrt(f),
            "b_out": rng.randn(d).astype(np.float32) * 0.1}


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_mlp_float_and_fake_quant_match_reference(activation):
    """``ffn.mlp`` with biases: float within 1e-5 of max|out|; under the
    reference's calibration (W8A8, the ``ffn/hidden`` site) in
    ``Mode.APPLY`` within 1e-5 too (the inputs sit on no rounding tie)."""
    p = _mlp_params(32, 64, 4)
    x = np.random.RandomState(5).randn(2, 6, 32).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    want = jffn.mlp(jp, jnp.asarray(x), activation=activation)
    _close(ffn.mlp(tp, _t(x), activation=activation), want, 0, LM_RTOL)
    jqm = jptq(lambda pp, b, c: jffn.mlp(pp, b["x"], activation=activation,
                                         ctx=c), jp, [{"x": jnp.asarray(x)}],
               jpeg_policy(4))
    assert set(jqm.act_state) == {"ffn/hidden"}
    jctx = JQuantCtx(policy=jpeg_policy(4), mode=JMode.APPLY,
                     act_state=jqm.act_state)
    ctx = QuantCtx(policy=peg_policy(4), mode=Mode.APPLY,
                   act_state=act_state_from_jax(_np(jqm.act_state), CPU))
    want = jffn.mlp(jp, jnp.asarray(x), activation=activation, ctx=jctx)
    got = ffn.mlp(tp, _t(x), activation=activation, ctx=ctx)
    _close(got, want, 0, LM_RTOL)


def _to_jax_state(act_state):
    """The port's act state as the reference's QuantParams."""
    from repro.core.quantizer import QuantParams as JQuantParams
    return {site: JQuantParams(
        scale=jnp.asarray(q.scale.numpy()),
        zero_point=jnp.asarray(q.zero_point.numpy()),
        group_index=None if q.group_index is None
        else jnp.asarray(q.group_index.numpy()))
        for site, q in act_state.items()}


@pytest.fixture(scope="module")
def deployed(models):
    """Per MLP arch (seamless's decoder-only view: ReLU; bert-base: GELU):
    the port's PTQ (peg_policy(4), deploy inputs collected) of the unrolled
    params on 2 x 12 prompt tokens, shared per the launchers' rule and
    handed to the reference too, then both packages' build_deploy."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg, jp, tp = models(arch)
            flat = params_from_jax(_np(_with_biases(jtfm.init_params(
                jcfg, jax.random.PRNGKey(0), stacked=False,
                dtype=jnp.float32), 1)), CPU)
            toks = np.random.RandomState(10).randint(0, cfg.vocab_size,
                                                     (2, 12))
            qm = ptq(lambda p, b, c: tfm.forward(cfg, p, b["tokens"],
                                                 ctx=c)[0],
                     flat, [{"tokens": _t(toks)}], peg_policy(4),
                     collect_inputs=True)
            shared = {}
            for site, qp in qm.act_state.items():
                base = "layer/" + site.split("/", 1)[1] \
                    if site.startswith("layer") else site
                shared.setdefault(base, qp)
            jshared = _to_jax_state(shared)
            jpacked, jacts = jbuild_deploy(jcfg, jp, jpeg_policy(4), jshared)
            packed, acts = build_deploy(cfg, tp, peg_policy(4), shared)
            built[arch] = dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp,
                               jshared=jshared, shared=shared,
                               jpacked=jpacked, jacts=jacts, packed=packed,
                               acts=acts)
        return built[arch]
    return get


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "bert-base"])
def test_pack_ffn_packs_w_in_bit_exact(arch, deployed):
    """``_pack_ffn``'s MLP branch: w_in on the PEG ``ffn_in`` groups (with
    its permutation), w_out per-tensor; payloads, scales and colsums bit
    for bit; the biases stay unpacked, as the reference leaves them."""
    s = deployed(arch)
    jffn_p, tffn = s["jpacked"]["scan"][0]["ffn"], s["packed"]["scan"][0]["ffn"]
    assert deploy.is_packed(tffn["w_in"]) and deploy.is_packed(tffn["w_out"])
    for name in ("w_in", "w_out"):
        for field in ("q", "s", "colsum"):
            np.testing.assert_array_equal(tffn[name][field].numpy(),
                                          np.asarray(jffn_p[name][field]))
    for name in ("b_in", "b_out"):
        np.testing.assert_array_equal(tffn[name].numpy(),
                                      np.asarray(jffn_p[name]))
    assert tffn["w_in"]["colsum"].shape[1] == 4       # (L, G, N): 4 groups
    assert set(s["acts"]) == set(s["jacts"])
    np.testing.assert_array_equal(s["acts"]["layer/ffn_in"].perm.numpy(),
                                  np.asarray(s["jacts"]["layer/ffn_in"].perm))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "bert-base"])
def test_mlp_deploy_matches_reference(arch, deployed, monkeypatch):
    """The ``Mode.DEPLOY`` forward of the MLP configs: LayerNorm + int8
    emit (K8's plain version), ``w_in`` with bias + activation + requant
    (K2's), ``w_out`` with bias (K3's) — logits within 1e-4 of max|logits|
    of the reference's DEPLOY forward, and every packed MLP reached the
    integer path."""
    s = deployed(arch)
    calls = []
    real = deploy.matmul

    def spy(x, packed, **kw):
        calls.append((kw.get("bias") is not None, kw.get("activation")))
        return real(x, packed, **kw)
    monkeypatch.setattr(deploy, "matmul", spy)
    toks = np.random.RandomState(99).randint(0, s["cfg"].vocab_size, (2, 9))
    jctx = JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                     act_state=s["jshared"], deploy_acts=s["jacts"])
    ctx = QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                   act_state=s["shared"], deploy_acts=s["acts"])
    want, _ = jtfm.forward(s["jcfg"], s["jpacked"], jnp.asarray(toks),
                           ctx=jctx)
    with torch.no_grad():
        got, _ = tfm.forward(s["cfg"], s["packed"], _t(toks), ctx=ctx)
    assert _rel(want, got.numpy()) <= 1e-4
    act = s["cfg"].act
    L = s["cfg"].num_layers
    assert calls.count((True, act)) == L and calls.count((True, None)) == L


# ---------------------------------------------------------------------------
# Front-end embeddings
# ---------------------------------------------------------------------------

def _embeds(jcfg, B, seed):
    return jfrontends.synth_patch_embeddings(
        jax.random.PRNGKey(seed), B, jcfg.num_frontend_tokens, jcfg.d_model,
        dtype=jnp.float32)


def test_forward_and_prefill_with_embeds_match_reference(models):
    """phi3-vision: ``forward(embeds=)`` over 8 patch embeddings + 12
    tokens within 1e-5 of the reference's logits; ``make_prefill_step``
    with embeds into a cache, then 4 decode steps, against the port's
    dense forward below 5e-5 (the reference's decode bound)."""
    jcfg, cfg, jp, tp = models("phi3-vision-4p2b")
    B, T, extra = 2, 12, 4
    emb = _embeds(jcfg, B, 3)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, T + extra))
    want, _ = jtfm.forward(jcfg, jp, jnp.asarray(toks[:, :T]), embeds=emb)
    full, _ = tfm.forward(cfg, tp, _t(toks), embeds=_t(emb))
    _close(full[:, :-extra], want, 0, LM_RTOL)
    assert full.shape[1] == cfg.num_frontend_tokens + T + extra
    n = cfg.num_frontend_tokens
    cache = tfm.init_cache(cfg, B, 64, dtype=torch.float32, device=CPU)
    lp, cache2 = make_prefill_step(cfg)(tp, _t(toks[:, :T]), cache,
                                        embeds=_t(emb))
    assert cache2 is cache
    jlp, _ = jtfm.prefill(jcfg, jp, jnp.asarray(toks[:, :T]),
                          jtfm.init_cache(jcfg, B, 64, dtype=jnp.float32),
                          embeds=emb)
    _close(lp, jlp, 0, LM_RTOL)
    errs = [float((lp[:, -1] - full[:, n + T - 1]).abs().max())]
    dec = make_decode_step(cfg)
    for t in range(extra):
        pos = torch.full((B, 1), n + T + t, dtype=torch.int32)
        lg, cache = dec(tp, _t(toks[:, T + t:T + t + 1]), pos, cache)
        errs.append(float((lg[:, 0] - full[:, n + T + t]).abs().max()))
    assert max(errs) < 5e-5, errs


def test_train_loss_with_embeds_and_grads_match_reference(models):
    """``train_loss`` with ``batch["embeds"]`` (the front-end positions
    carry no loss): the loss within rel 1e-6, every gradient leaf within
    rel 1e-4 plus 1e-5 of its largest magnitude."""
    jcfg, cfg, jp, tp = models("phi3-vision-4p2b")
    emb = _embeds(jcfg, 2, 4)
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 16))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jtfm.train_loss(
        jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
                  "embeds": emb}, remat=False)))(jp)
    batch = {"tokens": _t(toks), "labels": _t(toks), "embeds": _t(emb)}
    l, g = value_and_grad(lambda p: tfm.train_loss(cfg, p, batch), tp)
    _close(l, jl, 1e-6)
    for got, want in zip(tree_leaves(g), jax.tree.leaves(jg)):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# The encoder-decoder
# ---------------------------------------------------------------------------

def test_encode_and_teacher_forced_decode_match_reference(seamless):
    jcfg, cfg, jp, tp, frames, toks = seamless
    jmem = jencdec.encode(jcfg, jp, frames)
    mem = encdec.encode(cfg, tp, _t(frames))
    _close(mem, jmem, 0, LM_RTOL)
    jlog, _ = jencdec.decode(jcfg, jp, toks, jmem)
    log, cache = encdec.decode(cfg, tp, _t(toks), _t(jmem))
    assert cache is None
    _close(log, jlog, 0, LM_RTOL)


def test_encdec_train_loss_and_grads_match_reference(seamless):
    jcfg, cfg, jp, tp, frames, toks = seamless
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jencdec.train_loss(
        jcfg, p, {"frames": frames, "tokens": toks, "labels": toks})))(jp)
    batch = {"frames": _t(frames), "tokens": _t(toks), "labels": _t(toks)}
    l, g = value_and_grad(lambda p: encdec.train_loss(cfg, p, batch), tp)
    _close(l, jl, 1e-6)
    leaves, jleaves = tree_leaves(g), jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)


def test_prefill_from_encoder_and_decode_steps_match_reference(seamless):
    """``make_encoder_forward`` + ``make_decode_step`` against the
    reference's ``prefill_from_encoder`` + ``decode_step``: logits within
    1e-5 of max|logits| at every step, the cache written in place (the
    object returned is the one given) and equal to the reference's cache
    carried across by ``caches_from_jax``."""
    jcfg, cfg, jp, tp, frames, toks = seamless
    jl, jc = jencdec.prefill_from_encoder(jcfg, jp, frames, toks[:, :1],
                                          1024)
    l, c = make_encoder_forward(cfg)(tp, _t(frames), _t(toks[:, :1]))
    assert c.self_kv.k.shape[2] == 1024
    _close(l, jl, 0, LM_RTOL)
    dec = make_decode_step(cfg)
    for t in range(1, 4):
        pos = np.full((2, 1), t, np.int32)
        jl, jc = jencdec.decode_step(jcfg, jp, toks[:, t:t + 1],
                                     jnp.asarray(pos), jc)
        l, c2 = dec(tp, _t(toks[:, t:t + 1]), _t(pos), c)
        assert c2 is c
        _close(l, jl, 0, LM_RTOL)
    want = caches_from_jax(_np(jc), CPU)
    for got, ref in zip(tree_leaves(c), tree_leaves(want)):
        _close(got, ref, 0, LM_RTOL)


def test_decode_matches_dense_forward(seamless):
    """``TestEncDec`` of the reference's model tests, on the port: the
    train loss is finite, and the encoder prefill + 3 decode steps equal
    the teacher-forced decode below 5e-5."""
    _, cfg, _, tp, frames, toks = seamless
    frames, toks = _t(frames), _t(toks)
    loss = encdec.train_loss(cfg, tp, {"frames": frames, "tokens": toks,
                                       "labels": toks})
    assert np.isfinite(float(loss))
    mem = encdec.encode(cfg, tp, frames)
    full, _ = encdec.decode(cfg, tp, toks, mem)
    logits0, cache = encdec.prefill_from_encoder(cfg, tp, frames,
                                                 toks[:, :1], 32)
    errs = [float((logits0[:, -1] - full[:, 0]).abs().max())]
    for t in range(1, 4):
        pos = torch.full((2, 1), t, dtype=torch.int32)
        lg, cache = encdec.decode_step(cfg, tp, toks[:, t:t + 1], pos, cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-5, errs


def test_caches_from_jax_converts_a_decoder_cache(seamless):
    """The reference's ``DecoderCache`` (its ``self_kv`` a stacked
    ``KVCache``) comes across field by field with the port's types."""
    jcfg, _, _, _, _, _ = seamless
    jc = jencdec.init_decoder_cache(jcfg, 2, 16, 8, jnp.float32)
    jc = jc._replace(mem_pos=jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32),
                                              (2, 8)))
    c = caches_from_jax(_np(jc), CPU)
    assert type(c) is encdec.DecoderCache and type(c.self_kv) is KVCache
    assert tuple(c.self_kv.k.shape) == (2, 2, 16, 2, 16)
    assert c.self_kv.pos.dtype == torch.int32 and \
        bool((c.self_kv.pos == -1).all())
    np.testing.assert_array_equal(c.mem_pos.numpy(), np.asarray(jc.mem_pos))
    want = encdec.init_decoder_cache(get_config(
        "seamless-m4t-medium").reduced(), 2, 16, 8, torch.float32, CPU)
    assert [tuple(x.shape) for x in tree_leaves(want)] == \
        [tuple(x.shape) for x in tree_leaves(c)]


def test_encdec_fake_quant_sites_match_reference(seamless):
    """A ``QuantCtx`` in ``Mode.APPLY`` on the encoder-decoder. The
    reference cannot calibrate it (its range observers leak tracers out of
    ``lax.scan``), so the port's PTQ (W8A8, every site) calibrates it and
    the act state goes to the reference: both packages then fake-quantize
    the same sites, every one that the reference's forward names, and the
    train losses agree within rel 1e-5."""
    jcfg, cfg, jp, tp, frames, toks = seamless
    batch = {"frames": frames, "tokens": toks, "labels": toks}
    tbatch = {k: _t(v) for k, v in batch.items()}
    qm = ptq(lambda p, b, c: encdec.train_loss(cfg, p, b, ctx=c), tp,
             [tbatch], peg_policy(4))
    assert {"embed/sum", "enc/attn/softmax_out", "enc/ffn_in",
            "dec/embed_sum", "dec/residual_attn", "xattn/softmax_out",
            "dec/ffn/hidden", "dec/residual_ffn", "head/logits"} <= \
        set(qm.act_state)
    jstate = _to_jax_state(qm.act_state)
    seen, jseen = set(), set()

    class Spy(QuantCtx):
        def act(self, site, x):
            seen.add(site)
            return super().act(site, x)

    class JSpy(JQuantCtx):
        def act(self, site, x):
            jseen.add(site)
            return super().act(site, x)
    got = encdec.train_loss(cfg, tp, tbatch, ctx=Spy(
        policy=peg_policy(4), mode=Mode.APPLY, act_state=qm.act_state))
    want = jencdec.train_loss(jcfg, jp, batch, ctx=JSpy(
        policy=jpeg_policy(4), mode=JMode.APPLY, act_state=jstate))
    assert seen == jseen and set(qm.act_state) <= seen
    _close(got, want, 1e-5)


def test_make_train_step_on_seamless_matches_reference(seamless):
    """One ``make_train_step`` Adam step on the reduced encoder-decoder
    (the step picks ``encdec.train_loss``): loss and gradient norm within
    rel 1e-5, every updated param within rel 1e-5 plus 1e-6 of its leaf's
    largest magnitude, or within two learning rates where the gradient
    is rounding noise."""
    jcfg, cfg, jp, tp, frames, toks = seamless
    batch = {"frames": frames, "tokens": toks, "labels": toks}
    jstep = jax.jit(jmake_train_step(jcfg, lr_schedule=jlwld(1e-3, 10)))
    jp2, _, jm = jstep(jp, jadam_init(jp), batch)
    pp = params_from_jax(_np(jp), CPU)
    step = make_train_step(cfg, lr_schedule=linear_warmup_linear_decay(
        1e-3, 10))
    pp2, po2, m = step(pp, adam_init(pp), {k: _t(v) for k, v in
                                           batch.items()})
    _close(m["loss"], jm["loss"], 1e-5)
    _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    assert int(po2.step) == 1
    for got, want in zip(tree_leaves(pp2), jax.tree.leaves(jp2)):
        got, want = got.numpy().astype(np.float64), np.asarray(want,
                                                                np.float64)
        d = np.abs(got - want)
        tight = 1e-5 * np.abs(want) + 1e-6 * max(float(np.abs(want).max()),
                                                  1e-30)
        assert d.max() <= 2e-3 + tight.max()
        assert (d > tight).sum() <= max(1, 1e-2 * d.size)
