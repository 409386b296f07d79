"""The port's BERT path against the JAX reference on the CPU: the synthetic
GLUE data byte for byte, ``layer_norm`` / ``gelu`` / ``cross_entropy``,
the BERT forward, loss and gradients on ``bert.tiny()`` with the
reference's own weights carried across, and Adam + global-norm clipping +
the schedules step for step.

Tolerances: the data exactly; forward outputs within 1e-5 relative, plus
1e-5 of the output's largest magnitude absolute (XLA and PyTorch sum the
matmuls' f32 products in other orders); gradients within 1e-4 of each
leaf's largest magnitude (1e-6 of the largest anywhere for the key
biases, whose true gradient is zero); optimizer states within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_syn
from repro.models import bert as ref_bert
from repro.models import common as ref_common
from repro.optim import adam as ref_adam
from repro.optim import schedule as ref_sched
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic as syn
from repro_torch.models import bert
from repro_torch.models import common
from repro_torch.optim import adam, schedule
from repro_torch.optim.tree import tree_leaves, tree_map

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, scale=1e-5):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ref_syn.GLUE_SUITE, ids=lambda t: t.name)
def test_glue_batches_are_byte_identical(task):
    mine = syn.SyntheticGLUE(syn.GLUETaskConfig(**task.__dict__), seed=3)
    ref = ref_syn.SyntheticGLUE(task, seed=3)
    for index in (0, 7, 100_000):
        a, b = mine.batch(16, index), ref.batch(16, index)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), (task.name, index, k)
    preds = np.random.RandomState(0).rand(16).astype(np.float32) \
        if task.regression else np.arange(16) % task.num_labels
    labels = ref.batch(16, 5)["labels"]
    assert mine.metric(preds, labels) == ref.metric(preds, labels)


def test_suite_and_lm_stream_match_the_reference():
    assert [t.__dict__ for t in syn.GLUE_SUITE] == \
        [t.__dict__ for t in ref_syn.GLUE_SUITE]
    cfg = dict(vocab_size=64, seq_len=12)
    a = syn.SyntheticLM(syn.LMTaskConfig(**cfg), seed=1).batch(4, 2)
    b = ref_syn.SyntheticLM(ref_syn.LMTaskConfig(**cfg), seed=1).batch(4, 2)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_layer_norm_gelu_and_cross_entropy_match_the_reference():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 48) * 4 + 1).astype(np.float32)
    g = rs.randn(48).astype(np.float32)
    b = rs.randn(48).astype(np.float32)
    _close(common.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                             torch.from_numpy(b)),
           ref_common.layer_norm(x, g, b))
    _close(common.gelu(torch.from_numpy(x)), ref_common.gelu(x))
    logits = rs.randn(6, 7, 11).astype(np.float32) * 3
    labels = rs.randint(0, 11, (6, 7)).astype(np.int32)
    mask = (rs.rand(6, 7) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = common.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        _close(got, ref_common.cross_entropy(logits, labels, m))


# ---------------------------------------------------------------------------
# BERT forward, loss, gradients
# ---------------------------------------------------------------------------

def _batch(cfg, seed, regression=False):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    pad = np.ones((4, 24), bool)
    pad[1, 18:] = False
    pad[3, 10:] = False
    types = np.zeros((4, 24), np.int32)
    types[:, 12:] = 1
    labels = rs.rand(4).astype(np.float32) if regression else \
        rs.randint(0, cfg.num_labels, 4).astype(np.int32)
    return {"tokens": toks, "type_ids": types, "pad_mask": pad,
            "labels": labels}


@pytest.fixture(scope="module", params=[False, True],
                ids=["classify", "regress"])
def tiny_pair(request):
    regression = request.param
    kw = dict(num_labels=1, regression=True) if regression else \
        dict(num_labels=3)
    rcfg = ref_bert.tiny(**kw)
    rparams = ref_bert.init_params(rcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, rparams), device=CPU)
    batch = _batch(rcfg, 5, regression)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return bert.tiny(**kw), rcfg, tparams, rparams, tbatch, jbatch


def test_config_and_sites_match_the_reference():
    assert bert.BertConfig().__dict__ == ref_bert.BertConfig().__dict__
    assert bert.tiny().__dict__ == ref_bert.tiny().__dict__
    cfg = bert.tiny()
    assert bert.activation_sites(cfg) == ref_bert.activation_sites(
        ref_bert.tiny())
    mine = bert.init_params(cfg, 0, device=CPU)
    ref = ref_bert.init_params(ref_bert.tiny(), jax.random.PRNGKey(0))
    assert list(bert.named_weight_sites(cfg, mine)) == list(
        ref_bert.named_weight_sites(ref_bert.tiny(), ref))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert tree_map(lambda t: tuple(t.shape), mine) == shapes
    assert all(t.dtype == torch.float32 for t in tree_leaves(mine))
    # the reference's distributions: N(0, 0.02) embeddings, N(0, 1/d_in)
    assert abs(float(mine["tok_embed"].std()) - 0.02) < 1e-3
    assert abs(float(mine["layers"][0]["w_in"].std()) -
               cfg.d_model ** -0.5) < 3e-3


def test_encode_classify_loss_and_predict_match_the_reference(tiny_pair):
    cfg, rcfg, tp, rp, tb, jb = tiny_pair
    kw = dict(type_ids=tb["type_ids"], pad_mask=tb["pad_mask"])
    jkw = dict(type_ids=jb["type_ids"], pad_mask=jb["pad_mask"])
    with torch.no_grad():
        _close(bert.encode(cfg, tp, tb["tokens"], **kw),
               ref_bert.encode(rcfg, rp, jb["tokens"], **jkw))
        _close(bert.classify(cfg, tp, tb["tokens"], **kw),
               ref_bert.classify(rcfg, rp, jb["tokens"], **jkw))
        _close(bert.loss_fn(cfg, tp, tb), ref_bert.loss_fn(rcfg, rp, jb))
        got = bert.predict(cfg, tp, tb).numpy()
    want = np.asarray(ref_bert.predict(rcfg, rp, jb))
    if cfg.regression:
        _close(got, want)
    else:
        assert (got == want).all()


def test_loss_gradients_match_jax_grad(tiny_pair):
    cfg, rcfg, tp, rp, tb, jb = tiny_pair
    want = jax.grad(lambda p: ref_bert.loss_fn(rcfg, p, jb))(rp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    from repro_torch.optim.tree import tree_unflatten
    loss = bert.loss_fn(cfg, tree_unflatten(tp, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    wants = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    # the key biases' true gradient is 0 (softmax is shift-invariant), so
    # both sides hold rounding noise there: a floor of 1e-6 of the largest
    # gradient anywhere bounds them
    floor = 1e-6 * max(float(np.abs(w).max()) for w in wants)
    for g, w in zip(grads, wants):
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=max(1e-4 * float(np.abs(w).max()), floor))


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def _tree_pair(seed):
    rs = np.random.RandomState(seed)
    t = {"b": [rs.randn(3, 4).astype(np.float32),
               rs.randn(5).astype(np.float32)],
         "a": {"w": rs.randn(2, 2).astype(np.float32)}}
    return t, jax.tree.map(jnp.asarray, t), \
        tree_map(lambda a: torch.from_numpy(a.copy()), t)


@pytest.mark.parametrize("weight_decay,with_scale",
                         [(0.0, False), (0.01, True)])
def test_adam_clip_and_schedule_match_the_reference_for_3_steps(
        weight_decay, with_scale):
    _, jp, tp = _tree_pair(0)
    jlr = ref_sched.linear_warmup_linear_decay(1e-2, 10)
    tlr = schedule.linear_warmup_linear_decay(1e-2, 10)
    jst, tst = ref_adam.adam_init(jp), adam.adam_init(tp)
    for step in range(3):
        raw, jg, tg = _tree_pair(10 + step)
        jg, jn = ref_adam.clip_by_global_norm(jg, 1.5)
        tg, tn = adam.clip_by_global_norm(tg, 1.5)
        _close(tn, jn, rtol=1e-6, scale=0)
        gs = 0.5 if with_scale else None
        ju, jst = ref_adam.adam_update(jg, jst, jp, lr=jlr,
                                       weight_decay=weight_decay,
                                       grad_scale=gs)
        tu, tst = adam.adam_update(tg, tst, tp, lr=tlr,
                                   weight_decay=weight_decay, grad_scale=gs)
        jp = ref_adam.apply_updates(jp, ju)
        tp = adam.apply_updates(tp, tu)
        assert int(tst.step) == int(jst.step) == step + 1
        for tree_t, tree_j in ((tp, jp), (tst.mu, jst.mu),
                               (tst.nu, jst.nu)):
            for a, b in zip(tree_leaves(tree_t),
                            jax.tree_util.tree_leaves(tree_j)):
                _close(a, b, rtol=1e-6, scale=1e-7)


@pytest.mark.parametrize("name", ["linear", "cosine", "constant"])
def test_schedules_match_the_reference(name):
    make = {"linear": lambda m: m.linear_warmup_linear_decay(3e-3, 50),
            "cosine": lambda m: m.cosine_schedule(3e-3, 50, min_lr=1e-4),
            "constant": lambda m: m.constant_schedule(3e-3)}[name]
    mine, ref = make(schedule), make(ref_sched)
    for step in (0, 1, 4, 5, 6, 30, 49, 50, 60):
        _close(mine(step), ref(step), rtol=1e-6, scale=0)
        _close(mine(torch.tensor(step, dtype=torch.int32)), ref(step),
               rtol=1e-6, scale=0)
