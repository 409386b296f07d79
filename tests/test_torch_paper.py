"""The port's paper path on the CPU: the reference's integration cases of
``tests/test_quant_pipeline.py`` run on the port (the same planted-outlier
fixture, carried across from the reference's weights), the STE / LSQ
gradients of ``fake_quant`` and ``qat._materialize`` against ``jax.grad``
(values exactly on the clip bounds included), the grad-off ``fake_quant``
against the one it replaced, one AdaRound step against the reference on
the same batch, ``ptq`` with AdaRound, and the table harness at micro
size against ``benchmarks/common.py``.

Tolerances: gradients within 1e-5 relative plus 1e-6 of the largest
magnitude absolute; fake-quant values bit for bit; the AdaRound step's
loss within 1e-5 and its gradient within 1e-4 of its largest magnitude;
training losses and trained weights within 1e-4 relative (key biases,
whose true gradient is zero, within 3 Adam steps); act-state scales within 1e-6
relative; task metrics within 1 point.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import adaround as ref_ada
from repro.core import qat as ref_qat
from repro.core import quantizer as ref_q
from repro.core.quant_config import QuantizerConfig as RefQC
from repro.models import bert as ref_bert
from repro_torch.convert import act_state_from_jax, params_from_jax
from repro_torch.core import (A8_DEFAULT, A16_DEFAULT, FP32, Mode, QuantCtx,
                              QuantizationPolicy, QuantizerConfig,
                              RangeEstimator, fake_quant, fp32_policy,
                              peg_config, peg_policy, ptq, w8a8_policy)
from repro_torch.core import adaround, qat
from repro_torch.core import quantizer as q
from repro_torch.core.adaround import AdaRoundConfig, optimize_rounding
from repro_torch.core.calibration import (build_act_state,
                                          build_weight_state, collect_ranges)
from repro_torch.core.mixed_precision import (leave_one_out_policies,
                                              quantizer_census,
                                              sensitivity_sweep)
from repro_torch.core.range_estimation import estimate_weight_params
from repro_torch.models import bert
from repro_torch.optim import adam_init, adam_update, apply_updates

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
OUTLIER_DIMS = (5, 40, 77, 100)    # spread over all 4 natural d/K chunks
FFN_PAT = r".*/(ffn_(in|out)|residual_ffn)"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_bert():
    """The reference's fixture (``test_quant_pipeline.py``): its weights
    from PRNGKey(0) with the outlier columns planted, its token batches,
    carried across."""
    rcfg = ref_bert.tiny()
    rparams = ref_bert.init_params(rcfg, jax.random.PRNGKey(0))
    for p in rparams["layers"]:
        for j, dim in enumerate(OUTLIER_DIMS):
            p["w_out"] = p["w_out"].at[:, dim].multiply(100.0 - 10.0 * j)
    batches = []
    for i in range(4):
        toks = jax.random.randint(jax.random.PRNGKey(10 + i), (8, 32), 0,
                                  rcfg.vocab_size)
        batches.append({"tokens": torch.from_numpy(np.asarray(toks))})
    params = params_from_jax(jax.tree.map(np.asarray, rparams), device=CPU)
    return bert.tiny(), params, batches


def _forward(cfg):
    def fwd(params, batch, ctx):
        return bert.classify(cfg, params, batch["tokens"], ctx=ctx)
    return fwd


def _encode(cfg):
    def fwd(p, b, ctx):
        return bert.encode(cfg, p, b["tokens"], ctx=ctx)
    return fwd


def _ffn_only_policy(act_cfg):
    return QuantizationPolicy(weight_default=FP32, act_default=FP32,
                              act_overrides={FFN_PAT: act_cfg})


# ---------------------------------------------------------------------------
# the reference's integration cases, on the port
# ---------------------------------------------------------------------------

class TestCalibration:
    def test_collect_covers_all_sites(self, tiny_bert):
        cfg, params, batches = tiny_bert
        states, _ = collect_ranges(_forward(cfg), params, batches,
                                   w8a8_policy())
        assert set(bert.activation_sites(cfg)).issubset(set(states))

    def test_apply_changes_outputs_bounded(self, tiny_bert):
        cfg, params, batches = tiny_bert
        qm = ptq(_forward(cfg), params, batches, w8a8_policy())
        with torch.no_grad():
            out_fp = _forward(cfg)(params, batches[0], None)
            out_q = _forward(cfg)(params, batches[0], qm.ctx())
        assert not torch.allclose(out_fp, out_q)
        assert torch.isfinite(out_q).all()

    def test_fp32_policy_is_identity(self, tiny_bert):
        cfg, params, batches = tiny_bert
        qm = ptq(_forward(cfg), params, batches, fp32_policy())
        with torch.no_grad():
            out_fp = _forward(cfg)(params, batches[0], None)
            out_q = _forward(cfg)(params, batches[0], qm.ctx())
        assert torch.equal(out_fp, out_q)


class TestPaperOrdering:
    def _hidden_err(self, cfg, params, batches, policy):
        fwd = _encode(cfg)
        qm = ptq(fwd, params, batches, policy)
        with torch.no_grad():
            out_fp = fwd(params, batches[0], None)
            out_q = fwd(params, batches[0], qm.ctx())
        return float(torch.mean(torch.square(out_fp - out_q)) /
                     torch.mean(torch.square(out_fp)))

    def test_peg_beats_per_tensor(self, tiny_bert):
        cfg, params, batches = tiny_bert
        e_pt = self._hidden_err(cfg, params, batches,
                                _ffn_only_policy(A8_DEFAULT))
        e_peg = self._hidden_err(cfg, params, batches,
                                 _ffn_only_policy(peg_config(4)))
        assert e_peg < e_pt / 2

    def test_permutation_beats_no_permutation(self, tiny_bert):
        cfg, params, batches = tiny_bert
        site = "layer0/residual_ffn"
        errs = {}
        for use_p in (True, False):
            pol = _ffn_only_policy(peg_config(4, use_permutation=use_p))
            states, tensors = collect_ranges(_encode(cfg), params, batches,
                                             pol)
            act_state, specs = build_act_state(states, tensors, pol)
            x = tensors[site]
            xq = fake_quant(x, act_state[site], pol.act_config(site))
            clean = np.ones(x.shape[-1], bool)
            clean[list(OUTLIER_DIMS)] = False
            errs[use_p] = float(torch.mean(torch.square(x - xq)[
                ..., torch.from_numpy(clean)]))
            if use_p:   # all outliers must share one group
                gi_nat = specs[site].group_index[
                    specs[site].inverse_permutation]
                assert len({int(gi_nat[d]) for d in OUTLIER_DIMS}) == 1
        assert errs[True] < errs[False] / 1.5

    def test_mixed_precision_16bit_recovers(self, tiny_bert):
        cfg, params, batches = tiny_bert
        e_pt = self._hidden_err(cfg, params, batches,
                                _ffn_only_policy(A8_DEFAULT))
        e_16 = self._hidden_err(cfg, params, batches,
                                _ffn_only_policy(A16_DEFAULT))
        assert e_16 < e_pt / 100

    def test_peg_specs_built_for_ffn_sites_only(self, tiny_bert):
        cfg, params, batches = tiny_bert
        qm = ptq(_forward(cfg), params, batches, peg_policy(4))
        assert len(qm.peg_specs) > 0
        for site in qm.peg_specs:
            assert ("ffn_in" in site or "ffn_out" in site
                    or "residual_ffn" in site)


class TestQAT:
    def test_qat_recovers_from_perturbed_scales(self, tiny_bert):
        """Perturb the PTQ activation scales 4x and verify learnable-range
        QAT descends back (the reference's lr 3e-3 and 150 steps)."""
        cfg, params, batches = tiny_bert
        qm = ptq(_forward(cfg), params, batches, w8a8_policy())
        wstate = build_weight_state(bert.named_weight_sites(cfg, params),
                                    qm.policy)
        qat_p = qat.init_qat_params(qm.act_state, wstate)
        for d in qat_p["act"].values():
            d["log_scale"] = d["log_scale"] + np.log(4.0)
        with torch.no_grad():
            out_fp = _forward(cfg)(params, batches[0], None)

        def loss(qat_params):
            ctx = QuantCtx(policy=qm.policy, mode=Mode.QAT,
                           act_state=qm.act_state, weight_state=wstate,
                           qat_params=qat_params)
            out = _forward(cfg)(params, batches[0], ctx)
            return torch.mean(torch.square(out - out_fp))

        from repro_torch.paper.common import value_and_grad
        with torch.no_grad():
            l0 = float(loss(qat_p))
        opt = adam_init(qat_p)
        for _ in range(150):
            _, g = value_and_grad(loss, qat_p)
            upd, opt = adam_update(g, opt, qat_p, lr=3e-3)
            qat_p = apply_updates(qat_p, upd)
        with torch.no_grad():
            l1 = float(loss(qat_p))
        assert np.isfinite(l1)
        assert l1 < l0 * 0.7


class TestAdaRound:
    def test_adaround_beats_nearest_rounding(self):
        gen = torch.Generator().manual_seed(0)
        d_in, d_out, n = 64, 32, 256
        w = torch.randn(d_in, d_out, generator=gen) / 8.0
        x = torch.randn(n, d_in, generator=gen)
        cfg = QuantizerConfig(bits=4, symmetric=True,
                              estimator=RangeEstimator.MSE)
        qp = estimate_weight_params(w, cfg)
        w_nearest = fake_quant(w, qp, cfg)
        err_nearest = float(torch.mean(torch.square(x @ w - x @ w_nearest)))
        w_ada, h = optimize_rounding(
            w, x, qp, cfg, AdaRoundConfig(iterations=300, batch_size=128))
        err_ada = float(torch.mean(torch.square(x @ w - x @ w_ada)))
        assert err_ada < err_nearest
        h = h.numpy()
        assert np.all((h < 0.45) | (h > 0.55) | np.isclose(h, 0.5, atol=0.2))

    def test_adaround_stays_on_grid(self):
        gen = torch.Generator().manual_seed(2)
        w = torch.randn(32, 16, generator=gen) / 4
        x = torch.randn(64, 32, generator=gen)
        cfg = QuantizerConfig(bits=4, symmetric=True,
                              estimator=RangeEstimator.MSE)
        qp = estimate_weight_params(w, cfg)
        w_ada, _ = optimize_rounding(w, x, qp, cfg,
                                     AdaRoundConfig(iterations=100))
        s = float(qp.scale)
        grid = np.round(w_ada.numpy() / s)
        np.testing.assert_allclose(w_ada.numpy(), grid * s, atol=1e-5)
        lo = np.floor(w.numpy() / s)
        cand_lo = np.clip(lo, cfg.qmin, cfg.qmax)
        cand_hi = np.clip(lo + 1, cfg.qmin, cfg.qmax)
        assert np.all((grid == cand_lo) | (grid == cand_hi))


# ---------------------------------------------------------------------------
# STE / LSQ gradients against jax.grad
# ---------------------------------------------------------------------------

def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(float(np.abs(want).max()),
                                               1e-30))


GRAD_CASES = {
    # (cfg kwargs, scale shape, channel axis)
    "asym-per-tensor": (dict(bits=8), ()),
    "sym-per-tensor": (dict(bits=4, symmetric=True), ()),
    "asym-per-channel": (dict(bits=8), (6,)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_fake_quant_ste_and_lsq_gradients_match_jax(case):
    kw, sshape = GRAD_CASES[case]
    cfg, rcfg = QuantizerConfig(**kw), RefQC(**kw)
    rs = np.random.RandomState(1)
    s = np.asarray(0.05 + 0.02 * rs.rand(*sshape), np.float32)
    z = np.full(sshape, 0.0 if cfg.symmetric else 100.0, np.float32)
    x = (rs.randn(5, 6) * 4).astype(np.float32)
    sb = np.broadcast_to(s, (6,)) if sshape else np.full((6,), s)
    zb = np.broadcast_to(z, (6,)) if sshape else np.full((6,), z)
    # values that land exactly on qmin and qmax, and beyond them
    x[0] = (cfg.qmin - zb) * sb
    x[1] = (cfg.qmax - zb) * sb
    x[2] = (cfg.qmax + 3 - zb) * sb
    x[3] = (cfg.qmin - 3 - zb) * sb
    up = rs.randn(5, 6).astype(np.float32)

    def ref_loss(x, s, z):
        out = ref_q.fake_quant(x, ref_q.QuantParams(s, z), rcfg)
        return jnp.sum(out * up)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(x, s, z)
    tx, ts, tz = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (x, s, z))
    out = fake_quant(tx, q.QuantParams(ts, tz), cfg)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(up)),
                              (tx, ts, tz))
    hits = (np.abs(np.round(x / sb) + zb - cfg.qmax) == 0) | \
        (np.abs(np.round(x / sb) + zb - cfg.qmin) == 0)
    assert hits[:2].all()                       # the bounds are exercised
    for g, w in zip(got, want):
        _grad_close(g, w)


@pytest.mark.parametrize("symmetric", [False, True])
def test_materialize_lsq_gradients_match_jax(symmetric):
    kw = dict(bits=8, symmetric=symmetric)
    cfg, rcfg = QuantizerConfig(**kw), RefQC(**kw)
    rs = np.random.RandomState(2)
    x = (rs.randn(4, 8) * 3).astype(np.float32)
    log_s = np.float32(np.log(0.04))
    # an offset that rounds onto qmax exercises the clip's tie rule
    offset = np.float32(cfg.qmax if not symmetric else 0.0)
    up = rs.randn(4, 8).astype(np.float32)

    def ref_loss(x, ls, off):
        qp = ref_qat._materialize({"log_scale": ls, "offset": off},
                                  ref_q.QuantParams(0.0, 0.0), rcfg,
                                  ref_qat._lsq_grad_scale(x, rcfg))
        return jnp.sum(ref_q.fake_quant(x, qp, rcfg) * up)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(x, log_s, offset)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tl = torch.tensor(log_s).requires_grad_(True)
    to = torch.tensor(offset).requires_grad_(True)
    qp = qat._materialize({"log_scale": tl, "offset": to},
                          q.QuantParams(torch.tensor(0.), torch.tensor(0.)),
                          cfg, qat._lsq_grad_scale(tx, cfg))
    out = fake_quant(tx, qp, cfg)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(up)),
                              (tx, tl, to), allow_unused=True)
    for g, w in zip(got, want):
        _grad_close(torch.zeros(()) if g is None else g, w)


# ---------------------------------------------------------------------------
# grad-off fake_quant: the same values and operators as before STE
# ---------------------------------------------------------------------------

def _fake_quant_before_ste(x, qp, cfg):
    """``fake_quant`` as the port had it before the STE gradient."""
    if not cfg.enabled:
        return x
    s, z = q._expand(qp, x.dim(), cfg.channel_axis)
    s = torch.clamp_min(s.float(), q.TINY)
    out = torch.round(x.float() / s) + z
    out = torch.clamp(out, cfg.qmin, cfg.qmax)
    return ((out - z) * s).to(x.dtype)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("peg", [False, True])
def test_fake_quant_grad_on_and_off_bit_equal_same_ops_when_off(dtype, peg):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(3, 7, 16, generator=gen) * 5).to(dtype)
    if peg:
        cfg = peg_config(4)
        qp = q.QuantParams(0.02 + 0.05 * torch.rand(4, generator=gen),
                           torch.round(60 * torch.rand(4, generator=gen)),
                           torch.arange(16) % 4)
    else:
        cfg = A8_DEFAULT
        qp = q.QuantParams(torch.tensor(0.07), torch.tensor(120.))
    with torch.no_grad():
        with _Ops() as now:
            off = fake_quant(x, qp, cfg)
        with _Ops() as before:
            old = _fake_quant_before_ste(x, qp, cfg)
    assert now.ops == before.ops
    assert torch.equal(off, old)
    xg = x.clone().requires_grad_(True)
    sg = qp.scale.clone().requires_grad_(True)
    on = fake_quant(xg, q.QuantParams(sg, qp.zero_point, qp.group_index),
                    cfg)
    assert on.requires_grad and torch.equal(on.detach(), off)
    # grad mode on but nothing that needs grad: the plain operators
    with _Ops() as plain:
        fake_quant(x, qp, cfg)
    assert plain.ops == before.ops


def test_quantize_dequantize_and_quant_error_match_the_reference():
    cfg = QuantizerConfig(bits=8)
    rs = np.random.RandomState(4)
    x = (rs.randn(6, 5) * 3).astype(np.float32)
    s, z = np.float32(0.03), np.float32(128.0)
    rqp, tqp = ref_q.QuantParams(s, z), q.QuantParams(torch.tensor(s),
                                                      torch.tensor(z))
    qi = q.quantize(torch.from_numpy(x), tqp, cfg)
    assert qi.dtype == torch.int32
    np.testing.assert_array_equal(qi.numpy(),
                                  np.asarray(ref_q.quantize(x, rqp, RefQC())))
    np.testing.assert_array_equal(q.dequantize(qi, tqp, cfg).numpy(),
                                  np.asarray(ref_q.dequantize(
                                      np.asarray(qi), rqp, RefQC())))
    np.testing.assert_allclose(
        float(q.quant_error(torch.from_numpy(x), tqp, cfg)),
        float(ref_q.quant_error(x, rqp, RefQC())), rtol=1e-6)


def test_qat_mode_reads_the_live_leaves_and_falls_back_on_weights():
    cfg = A8_DEFAULT
    x = torch.linspace(-3, 5, 40).reshape(5, 8)
    state = {"a": q.QuantParams(torch.tensor(0.03), torch.tensor(100.))}
    learn = qat.init_qat_params(state, {})
    ctx = QuantCtx(policy=w8a8_policy(), mode=Mode.QAT, act_state=state,
                   qat_params=learn)
    y0 = ctx.act("a", x)
    learn["act"]["a"]["log_scale"] = learn["act"]["a"]["log_scale"] + 1.0
    assert not torch.equal(ctx.act("a", x), y0)
    assert ctx.act("unknown", x) is x
    assert ctx.act_in("a", x) is x
    w = torch.linspace(-1, 1, 64).reshape(8, 8)
    cheap = dataclasses.replace(w8a8_policy().weight_config("w"),
                                estimator=RangeEstimator.CURRENT_MINMAX)
    assert torch.equal(ctx.weight("w", w),
                       fake_quant(w, estimate_weight_params(w, cheap),
                                  cheap))


# ---------------------------------------------------------------------------
# AdaRound: one step against the reference; ptq end to end
# ---------------------------------------------------------------------------

def test_one_adaround_step_matches_the_reference():
    rs = np.random.RandomState(5)
    w = (rs.randn(24, 12) / 6).astype(np.float32)
    x = rs.randn(64, 24).astype(np.float32)
    kw = dict(bits=4, symmetric=True)
    cfg, rcfg = QuantizerConfig(**kw), RefQC(**kw)
    s = np.float32(np.abs(w).max() / 7)
    rqp = ref_q.QuantParams(s, np.float32(0))
    tqp = q.QuantParams(torch.tensor(s), torch.tensor(0.))
    ar = AdaRoundConfig(iterations=10, warmup_frac=0.2)
    idx = rs.randint(0, 64, 16)
    v_init = np.asarray(ref_ada.init_v(w, rqp, rcfg))
    tv0 = adaround.init_v(torch.from_numpy(w), tqp, cfg)
    np.testing.assert_allclose(tv0.numpy(), v_init, rtol=1e-5, atol=1e-5)
    # away from the init, where the soft-quantized weight equals w and the
    # reconstruction loss is rounding noise
    v0 = (v_init + rs.randn(*v_init.shape)).astype(np.float32)
    xb, yb = x[idx], (np.asarray(jnp.asarray(x) @ jnp.asarray(w)))[idx]
    for i in (0, 5):                       # warmup, then regularized
        total, warm = ar.iterations, int(ar.iterations * ar.warmup_frac)

        def ref_loss(v):
            t = jnp.clip((i - warm) / max(total - warm, 1), 0.0, 1.0)
            beta = ar.beta_end + (ar.beta_start - ar.beta_end) * 0.5 * \
                (1 + jnp.cos(jnp.pi * t))
            wq = ref_ada._soft_quant(w, v, rqp, rcfg)
            rec = jnp.mean(jnp.square(xb @ wq - yb))
            h = ref_ada._rectified_sigmoid(v)
            reg = jnp.sum(1.0 - jnp.abs(2.0 * h - 1.0) ** beta)
            return rec + ar.reg_lambda * jnp.where(i < warm, 0.0, reg)
        l_ref, g_ref = jax.value_and_grad(ref_loss)(jnp.asarray(v0))
        tv = torch.from_numpy(v0.copy()).requires_grad_(True)
        l_t = adaround.rounding_loss(tv, torch.from_numpy(w),
                                     torch.from_numpy(xb),
                                     torch.from_numpy(yb), i, tqp, cfg, ar)
        g_t, = torch.autograd.grad(l_t, tv)
        np.testing.assert_allclose(float(l_t.detach()), float(l_ref),
                                   rtol=1e-5)
        g_ref = np.asarray(g_ref)
        np.testing.assert_allclose(g_t.numpy(), g_ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g_ref).max()))


def test_ptq_with_adaround_sites_end_to_end(tiny_bert):
    cfg, params, batches = tiny_bert
    pol = QuantizationPolicy(act_default=A8_DEFAULT)
    _, tensors = collect_ranges(_forward(cfg), params, batches, pol)
    x_in = tensors["layer0/ffn_in"]
    w = params["layers"][0]["w_in"]
    site = "layer0/ffn/w_in"
    qm = ptq(_forward(cfg), params, batches, pol,
             named_weights=bert.named_weight_sites(cfg, params),
             adaround_sites={site: (w, x_in.reshape(-1, x_in.shape[-1]))},
             adaround_cfg=AdaRoundConfig(iterations=40, batch_size=64))
    w_ada = qm.adarounded_weights[site]
    assert w_ada.shape == w.shape and torch.isfinite(w_ada).all()
    qp = qm.weight_state[site]
    grid = w_ada / qp.scale
    assert torch.allclose(grid, torch.round(grid), atol=1e-4)
    assert not torch.equal(w_ada, fake_quant(w, qp, pol.weight_config(site)))


def test_mixed_precision_census_and_sweep():
    from repro_torch.core import mixed_precision_policy
    from repro.core import mixed_precision as ref_mp
    from repro.core import quant_config as ref_qc
    cfg = bert.BertConfig()
    sites = bert.activation_sites(cfg)
    assert len(sites) == 160
    hist = quantizer_census(mixed_precision_policy(), sites)
    ref_hist = ref_mp.quantizer_census(ref_qc.mixed_precision_policy(), sites)
    assert hist == ref_hist and hist["a16"] == 12 * 3 + 2
    pats = [r".*/softmax_in", FFN_PAT]
    pols = leave_one_out_policies(w8a8_policy(), pats)
    assert [p for p, _ in pols] == pats
    assert not pols[1][1].act_config("layer0/residual_ffn").enabled
    assert pols[1][1].act_config("layer0/attn/q").enabled
    got = sensitivity_sweep(lambda pol: sum(
        not pol.act_config(s).enabled for s in sites), w8a8_policy(), pats)
    assert got == {pats[0]: 12, pats[1]: 36}


# ---------------------------------------------------------------------------
# the table harness at micro size against benchmarks/common.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def harness_pair():
    """syn-mnli at the bench config: the reference's outlier init carried
    across, then 3 training steps on each side from it."""
    sys.path.insert(0, str(REPO))
    from benchmarks import common as ref_c
    from repro.optim import (adam_init as r_init, adam_update as r_upd,
                             apply_updates as r_apply,
                             clip_by_global_norm as r_clip,
                             linear_warmup_linear_decay as r_sched)
    from repro_torch.paper import common as c
    task = ref_c.GLUE_SUITE[5]
    rcfg = ref_c.bench_cfg(task)
    rparams = ref_c.init_with_outliers(rcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, rparams), device=CPU)
    src = ref_c._task_src(task)
    opt, lr, losses = r_init(rparams), r_sched(ref_c.TRAIN_LR, 3), []

    @jax.jit
    def step_fn(params, opt, batch):
        loss, g = jax.value_and_grad(
            lambda p: ref_bert.loss_fn(rcfg, p, batch))(params)
        g, _ = r_clip(g, 1.0)
        upd, opt = r_upd(g, opt, params, lr=lr)
        return r_apply(params, upd), opt, loss

    for i in range(3):
        b = {k: jnp.asarray(v) for k, v in src.batch(ref_c.BATCH, i).items()}
        rparams, opt, loss = step_fn(rparams, opt, b)
        losses.append(float(loss))
    from repro_torch.data.synthetic import GLUE_SUITE
    ttask = GLUE_SUITE[5]
    tcfg = c.bench_cfg(ttask)
    tparams, tlosses = c.train_steps(tcfg, tparams, c._task_src(ttask), 3,
                                     device=CPU)
    return ref_c, c, task, ttask, rparams, tparams, losses, tlosses


def test_train_steps_match_the_reference_losses(harness_pair):
    ref_c, c, task, ttask, rparams, tparams, losses, tlosses = harness_pair
    np.testing.assert_allclose(tlosses.numpy(), losses, rtol=1e-4)
    from repro_torch.optim.tree import tree_leaves
    for (path, b), a in zip(
            jax.tree_util.tree_flatten_with_path(rparams)[0],
            tree_leaves(tparams)):
        b = np.asarray(b)
        if "bk" in jax.tree_util.keystr(path):
            # the key biases' true gradient is 0 (softmax is
            # shift-invariant): Adam turns each side's rounding noise into
            # steps of up to lr, so they agree only within 3 steps
            np.testing.assert_allclose(a.numpy(), b, atol=3 * c.TRAIN_LR)
            continue
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))


@pytest.mark.parametrize("kind", ["w8a8", "peg"])
def test_quantize_and_eval_matches_the_reference(harness_pair, kind):
    """The same params on both sides (the reference's, after its 3 steps):
    the same act-state scales and a metric within 1 point."""
    from repro.core import peg_policy as r_peg, w8a8_policy as r_w8a8
    from repro.core.pipeline import ptq as r_ptq
    ref_c, c, task, ttask, rparams, _, _, _ = harness_pair
    tparams = params_from_jax(jax.tree.map(np.asarray, rparams), device=CPU)
    rpol, tpol = (r_w8a8(), w8a8_policy()) if kind == "w8a8" else \
        (r_peg(4), peg_policy(4))
    rcfg = ref_c.bench_cfg(task)

    def rfwd(p, b, ctx):
        return ref_bert.classify(rcfg, p, b["tokens"],
                                 type_ids=b.get("type_ids"),
                                 pad_mask=b.get("pad_mask"), ctx=ctx)
    rqm = r_ptq(rfwd, rparams, ref_c.calib_batches(task), rpol,
                named_weights=ref_bert.named_weight_sites(rcfg, rparams))
    # ref_c.eval_task's loop, with the forward jitted (eager JAX spends
    # seconds compiling each operator on first use)
    pred = jax.jit(lambda p, b: ref_bert.predict(rcfg, p, b, ctx=rqm.ctx()))
    src, preds, labels = ref_c._task_src(task), [], []
    for i in range(ref_c.EVAL_EXAMPLES // 64):
        b = src.batch(64, 100_000 + i)
        preds.append(np.asarray(pred(rparams, jax.tree.map(jnp.asarray, b))))
        labels.append(b["labels"])
    want_metric = src.metric(np.concatenate(preds), np.concatenate(labels))
    tcfg = c.bench_cfg(ttask)
    tqm = ptq(c._forward(tcfg), tparams, c.calib_batches(ttask, device=CPU),
              tpol, named_weights=bert.named_weight_sites(tcfg, tparams))
    want = act_state_from_jax(rqm.act_state, device=CPU)
    assert set(tqm.act_state) == set(want)
    for site, qp in want.items():
        got = tqm.act_state[site]
        np.testing.assert_allclose(got.scale.numpy(), qp.scale.numpy(),
                                   rtol=1e-6, err_msg=site)
        if qp.group_index is not None:
            assert torch.equal(got.group_index, qp.group_index)
    got_metric = c.quantize_and_eval(ttask, tparams, tpol, device=CPU)
    assert abs(got_metric - want_metric) <= 1.0
