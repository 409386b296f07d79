"""The port's quantization core (``repro_torch.core``) against the
reference (``repro.core``) on the same numpy tensors: fake-quant,
scale / zero-point derivation, range estimation (min-max, EMA, MSE), PEG
groups and the packed deploy payloads.

Scales and zero-points agree to rel 1e-6; group indices, permutations and
packed int8 payloads (``q``, ``colsum``) are bit-exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as jdeploy
from repro.core import peg as jpeg
from repro.core import quantizer as jq
from repro.core import range_estimation as jre
from repro.core.quant_config import (Granularity, QuantizerConfig,
                                     RangeEstimator)
from repro_torch.core import deploy, peg, quantizer as q
from repro_torch.core import quant_config as tqc
from repro_torch.core import range_estimation as re_

pytestmark = pytest.mark.deploy


def _cfg(**kw):
    """The same config in both packages (their dataclasses are copies)."""
    ref = QuantizerConfig(**kw)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fields["granularity"] = tqc.Granularity(ref.granularity.value)
    fields["estimator"] = tqc.RangeEstimator(ref.estimator.value)
    return ref, tqc.QuantizerConfig(**fields)


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rel, atol=0)


def _qp(jqp, with_gi=False):
    gi = None
    if with_gi:
        gi = torch.from_numpy(np.array(jqp.group_index)).long()
    return q.QuantParams(torch.from_numpy(np.array(jqp.scale)),
                         torch.from_numpy(np.array(jqp.zero_point)), gi)


CONFIGS = {
    "w8_sym_tensor": dict(bits=8, symmetric=True),
    "a8_asym_tensor": dict(bits=8, symmetric=False),
    "a8_asym_channel": dict(bits=8, symmetric=False,
                            granularity=Granularity.PER_CHANNEL),
    "w4_sym_channel": dict(bits=4, symmetric=True,
                           granularity=Granularity.PER_CHANNEL),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_range_and_fake_quant(name):
    jcfg, tcfg = _cfg(**CONFIGS[name])
    x = np.random.RandomState(0).randn(16, 24).astype(np.float32) * 2
    jmn, jmx = jq.reduce_range(jnp.asarray(x), jcfg)
    tmn, tmx = q.reduce_range(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(np.asarray(jmn), tmn.numpy())
    jqp = jq.params_from_range(jmn, jmx, jcfg)
    tqp = q.params_from_range(tmn, tmx, tcfg)
    _close(jqp.scale, tqp.scale)
    _close(jqp.zero_point, tqp.zero_point)
    want = np.asarray(jq.fake_quant(jnp.asarray(x), jqp, jcfg))
    np.testing.assert_array_equal(
        q.fake_quant(torch.from_numpy(x), _qp(jqp), tcfg).numpy(), want)


def test_fake_quant_peg_group_index():
    x = np.random.RandomState(1).randn(3, 5, 64).astype(np.float32)
    gi = np.random.RandomState(2).permutation(np.repeat(np.arange(4), 16))
    jcfg, tcfg = _cfg(bits=8, granularity=Granularity.PER_EMBEDDING_GROUP,
                      num_groups=4)
    jqp = jq.QuantParams(jnp.asarray([0.02, 0.03, 0.05, 0.08], jnp.float32),
                         jnp.asarray([100.0, 128.0, 90.0, 140.0]),
                         jnp.asarray(gi))
    want = np.asarray(jq.fake_quant(jnp.asarray(x), jqp, jcfg))
    got = q.fake_quant(torch.from_numpy(x), _qp(jqp, True), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mse_ratio_grid_is_the_reference_linspace():
    np.testing.assert_array_equal(re_.mse_ratios(100).numpy(),
                                  np.asarray(jnp.linspace(1 / 100, 1, 100)))


@pytest.mark.parametrize("name", ["w8_sym_tensor", "w4_sym_channel"])
def test_mse_search_matches(name):
    jcfg, tcfg = _cfg(estimator=RangeEstimator.MSE, **CONFIGS[name])
    w = np.random.RandomState(3).randn(48, 32).astype(np.float32) * 0.05
    jqp = jre.estimate_weight_params(jnp.asarray(w), jcfg)
    tqp = re_.estimate_weight_params(torch.from_numpy(w), tcfg)
    _close(jqp.scale, tqp.scale)
    _close(jqp.zero_point, tqp.zero_point)


@pytest.mark.parametrize("estimator", [RangeEstimator.RUNNING_MINMAX,
                                       RangeEstimator.CURRENT_MINMAX])
def test_observe_finalize_across_batches(estimator):
    jcfg, tcfg = _cfg(bits=8, estimator=estimator)
    rng = np.random.RandomState(4)
    jst, tst = jre.init_range_state(), re_.init_range_state()
    for _ in range(3):
        x = rng.randn(4, 16).astype(np.float32) * rng.uniform(0.5, 3)
        jst = jre.observe(jst, jnp.asarray(x), jcfg)
        tst = re_.observe(tst, torch.from_numpy(x), tcfg)
    jqp, tqp = jre.finalize(jst, jcfg), re_.finalize(tst, tcfg)
    _close(jqp.scale, tqp.scale)
    _close(jqp.zero_point, tqp.zero_point)


@pytest.mark.parametrize("d,k", [(64, 4), (2304, 4), (2304, 6), (100, 3)])
def test_build_groups_same_permutation_and_groups(d, k):
    ranges = np.random.RandomState(d + k).rand(d).astype(np.float32)
    js = jpeg.build_groups(ranges, k)
    ts = peg.build_groups(ranges, k)
    np.testing.assert_array_equal(js.permutation, ts.permutation)
    np.testing.assert_array_equal(js.group_index, ts.group_index)
    np.testing.assert_array_equal(js.group_sizes, ts.group_sizes)
    np.testing.assert_array_equal(jpeg.group_index_natural_layout(js),
                                  peg.group_index_natural_layout(ts))
    if (d, k) == (2304, 4):      # full-width gemma2-2b ffn_in: non-uniform
        assert ts.group_sizes.tolist() == [640, 640, 512, 512]


def test_peg_finalize_matches():
    jcfg, tcfg = _cfg(bits=8, granularity=Granularity.PER_EMBEDDING_GROUP,
                      num_groups=4, use_permutation=True)
    x = np.random.RandomState(5).randn(6, 64).astype(np.float32)
    x[:, 7] *= 20                                   # an outlier dim
    jst = jre.observe(jre.init_range_state(), jnp.asarray(x), jcfg)
    tst = re_.observe(re_.init_range_state(), torch.from_numpy(x), tcfg)
    spec = jpeg.build_groups(np.asarray(jst.x_max - jst.x_min), 4)
    gi = jpeg.group_index_natural_layout(spec)
    jqp = jre.finalize(jst, jcfg, group_index=jnp.asarray(gi))
    tqp = re_.finalize(tst, tcfg, group_index=torch.from_numpy(gi))
    _close(jqp.scale, tqp.scale)
    _close(jqp.zero_point, tqp.zero_point)


@pytest.mark.parametrize("g,permuted,stacked", [(1, False, False),
                                                (4, True, False),
                                                (4, True, True)])
def test_pack_linear_bit_exact(g, permuted, stacked):
    rng = np.random.RandomState(6)
    shape = (2, 64, 48) if stacked else (64, 48)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    perm = rng.permutation(64) if permuted else None
    jcfg, tcfg = _cfg(bits=8, symmetric=True, estimator=RangeEstimator.MSE)
    jp = jdeploy.pack_linear(jnp.asarray(w), jcfg, g,
                             None if perm is None else jnp.asarray(perm))
    tp = deploy.pack_linear(torch.from_numpy(w), tcfg, g,
                            None if perm is None else torch.from_numpy(perm))
    np.testing.assert_array_equal(tp["q"].numpy(), np.asarray(jp["q"]))
    np.testing.assert_array_equal(tp["colsum"].numpy(),
                                  np.asarray(jp["colsum"]))
    _close(jp["s"], tp["s"])


def test_act_quant_for_uniform_and_non_uniform_groups():
    jcfg, tcfg = _cfg(bits=8, granularity=Granularity.PER_EMBEDDING_GROUP,
                      num_groups=4)
    for d in (64, 2304):                    # 4 x 16 vs [640, 640, 512, 512]
        spec = peg.build_groups(np.random.RandomState(d).rand(d), 4)
        gi = peg.group_index_natural_layout(spec)
        s = np.array([0.01, 0.02, 0.03, 0.04], np.float32)
        z = np.array([120.0, 128.0, 130.0, 100.0], np.float32)
        jaq = jdeploy.act_quant_for(
            jq.QuantParams(jnp.asarray(s), jnp.asarray(z), jnp.asarray(gi)),
            jcfg)
        taq = deploy.act_quant_for(
            q.QuantParams(torch.from_numpy(s), torch.from_numpy(z),
                          torch.from_numpy(gi)), tcfg)
        assert (jaq is None) == (taq is None) == (d == 2304)
        if taq is not None:
            np.testing.assert_array_equal(taq.perm.numpy(),
                                          np.asarray(jaq.perm))
            np.testing.assert_array_equal(taq.zps.numpy(),
                                          np.asarray(jaq.zps))
            assert (taq.qmin, taq.qmax) == (jaq.qmin, jaq.qmax)
