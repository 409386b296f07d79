"""The port's 4-bit deploy path against the reference, on the CPU: nibble
layouts, the ``w_bits=4`` matmuls (K2, K3), the ``kv_bits=4`` decode
attention (K5, K6), 4-bit weight packing, the int4 KV caches, and the
reduced gemma2-2b served with ``--weight-bits 4 --kv-bits 4``.

On the CPU the port's wrappers run the kernels' plain PyTorch versions,
which unpack the nibbles and then repeat the 8-bit arithmetic; the
reference's Pallas kernels run in interpret mode. Inputs come from numpy
seeds. Bounds:

* Nibble layouts, ``q4`` payloads, colsums, int4 cache writes and the
  scheduler's counters: bit-exact.
* w4 matmuls: integer outputs bit-exact, f32 outputs within 1e-6 of
  max|ref| (the integer products are exact; the float epilogue runs in the
  same order).
* kv4 attention: the bounds of ``tests/test_torch_attention.py`` for kv8 —
  ``1e-5 * max|out|``, and with ``softmax_out`` at most 0.1 % of the rows
  one ``softmax_out`` step x max|v| away.
* Model logits: within 1e-4 of max|logits|, on inputs that put no
  quantization site within float rounding of a rounding tie (XLA and
  PyTorch sum f32 rows in other orders; the int4 KV grid is coarse, so a
  tie moves a logit far).
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
from repro.core import QuantizerConfig as JQuantizerConfig
from repro.core import RangeEstimator as JRangeEstimator
from repro.core import build_deploy as jbuild_deploy
from repro.core import peg_policy as jpeg_policy
from repro.core.deploy import pack_linear as jpack_linear
from repro.core.pipeline import ptq as jptq
from repro.kernels import nibble as jnibble
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.runtime import BlockPool as JBlockPool
from repro.runtime import Request as JRequest
from repro.runtime import serve as jserve
from repro.runtime.steps import make_admit_step as jmake_admit
from repro.runtime.steps import make_chunk_prefill_step as jmake_chunk
from repro.runtime.steps import make_decode_step as jmake_decode
from repro_torch.configs import get_config
from repro_torch.convert import (act_state_from_jax, caches_from_jax,
                                 params_from_jax)
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.core.deploy import pack_linear
from repro_torch.core.quant_config import QuantizerConfig, RangeEstimator
from repro_torch.kernels import nibble, ops
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, Request, make_admit_step,
                                 make_chunk_prefill_step, make_decode_step,
                                 serve)

pytestmark = [pytest.mark.deploy, pytest.mark.lowbit]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"
MAX_LEN, BS, CHUNK, SLOTS = 64, 8, 8, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Nibble layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((3, 5, 7), -1), ((2, 9, 4), 1),
                                        ((4, 64), -1), ((1,), 0)])
def test_split_half_nibbles_bit_exact(shape, axis):
    """Odd lengths pad a spare high nibble, dropped again by the unpack."""
    x = np.random.RandomState(len(shape) + shape[axis]).randint(
        -8, 8, shape).astype(np.int8)
    want = np.asarray(jnibble.pack_nibbles(jnp.asarray(x), axis=axis))
    got = nibble.pack_nibbles(_t(x), axis=axis)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    n = shape[axis]
    assert got.shape[axis] == nibble.packed_len(n) == jnibble.packed_len(n)
    np.testing.assert_array_equal(
        nibble.unpack_nibbles(got, n, axis=axis).numpy(), x)
    np.testing.assert_array_equal(
        nibble.unpack_nibbles(got, n, axis=axis).numpy(),
        np.asarray(jnibble.unpack_nibbles(jnp.asarray(want), n, axis=axis)))


@pytest.mark.parametrize("k", [2, 6, 128])
def test_pairwise_rows_bit_exact(k):
    w = np.random.RandomState(k).randint(-8, 8, (k, 12)).astype(np.int8)
    w[0, :2] = (-8, 7)                           # the two's-complement ends
    want = np.asarray(jnibble.pack_rows(jnp.asarray(w)))
    got = nibble.pack_rows(_t(w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nibble.unpack_rows(got).numpy(), w)


def test_nibble_extremes_and_odd_rows():
    x = torch.tensor([[-8, 7, -1, 0, 1, -7]], dtype=torch.int8)
    np.testing.assert_array_equal(
        nibble.unpack_nibbles(nibble.pack_nibbles(x), 6).numpy(), x.numpy())
    with pytest.raises(ValueError, match="even K"):
        nibble.pack_rows(torch.zeros((5, 4), dtype=torch.int8))


# ---------------------------------------------------------------------------
# K2 / K3 at w_bits=4
# ---------------------------------------------------------------------------

W4_CASES = [  # (m, k, n, epilogue)
    (1, 64, 96, "none"), (5, 80, 48, "bias"), (300, 64, 32, "requant"),
    (5, 64, 64, "all")]


def _epilogue_kwargs(rng, kind, m, n):
    kw = {}
    if kind in ("bias", "all"):
        kw["bias"] = (rng.randn(n) * 0.2).astype(np.float32)
    if kind == "all":
        kw["activation"] = "gelu"
        kw["mul"] = rng.randn(m, n).astype(np.float32)
    if kind in ("requant", "all"):
        kw["out_scale"] = np.float32(0.04)
        kw["out_zp"] = np.float32(-7.0)
    return ({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()},
            {k: _t(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()})


def _compare(got, want, requant):
    want = np.asarray(want)
    if requant:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), err


def _w4(rng, k, n):
    w = rng.randint(-7, 8, (k, n)).astype(np.int8)
    return w, np.asarray(jnibble.pack_rows(jnp.asarray(w)))


@pytest.mark.parametrize("m,k,n,epi", W4_CASES)
def test_int8_matmul_w4_matches_reference(m, k, n, epi):
    rng = np.random.RandomState(m + k + n)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w, w_pk = _w4(rng, k, n)
    cs = w.astype(np.int32).sum(0)
    jkw, tkw = _epilogue_kwargs(rng, epi, m, n)
    want = jops.int8_matmul(jnp.asarray(a), jnp.asarray(w_pk), s_a=0.03,
                            s_w=0.01, z_a=5.0, w_colsum=jnp.asarray(cs),
                            w_bits=4, **jkw)
    got = ops.int8_matmul(_t(a), _t(w_pk), s_a=0.03, s_w=0.01, z_a=5.0,
                          w_colsum=_t(cs), w_bits=4, **tkw)
    _compare(got, want, "out_scale" in tkw)
    # ... and the same product as the 8-bit matmul on the unpacked weight
    _compare(got, ops.int8_matmul(_t(a), _t(w), s_a=0.03, s_w=0.01,
                                  z_a=5.0, **tkw).numpy(), "out_scale" in tkw)


@pytest.mark.parametrize("m,k,n,epi", W4_CASES)
@pytest.mark.parametrize("g", [1, 4])
def test_int8_matmul_peg_w4_matches_reference(m, k, n, epi, g):
    """G = 4 over K = 64 is the reduced width's 16-wide groups (8 packed
    rows each, less than one k32 step of the kernel)."""
    rng = np.random.RandomState(m + k + n + g)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w, w_pk = _w4(rng, k, n)
    s = rng.uniform(0.01, 0.05, g).astype(np.float32)
    z = np.round(rng.uniform(-20, 20, g)).astype(np.float32)
    cs = w.astype(np.int32).reshape(g, k // g, n).sum(1)
    jkw, tkw = _epilogue_kwargs(rng, epi, m, n)
    want = jops.int8_matmul_peg(jnp.asarray(a), jnp.asarray(w_pk),
                                jnp.asarray(s), jnp.asarray(z), w_scale=0.02,
                                w_colsum=jnp.asarray(cs), w_bits=4, **jkw)
    got = ops.int8_matmul_peg(_t(a), _t(w_pk), _t(s), _t(z), w_scale=0.02,
                              w_colsum=_t(cs), w_bits=4, **tkw)
    _compare(got, want, "out_scale" in tkw)


def test_w4_colsum_must_be_given():
    """A colsum over packed bytes would be silently wrong: with z_a (or a
    PEG grid) and no colsum, w_bits=4 is refused."""
    a = torch.zeros((2, 8), dtype=torch.int8)
    w = torch.zeros((4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="w_colsum"):
        ops.int8_matmul(a, w, s_a=1.0, s_w=1.0, z_a=3.0, w_bits=4)
    with pytest.raises(ValueError, match="w_colsum"):
        ops.int8_matmul_peg(a, w, torch.ones(2), torch.zeros(2), w_scale=1.0,
                            w_bits=4)


# ---------------------------------------------------------------------------
# K5 / K6 at kv_bits=4
# ---------------------------------------------------------------------------

SITES = {
    "none": {},
    "softmax_out": dict(sm_quant=np.array([0.05, 128.0], np.float32),
                        sm_qmin=0, sm_qmax=255,
                        smo_quant=np.array([1 / 255, 0.0], np.float32),
                        smo_qmin=0, smo_qmax=255),
}


def _site(name, conv):
    return {k: conv(v) if isinstance(v, np.ndarray) else v
            for k, v in SITES[name].items()}


def _assert_attend(got, want, smo_step=None, v_absmax=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    tol = 1e-5 * np.abs(want).max()
    if smo_step is None:
        assert err.max() <= tol, (err.max(), tol)
        return
    off = (err.max(axis=-1) > tol).sum()
    assert off <= 1e-3 * err[..., 0].size, off
    assert err.max() <= smo_step * v_absmax * (1 + 1e-5), err.max()


def _kv4_case(rng, b, cells, kv, g, hd, zero_points):
    """int8 queries and a nibble-packed (b, cells, kv, hd/2) cache with its
    scales; int4 zero-points on the shifted grid, or none."""
    k4 = rng.randint(-8, 8, (b, cells, kv, hd)).astype(np.int8)
    v4 = rng.randint(-8, 8, (b, cells, kv, hd)).astype(np.int8)
    x = dict(q_q=rng.randint(-128, 128, (b, kv, g, hd)).astype(np.int8),
             q_scale=(rng.uniform(0.01, 0.03, (b, kv, g)) / 4).astype(
                 np.float32),
             k_q=np.asarray(jnibble.pack_nibbles(jnp.asarray(k4))),
             k_scale=rng.uniform(0.1, 0.5, (b, cells, kv)).astype(
                 np.float32),
             v_q=np.asarray(jnibble.pack_nibbles(jnp.asarray(v4))),
             v_scale=rng.uniform(0.1, 0.5, (b, cells, kv)).astype(
                 np.float32))
    zps = {}
    if zero_points:
        zps = dict(q_zp=np.round(rng.uniform(-20, 20, (b, kv, g))),
                   k_zp=np.round(rng.uniform(-3, 3, (b, kv))),
                   v_zp=np.round(rng.uniform(-3, 3, (b, kv))))
        zps = {k: v.astype(np.float32) for k, v in zps.items()}
    vmax = float((8 + (np.abs(zps["v_zp"]).max() if zps else 0.0))
                 * x["v_scale"].max())
    return x, zps, vmax


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("s_len,chunk,window", [(64, 16, None),
                                                (16, 16, 16)])
def test_int8_attend_decode_kv4_matches_reference(site, s_len, chunk,
                                                  window):
    """One-pass and two-pass (softmax_out), zero-points, softcap, a lane
    with an empty prefix (holes), an idle lane, and (S = 16) a ring whose
    slots wrapped: slot j holds position j + 16 for j < 8."""
    rng = np.random.RandomState(s_len + len(site))
    b, kv, g, hd = 3, 2, 2, 16
    x, zps, vmax = _kv4_case(rng, b, s_len, kv, g, hd, site != "none")
    k_pos = np.tile(np.arange(s_len, dtype=np.int32), (b, 1))
    k_pos[1, :5] = -1
    q_pos = np.array([s_len - 1, s_len - 3, -1], np.int32)
    if s_len == 16:
        k_pos[0] = np.where(k_pos[0] < 8, k_pos[0] + 16, k_pos[0])
        q_pos[0] = 23
    args = [x[n] for n in ("q_q", "q_scale", "k_q", "k_scale", "v_q",
                           "v_scale")] + [k_pos, q_pos]
    kw = dict(window=window, logit_softcap=50.0, chunk=chunk, kv_bits=4)
    want = jops.int8_attend_decode(
        *map(jnp.asarray, args), **kw,
        **{k: jnp.asarray(v) for k, v in zps.items()},
        **_site(site, jnp.asarray))
    got = ops.int8_attend_decode(*map(_t, args), **kw,
                                 **{k: _t(v) for k, v in zps.items()},
                                 **_site(site, _t))
    _assert_attend(got.numpy(), want,
                   1 / 255 if site == "softmax_out" else None, vmax)


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("nb,bs,s_cap,window", [(8, 8, 64, None),
                                                (8, 8, 16, 16)])
def test_paged_int8_attend_decode_kv4_matches_reference(site, nb, bs, s_cap,
                                                        window):
    """Packed arenas through a block table with unmapped (-1) blocks, a
    short lane, an idle lane and (s_cap 16) a ring past its wrap."""
    rng = np.random.RandomState(nb + s_cap + len(site))
    b, kv, g, hd = 4, 2, 2, 16
    n_blocks = b * nb + 2
    x, zps, vmax = _kv4_case(rng, n_blocks, bs, kv, g, hd, site != "none")
    zps = {k: v[:b] for k, v in zps.items()}
    table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[0, -1] = -1
    table[1, 1:] = -1
    q_pos = np.array([s_cap + 9, 3, s_cap - 1, -1], np.int32)
    args = [x["q_q"][:b], x["q_scale"][:b], x["k_q"], x["k_scale"], x["v_q"],
            x["v_scale"], table, q_pos]
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0, kv_bits=4)
    want = jops.paged_int8_attend_decode(
        *map(jnp.asarray, args), **kw,
        **{k: jnp.asarray(v) for k, v in zps.items()},
        **_site(site, jnp.asarray))
    got = ops.paged_int8_attend_decode(
        *map(_t, args), **kw, **{k: _t(v) for k, v in zps.items()},
        **_site(site, _t))
    _assert_attend(got.numpy(), want,
                   1 / 255 if site == "softmax_out" else None, vmax)


# ---------------------------------------------------------------------------
# 4-bit weight packing
# ---------------------------------------------------------------------------

W4 = QuantizerConfig(bits=4, symmetric=True, estimator=RangeEstimator.MSE)
JW4 = JQuantizerConfig(bits=4, symmetric=True,
                       estimator=JRangeEstimator.MSE)


def _assert_payload_equal(tp, jp):
    assert set(tp) == set(jp) == {"q4", "s", "colsum"}
    for field in ("q4", "s", "colsum"):
        np.testing.assert_array_equal(tp[field].numpy(),
                                      np.asarray(jp[field]), err_msg=field)


@pytest.mark.parametrize("shape,groups,perm", [
    ((64, 48), 4, False), ((64, 48), 4, True), ((3, 16, 8), 2, False)])
def test_pack_linear_q4_bit_exact(shape, groups, perm):
    """The MSE fit on the 4-bit grid, the pairwise-row nibbles and the
    colsum of the unpacked values; stacked (L, K, N) weights pack per
    layer; a PEG permutation reorders the rows first."""
    rng = np.random.RandomState(sum(shape))
    w = rng.randn(*shape).astype(np.float32)
    p = rng.permutation(shape[-2]) if perm else None
    jp = jpack_linear(jnp.asarray(w), JW4, groups,
                      None if p is None else jnp.asarray(p))
    tp = pack_linear(_t(w), W4, groups, None if p is None else _t(p))
    _assert_payload_equal(tp, jp)
    assert tp["q4"].shape[-2] == shape[-2] // 2


@pytest.mark.parametrize("k,groups", [(15, 1), (18, 6)])
def test_pack_linear_q4_gates_fall_back(k, groups):
    """Odd K, or an odd PEG group size, would split a byte: no payload,
    the site stays on the fake-quant path (as in the reference)."""
    w = np.random.RandomState(k).randn(k, 8).astype(np.float32)
    assert jpack_linear(jnp.asarray(w), JW4, groups) is None
    assert pack_linear(_t(w), W4, groups) is None


# ---------------------------------------------------------------------------
# Int4 KV caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_kv4_bit_exact(calibrated):
    """Dynamic grids (amax/7 on [-7, 7]) and calibrated ones (clip to
    [-8, 7]) on inputs with no value on a rounding tie, against the
    reference's quantizer under jit, as its serving steps run it."""
    rng = np.random.RandomState(21)
    x = (rng.randn(3, 7, 2, 16) * 2).astype(np.float32)
    grid = [rng.uniform(0.2, 0.5, 2).astype(np.float32),
            np.round(rng.uniform(-3, 3, 2)).astype(np.float32)] \
        if calibrated else [None, None]
    jq, js = jax.jit(jattn.quantize_kv4)(jnp.asarray(x), *[
        None if a is None else jnp.asarray(a) for a in grid])
    tq, ts = attn.quantize_kv4(_t(x), *[None if a is None else _t(a)
                                        for a in grid])
    assert tq.shape == (3, 7, 2, 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jc = jattn.Quant4KVCache(jq, jq, js, js, jnp.zeros((3, 7), jnp.int32))
    tc = attn.Quant4KVCache(tq, tq, ts, ts, torch.zeros(3, 7))
    for a, b in zip(attn.dequantize_kv(tc), jattn.dequantize_kv(jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("stacked", [True, False])
def test_int4_caches_convert_and_keep_their_type(paged, stacked):
    """A reference int4 cache written by a prefill converts to the port's
    int4 types (payloads hd/2 wide) bit for bit; the port's own init_cache
    builds the same structure; the lane reset keeps the type, agrees with
    the reference's and the paged block bytes follow the leaves."""
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    B = 3
    kw = dict(stacked=stacked, kv_bits=4, paged=paged, block_size=BS)
    jc = jtfm.init_cache(jcfg, B, 32, dtype=jnp.float32, **kw)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0), stacked=stacked,
                          dtype=jnp.float32)
    toks = np.random.RandomState(2).randint(0, 128, (B, 20))
    _, jc = jtfm.prefill(jcfg, jp, jnp.asarray(toks), jc)
    tc = caches_from_jax(_np_tree(jc), CPU)
    fresh = tfm.init_cache(cfg, B, 32, dtype=torch.float32, device=CPU, **kw)
    want = attn.PagedQuant4KVCache if paged else attn.Quant4KVCache
    nodes = tc.get("layers") or tc["scan"] + tc["tail"]
    fresh_nodes = fresh.get("layers") or fresh["scan"] + fresh["tail"]
    for a, b in zip(nodes, fresh_nodes):
        assert type(a) is type(b) is want
        assert [t.shape for t in a] == [t.shape for t in b]
        assert a.k_q.shape[-1] == cfg.hd // 2
    mask = np.array([True, False, True])
    jr = jtfm.cache_reset_slots(jc, jnp.asarray(mask))
    tr = tfm.cache_reset_slots(tc, _t(mask))
    for a, b in zip(tr.get("layers") or tr["scan"] + tr["tail"],
                    jr.get("layers") or jr["scan"] + jr["tail"]):
        assert type(a) is want and type(a).__name__ == type(b).__name__
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if paged:
        assert tfm.paged_block_bytes(tc) == jtfm.paged_block_bytes(jc)


# ---------------------------------------------------------------------------
# The reduced gemma2-2b at --weight-bits 4 --kv-bits 4
# ---------------------------------------------------------------------------

def _w4_policies():
    return (dataclasses.replace(jpeg_policy(4), weight_default=JW4),
            dataclasses.replace(peg_policy(4), weight_default=W4))


@pytest.fixture(scope="module")
def setup():
    """Reference params, PTQ at W4 and 4-bit deploy packing in both
    layouts; the port packs the carried-over params under the carried-over
    act state."""
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    jpol, pol = _w4_policies()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, stacked=True, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    rng = np.random.RandomState(10)
    calib = [{"tokens": jnp.asarray(rng.randint(0, cfg.vocab_size, (2, 12)))}
             for _ in range(2)]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, calib, jpol, collect_inputs=True)
    jshared = {}
    for site, qp in jqm.act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        jshared.setdefault(base, qp)
    shared = act_state_from_jax(_np_tree(jshared), CPU)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpol, jshared)
    packed, acts = build_deploy(
        cfg, params_from_jax(_np_tree(jstacked), CPU), pol, shared)

    def ctx():
        return QuantCtx(policy=pol, mode=Mode.DEPLOY, act_state=shared,
                        deploy_acts=acts)

    def jctx():
        return JQuantCtx(policy=jpol, mode=JMode.DEPLOY, act_state=jshared,
                         deploy_acts=jacts)
    return dict(jcfg=jcfg, cfg=cfg, jflat=jflat, jpol=jpol, pol=pol,
                jstate=jqm.act_state, jshared=jshared, shared=shared,
                jpacked=jpacked,
                jacts=jacts, packed=packed, acts=acts, ctx=ctx, jctx=jctx)


def test_build_deploy_w4_payloads_bit_exact(setup):
    """Every projection of every block packs to the same q4 / s / colsum
    as the reference's build_deploy (the reduced width's even K and
    16-wide PEG groups pass the 4-bit gate), in the stacked layout and in
    the unrolled one under the per-layer act state (params_from_jax maps
    q4 dicts leaf by leaf)."""
    s = setup
    jflat_packed, _ = jbuild_deploy(s["jcfg"], s["jflat"], s["jpol"],
                                    s["jstate"])
    flat_packed, _ = build_deploy(
        s["cfg"], params_from_jax(_np_tree(s["jflat"]), CPU), s["pol"],
        act_state_from_jax(_np_tree(s["jstate"]), CPU))
    n = 0
    for layout in ("scan", "layers"):
        jp = s["jpacked"] if layout == "scan" else jflat_packed
        tp = s["packed"] if layout == "scan" else flat_packed
        for jblk, blk in zip(jp[layout], tp[layout]):
            for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                                ("ffn", ("w_gate", "w_up", "w_out"))):
                for name in names:
                    _assert_payload_equal(blk[part][name],
                                          jblk[part][name])
                    n += 1
    assert n == 14 + 28
    carried = params_from_jax(_np_tree(s["jpacked"]), CPU)
    _assert_payload_equal(carried["scan"][0]["ffn"]["w_gate"],
                          s["jpacked"]["scan"][0]["ffn"]["w_gate"])
    assert set(s["acts"]) == set(s["jacts"])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


@pytest.mark.parametrize("paged", [False, True])
def test_w4_kv4_logits_match_reference(setup, paged):
    """Admit (one lane left-padded with dead cells) and 4 greedy decode
    steps through the w4 matmuls and K5 / K6 at kv_bits=4, teacher-forced
    on the reference's argmax; 22 prompt tokens + 4 wrap the local layers'
    16-cell ring. Seed 8 puts no quantization site on a rounding tie."""
    s = setup
    B, T, steps = 2, 22, 4
    toks = np.random.RandomState(8).randint(0, s["cfg"].vocab_size, (B, T))
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, :3] = -1
    pos[1, 3:] = np.arange(T - 3)
    mask = np.ones((B,), bool)
    kw = dict(kv_bits=4, paged=paged, block_size=BS)
    jc = jtfm.init_cache(s["jcfg"], B, MAX_LEN, dtype=jnp.float32, **kw)
    tc = tfm.init_cache(s["cfg"], B, MAX_LEN, dtype=torch.float32,
                        device=CPU, **kw)
    jadmit = jax.jit(jmake_admit(s["jcfg"], ctx_factory=s["jctx"]))
    jdecode = jax.jit(jmake_decode(s["jcfg"], ctx_factory=s["jctx"]))
    admit = make_admit_step(s["cfg"], ctx_factory=s["ctx"])
    decode = make_decode_step(s["cfg"], ctx_factory=s["ctx"])
    jl, jc = jadmit(s["jpacked"], jnp.asarray(toks), jnp.asarray(pos),
                    jnp.asarray(mask), jc)
    tl, tc = admit(s["packed"], torch.as_tensor(toks), torch.as_tensor(pos),
                   torch.as_tensor(mask), tc)
    assert _rel(jl, tl.numpy()) <= 1e-4
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    nxt = (pos.max(axis=1, keepdims=True) + 1).astype(np.int32)
    for step in range(steps):
        jl, jc = jdecode(s["jpacked"], jnp.asarray(cur), jnp.asarray(nxt),
                         jc)
        tl, tc = decode(s["packed"], torch.as_tensor(cur),
                        torch.as_tensor(nxt), tc)
        assert _rel(jl, tl.numpy()) <= 1e-4, (step, _rel(jl, tl.numpy()))
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        nxt = nxt + 1
    nodes = tc["scan"] + tc["tail"]
    assert all(isinstance(n, attn.PagedQuant4KVCache if paged
                          else attn.Quant4KVCache) for n in nodes)


def test_w4_kv4_continuous_scheduler_matches_reference(setup):
    """The quickstart workload (6 requests x 24 prompt tokens x 6 new, 4
    lanes, block pool, chunked prefill) through both packages' continuous
    Scheduler at kv4 and w4: the same greedy tokens and the same counters,
    peak KV-cache bytes included."""
    s = setup
    nb_lane = jtfm.paged_lane_blocks(s["jcfg"], MAX_LEN, BS)
    n_blocks = SLOTS * nb_lane

    def requests(cls):
        rng = np.random.RandomState(0)
        return [cls(rid=i, prompt=rng.randint(10, s["cfg"].vocab_size,
                                              size=24),
                    max_new_tokens=6) for i in range(6)]
    jreqs, treqs = requests(JRequest), requests(Request)
    jstats = jserve(
        None, jax.jit(jmake_admit(s["jcfg"], ctx_factory=s["jctx"])),
        jax.jit(jmake_decode(s["jcfg"], ctx_factory=s["jctx"])),
        lambda b: jtfm.init_cache(s["jcfg"], b, MAX_LEN, dtype=jnp.float32,
                                  kv_bits=4, paged=True, block_size=BS,
                                  num_blocks=n_blocks, mapped=False),
        s["jpacked"], jreqs, scheduler="continuous", batch_slots=SLOTS,
        max_len=MAX_LEN, block_pool=JBlockPool(n_blocks, BS, SLOTS, nb_lane),
        chunk_step=jax.jit(jmake_chunk(s["jcfg"], ctx_factory=s["jctx"])),
        prefill_chunk=CHUNK,
        write_caps=jtfm.attn_write_caps(s["jcfg"], MAX_LEN, BS))
    tstats = serve(
        None, make_decode_step(s["cfg"], ctx_factory=s["ctx"]),
        lambda b: tfm.init_cache(s["cfg"], b, MAX_LEN, dtype=torch.float32,
                                 kv_bits=4, paged=True, block_size=BS,
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
    assert (tstats.tokens_generated, tstats.decode_steps,
            tstats.prefill_calls, tstats.chunk_steps,
            tstats.blocks_in_use) == (36, 10, 6, 6, 16)


def test_launcher_serves_the_4bit_quickstart_with_parity(capsys):
    """``main`` with the README quickstart flags at ``--weight-bits 4
    --kv-bits 4 --parity`` on the CPU: the serve line's counts are the
    reference's, every weight packs as int4, the [kv-int4] lines print and
    the parity comparisons report match rates (kv4 drift is reported, not
    asserted, as in the reference), including the kv8 rerun."""
    argv = ["--arch", "gemma2-2b", "--reduced", "--requests", "6",
            "--prompt-len", "24", "--new-tokens", "6", "--max-len", "64",
            "--quantize", "--deploy-int8", "--kv-bits", "4",
            "--weight-bits", "4", "--scheduler", "continuous", "--paged-kv",
            "--block-size", "8", "--prefill-chunk", "8", "--parity"]
    stats = launcher.main(argv, device=CPU)
    out = capsys.readouterr().out
    assert stats.tokens_generated == 36
    assert re.search(r"\[serve:continuous\] 36 tokens, 10 decode steps, "
                     r"6 prefills, .* \(kv-bits 4, blocks 16/32 \(frag 22%, "
                     r"block-size 8\), chunked prefill \(6 chunk steps @ "
                     r"<= 8 tokens\)", out), out
    assert "packed weights: 0 int8 and 28 int4 (q4) payloads" in out, out
    assert re.search(r"^\[kv-int4\] max rel logits diff over prefill \+ 4 "
                     r"decode steps vs bf16 cache: \S+%$", out, re.M), out
    assert re.search(r"^\[kv-int4\] int4 vs int8 cache drift over prefill "
                     r"\+ 4 decode steps: max \|logit delta\| \S+, "
                     r"greedy-token match \d+/10 ", out, re.M), out
    rates = re.findall(r"^\[parity\] (.+?): \d+/36 greedy tokens match",
                       out, re.M)
    assert rates == ["continuous vs static schedulers",
                     "chunked vs unchunked prefill", "paged vs dense caches",
                     "int4 vs int8 KV cache drift"], out
    assert "[parity] OK" not in out
