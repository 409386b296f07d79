"""The port's decode-attention kernels (K5-K7) and KV-cache machinery
against the reference, on the CPU.

On the CPU the port's wrappers run the kernels' plain PyTorch versions, so
these tests hold the plain versions to the reference's Pallas kernels
(``repro.kernels.ops``, interpret mode), to its dequantize-then-attend
oracles (``repro.kernels.ref``) and to the port's copies of those
(``repro_torch.kernels.ref``), on seeded numpy inputs. Bounds:

* Without a ``softmax_out`` site: ``|delta| <= 1e-5 * max|out|`` (the
  float reductions run in another order: tiles with an online softmax in
  the reference, one softmax over all cells in the plain version).
* With ``softmax_out``: a probability within float rounding of a grid tie
  may land one step away, so at most 0.1 % of the output rows may differ
  by more than the bound above, each by at most one ``softmax_out`` step x
  max|v|.
* The cache machinery (int8 quantize / dequantize, the paged write with
  dead cells, derived positions, the block gather, the lane reset, the
  reference-cache conversion, the block pool) is bit-exact.

The same bounds hold each CUDA kernel against its plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.runtime.block_pool import BlockPool as JBlockPool
from repro_torch.configs import get_config
from repro_torch.convert import caches_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.runtime.block_pool import BlockPool

pytestmark = [pytest.mark.deploy, pytest.mark.paged]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


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


SITES = {
    "none": {},
    "softmax_in": dict(sm_quant=np.array([0.05, 128.0], np.float32),
                       sm_qmin=0, sm_qmax=255),
    "softmax_out": dict(sm_quant=np.array([0.05, 128.0], np.float32),
                        sm_qmin=0, sm_qmax=255,
                        smo_quant=np.array([1 / 255, 0.0], np.float32),
                        smo_qmin=0, smo_qmax=255),
}


def _site(name, conv):
    return {k: conv(v) if isinstance(v, np.ndarray) else v
            for k, v in SITES[name].items()}


def _int8_case(rng, b, s_len, kv, g, hd, zero_points):
    x = dict(q_q=rng.randint(-128, 128, (b, kv, g, hd)).astype(np.int8),
             q_scale=(rng.uniform(0.01, 0.03, (b, kv, g)) / 4).astype(
                 np.float32),
             k_q=rng.randint(-127, 128, (b, s_len, kv, hd)).astype(np.int8),
             k_scale=rng.uniform(0.01, 0.05, (b, s_len, kv)).astype(
                 np.float32),
             v_q=rng.randint(-127, 128, (b, s_len, kv, hd)).astype(np.int8),
             v_scale=rng.uniform(0.01, 0.05, (b, s_len, kv)).astype(
                 np.float32))
    zps = {}
    if zero_points:
        zps = dict(q_zp=np.round(rng.uniform(-20, 20, (b, kv, g))),
                   k_zp=np.round(rng.uniform(-20, 20, (b, kv))),
                   v_zp=np.round(rng.uniform(-20, 20, (b, kv))))
        zps = {k: v.astype(np.float32) for k, v in zps.items()}
    return x, zps


def _v_absmax(x, zps):
    zv = np.abs(zps["v_zp"]).max() if zps else 0.0
    return float((np.abs(x["v_q"].astype(np.float32)).max() + zv)
                 * x["v_scale"].max())


# ---------------------------------------------------------------------------
# K5: dense int8 cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_len,chunk", [(64, 256), (40, 16), (300, 256)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("window,softcap", [(None, None), (16, 50.0)])
def test_int8_attend_decode_matches_reference(s_len, chunk, site, window,
                                              softcap):
    """Zero-points (with any site), softcap, window, ragged S (padded to
    the chunk by the wrappers), an empty-prefix lane and an idle lane."""
    rng = np.random.RandomState(s_len + chunk)
    b, kv, g, hd = 3, 2, 2, 16
    x, zps = _int8_case(rng, b, s_len, kv, g, hd, site != "none")
    k_pos = np.tile(np.arange(s_len, dtype=np.int32), (b, 1))
    k_pos[1, :5] = -1
    q_pos = np.array([s_len - 1, s_len - 7, -1], np.int32)
    args = [x[n] for n in ("q_q", "q_scale", "k_q", "k_scale", "v_q",
                           "v_scale")] + [k_pos, q_pos]
    kw = dict(window=window, logit_softcap=softcap, chunk=chunk)
    want = jops.int8_attend_decode(
        *map(jnp.asarray, args), **kw, **{k: jnp.asarray(v) for k, v in
                                          zps.items()},
        **_site(site, jnp.asarray))
    got = ops.int8_attend_decode(*map(_t, args), **kw,
                                 **{k: _t(v) for k, v in zps.items()},
                                 **_site(site, _t))
    oracle = ref.int8_attend_decode_ref(
        *map(_t, args), window=window, logit_softcap=softcap,
        **{k: _t(v) for k, v in zps.items()}, **_site(site, _t))
    joracle = jref.int8_attend_decode_ref(
        *map(jnp.asarray, args), window=window, logit_softcap=softcap,
        **{k: jnp.asarray(v) for k, v in zps.items()},
        **_site(site, jnp.asarray))
    step = 1 / 255 if site == "softmax_out" else None
    _assert_attend(got.numpy(), want, step, _v_absmax(x, zps))
    # the oracles pad nothing, so the idle lane (a mean over every cell)
    # is compared where the wrapper padded nothing
    live = slice(None) if (-s_len) % min(chunk, s_len) == 0 else slice(2)
    for o in (oracle.numpy(), np.asarray(joracle)):
        _assert_attend(got.numpy()[live], o[live], step, _v_absmax(x, zps))


def test_int8_attend_decode_ragged_pad_marks_cells_empty():
    """The wrapper pads a ragged S with position -1 cells: a live lane's
    output is the same as over the unpadded cache."""
    rng = np.random.RandomState(3)
    x, _ = _int8_case(rng, 2, 40, 1, 2, 16, False)
    k_pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    args = [_t(x[n]) for n in ("q_q", "q_scale", "k_q", "k_scale", "v_q",
                               "v_scale")]
    q_pos = _t(np.array([39, 20], np.int32))
    padded = ops.int8_attend_decode(*args, _t(k_pos), q_pos, chunk=16)
    whole = ops.int8_attend_decode(*args, _t(k_pos), q_pos, chunk=256)
    _assert_attend(padded.numpy(), whole.numpy())


# ---------------------------------------------------------------------------
# K6 / K7: paged caches
# ---------------------------------------------------------------------------

def _paged_table(rng, b, nb, n_blocks):
    table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[0, -1] = -1
    table[1, 1:] = -1
    return table


@pytest.mark.parametrize("nb,bs,s_cap,window", [
    (8, 8, 64, None), (8, 8, 16, 16), (4, 4, 14, 14), (3, 8, 24, 10)])
@pytest.mark.parametrize("site", list(SITES))
def test_paged_int8_attend_decode_matches_reference(nb, bs, s_cap, window,
                                                    site):
    """-1 table entries, an idle lane, ring layers whose s_cap is below
    nb * bs (the wrapper cuts the table to ceil(s_cap / bs) columns),
    positions past the ring, zero-points with the sites."""
    rng = np.random.RandomState(nb * 100 + bs * 10 + s_cap)
    b, kv, g, hd = 4, 2, 2, 16
    n_blocks = b * nb + 2
    x, zps = _int8_case(rng, n_blocks, bs, kv, g, hd, site != "none")
    q = x["q_q"][:b]
    zps = {k: v[:b] for k, v in zps.items()}
    table = _paged_table(rng, b, nb, n_blocks)
    q_pos = np.array([s_cap + 9, 3, s_cap - 1, -1], np.int32)
    args = [q, x["q_scale"][:b], x["k_q"], x["k_scale"], x["v_q"],
            x["v_scale"], table, q_pos]
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0)
    want = jops.paged_int8_attend_decode(
        *map(jnp.asarray, args), **kw,
        **{k: jnp.asarray(v) for k, v in zps.items()},
        **_site(site, jnp.asarray))
    got = ops.paged_int8_attend_decode(
        *map(_t, args), **kw, **{k: _t(v) for k, v in zps.items()},
        **_site(site, _t))
    cols = -(-s_cap // bs)
    oracle = ref.paged_int8_attend_decode_ref(
        *map(_t, args[:6]), _t(table[:, :cols]), _t(q_pos), **kw,
        **{k: _t(v) for k, v in zps.items()}, **_site(site, _t))
    joracle = jref.paged_int8_attend_decode_ref(
        *map(jnp.asarray, args[:6]), jnp.asarray(table[:, :cols]),
        jnp.asarray(q_pos), **kw,
        **{k: jnp.asarray(v) for k, v in zps.items()},
        **_site(site, jnp.asarray))
    step = 1 / 255 if site == "softmax_out" else None
    for o in (want, oracle.numpy(), np.asarray(joracle)):
        _assert_attend(got.numpy(), o, step, _v_absmax(x, zps))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("site", ["none", "softmax_out"])
@pytest.mark.parametrize("s_cap,window", [(64, None), (16, 16)])
def test_paged_attend_decode_matches_reference(dtype, site, s_cap, window):
    rng = np.random.RandomState(17 + s_cap)
    b, nb, bs, kv, g, hd = 4, 8, 8, 2, 2, 16
    n_blocks = b * nb + 1
    q = (rng.randn(b, kv, g, hd) * 0.3).astype(np.float32)
    k = rng.randn(n_blocks, bs, kv, hd).astype(np.float32)
    v = rng.randn(n_blocks, bs, kv, hd).astype(np.float32)
    table = _paged_table(rng, b, nb, n_blocks)
    q_pos = np.array([s_cap + 3, 2, 30, -1], np.int32)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jops.paged_attend_decode(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(table), jnp.asarray(q_pos), **kw,
        **_site(site, jnp.asarray))
    got = ops.paged_attend_decode(
        _t(q), _t(k).to(tdt), _t(v).to(tdt), _t(table), _t(q_pos), **kw,
        **_site(site, _t))
    cols = -(-s_cap // bs)
    joracle = jref.paged_attend_decode_ref(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(table[:, :cols]), jnp.asarray(q_pos), **kw,
        **_site(site, jnp.asarray))
    oracle = ref.paged_attend_decode_ref(
        _t(q), _t(k).to(tdt), _t(v).to(tdt), _t(table[:, :cols]),
        _t(q_pos), **kw, **_site(site, _t))
    vmax = float(np.abs(v).max())
    for o in (want, np.asarray(joracle), oracle.numpy()):
        _assert_attend(got.numpy(), o,
                       1 / 255 if site == "softmax_out" else None, vmax)


def test_lane_blocks_cut_the_table_to_the_ring():
    table = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    assert ops._lane_blocks(table, 16, 8).shape == (2, 2)
    assert ops._lane_blocks(table, 14, 4).shape == (2, 4)
    assert ops._lane_blocks(table, 64, 8).shape == (2, 8)


@pytest.mark.parametrize("kv_bits", [4])
def test_int4_cache_variants_are_not_yet_ported(kv_bits):
    """The int4 variants are ported now (``tests/test_torch_lowbit.py``
    holds them to the reference); what stays refused is a bit width the
    kernels do not have, on the dense and the paged cache alike."""
    x = torch.zeros((1, 1, 1, 4), dtype=torch.int8)
    packed = torch.zeros((1, 1, 1, 2), dtype=torch.int8)
    out = ops.int8_attend_decode(x, torch.ones(1, 1, 1), packed,
                                 torch.ones(1, 1, 1), packed,
                                 torch.ones(1, 1, 1),
                                 torch.zeros(1, 1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32),
                                 kv_bits=kv_bits)
    assert out.shape == (1, 1, 1, 4)
    with pytest.raises(ValueError, match="kv_bits must be 4 or 8"):
        ops.int8_attend_decode(x, torch.ones(1, 1, 1), x, torch.ones(1, 1, 1),
                               x, torch.ones(1, 1, 1),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               kv_bits=kv_bits - 2)
    with pytest.raises(ValueError, match="kv_bits must be 4 or 8"):
        ops.paged_int8_attend_decode(
            x, torch.ones(1, 1, 1), x, torch.ones(1, 1, 1), x,
            torch.ones(1, 1, 1), torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), s_cap=1, kv_bits=kv_bits - 2)


# ---------------------------------------------------------------------------
# Cache machinery, bit-exact
# ---------------------------------------------------------------------------

class _KVQ:
    """A deploy.KVQuant stand-in with numpy grids (per head)."""

    def __init__(self, rng, kv, conv):
        self.k_grid = conv(rng.uniform(0.02, 0.05, kv).astype(np.float32))
        self.v_grid = conv(rng.uniform(0.02, 0.05, kv).astype(np.float32))
        self.k_zp = conv(np.round(rng.uniform(-9, 9, kv)).astype(np.float32))
        self.v_zp = conv(np.round(rng.uniform(-9, 9, kv)).astype(np.float32))


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_and_dequantize_kv_bit_exact(calibrated):
    """Against the reference's quantizer as its serving steps run it,
    under jit (where XLA computes the dynamic step amax / 127 as a product
    with the f32 reciprocal of 127)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 7, 2, 16) * 2).astype(np.float32)
    grid = [rng.uniform(0.02, 0.05, 2).astype(np.float32),
            np.round(rng.uniform(-9, 9, 2)).astype(np.float32)] \
        if calibrated else [None, None]
    jq, js = jax.jit(jattn.quantize_kv)(jnp.asarray(x), *[
        None if g is None else jnp.asarray(g) for g in grid])
    tq, ts = attn.quantize_kv(_t(x), *[None if g is None else _t(g)
                                       for g in grid])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    kvq = _KVQ(np.random.RandomState(6), 2, jnp.asarray) \
        if calibrated else None
    tkvq = _KVQ(np.random.RandomState(6), 2, _t) if calibrated else None
    jc = jattn.QuantKVCache(jq, jq, js, js, jnp.zeros((3, 7), jnp.int32))
    tc = attn.QuantKVCache(tq, tq, ts, ts, torch.zeros(3, 7))
    for a, b in zip(attn.dequantize_kv(tc, tkvq),
                    jattn.dequantize_kv(jc, kvq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _paged_caches(quant, n_blocks=10, bs=4, kv=2, hd=8):
    acfg = jattn.AttnConfig(num_heads=4, num_kv_heads=kv, head_dim=hd)
    tcfg = attn.AttnConfig(num_heads=4, num_kv_heads=kv, head_dim=hd)
    if quant:
        return (jattn.init_paged_quant_kv_cache(n_blocks, bs, acfg),
                attn.init_paged_quant_kv_cache(n_blocks, bs, tcfg, CPU))
    return (jattn.init_paged_kv_cache(n_blocks, bs, acfg, jnp.float32),
            attn.init_paged_kv_cache(n_blocks, bs, tcfg, torch.float32, CPU))


def _assert_cache_equal(tc, jc):
    assert type(tc).__name__ == type(jc).__name__
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 6])
def test_write_paged_kv_drops_dead_cells_bit_exact(quant, window):
    """Two writes: a prefill whose first lane is left-padded with dead
    cells and whose third lane maps no block for its tail, then a decode
    step with an idle lane; a ring layer wraps."""
    rng = np.random.RandomState(11)
    jc, tc = _paged_caches(quant)
    table = np.array([[3, 7, 1], [0, 2, 5], [9, -1, -1]], np.int32)
    pw = np.tile(np.arange(9, dtype=np.int32), (3, 1))
    pw[0, :3] = -1
    pw[0, 3:] = np.arange(6)
    for step_pw in (pw, np.array([[6], [9], [-1]], np.int32)):
        T = step_pw.shape[1]
        k = rng.randn(3, T, 2, 8).astype(np.float32)
        v = rng.randn(3, T, 2, 8).astype(np.float32)
        kvq = _KVQ(np.random.RandomState(1), 2, jnp.asarray) \
            if quant else None
        tkvq = _KVQ(np.random.RandomState(1), 2, _t) if quant else None
        jc = jattn._write_paged_kv(jc, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(step_pw), jnp.asarray(table),
                                   window, kvq)
        tc = attn._write_paged_kv(tc, _t(k), _t(v), _t(step_pw), _t(table),
                                  window, tkvq)
        _assert_cache_equal(tc, jc)
    # ... and what the read paths make of it
    q_pos = np.array([6, 9, -1], np.int32)
    s_cap = jattn.paged_capacity(table, 4, window)
    np.testing.assert_array_equal(
        attn.paged_key_positions(_t(table), _t(q_pos), s_cap, 4).numpy(),
        np.asarray(jattn.paged_key_positions(jnp.asarray(table),
                                             jnp.asarray(q_pos), s_cap, 4)))
    kvq = _KVQ(np.random.RandomState(1), 2, jnp.asarray) if quant else None
    tkvq = _KVQ(np.random.RandomState(1), 2, _t) if quant else None
    for a, b in zip(attn.paged_gather_kv(tc, _t(table), window, tkvq),
                    jattn.paged_gather_kv(jc, jnp.asarray(table), window,
                                          kvq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("q_pos", [[0, 5, 17, -1], [40, 3, 8, 63]])
@pytest.mark.parametrize("s_cap,bs", [(64, 8), (16, 8), (14, 4)])
def test_paged_key_positions_floor_modulo_bit_exact(q_pos, s_cap, bs):
    table = np.arange(32, dtype=np.int32).reshape(4, 8)
    table[2, 1] = -1
    qp = np.array(q_pos, np.int32)
    want = jattn.paged_key_positions(jnp.asarray(table), jnp.asarray(qp),
                                     s_cap, bs)
    got = attn.paged_key_positions(_t(table), _t(qp), s_cap, bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.paged_positions_ref(_t(table), _t(qp), s_cap=s_cap,
                                block_size=bs).numpy(),
        np.asarray(jref.paged_positions_ref(jnp.asarray(table),
                                            jnp.asarray(qp), s_cap=s_cap,
                                            block_size=bs)))
    arena = np.random.RandomState(bs).randn(32, bs, 2, 4).astype(np.float32)
    np.testing.assert_array_equal(
        ref.paged_gather_ref(_t(arena), _t(table)).numpy(),
        np.asarray(jref.paged_gather_ref(jnp.asarray(arena),
                                         jnp.asarray(table))))


@pytest.fixture(scope="module")
def reduced_cfgs():
    return (jget_config("gemma2-2b").reduced(),
            get_config("gemma2-2b").reduced())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("stacked", [True, False])
def test_caches_from_jax_and_cache_reset_slots_bit_exact(
        reduced_cfgs, kv_bits, paged, stacked):
    """A reference cache, written by a prefill, converts to the port's
    cache types; the lane reset then agrees bit for bit, and the port's
    own init_cache builds the same structure."""
    jcfg, cfg = reduced_cfgs
    B, max_len = 3, 32
    kw = dict(stacked=stacked, kv_bits=kv_bits, paged=paged, block_size=8)
    jc = jtfm.init_cache(jcfg, B, max_len, dtype=jnp.float32, **kw)
    key = jax.random.PRNGKey(0)
    jp = jtfm.init_params(jcfg, key, stacked=stacked, dtype=jnp.float32)
    toks = np.random.RandomState(2).randint(0, 128, (B, 20))
    pos = np.tile(np.arange(20, dtype=np.int32), (B, 1))
    pos[2, :6] = -1
    pos[2, 6:] = np.arange(14)
    _, jc = jtfm.prefill(jcfg, jp, jnp.asarray(toks), jc,
                         positions=jnp.asarray(pos))
    tc = caches_from_jax(_np_tree(jc), CPU)
    fresh = tfm.init_cache(cfg, B, max_len, dtype=torch.float32, device=CPU,
                           **kw)
    assert set(tc) == set(fresh)
    nodes = tc.get("layers") or tc["scan"] + tc["tail"]
    fresh_nodes = fresh.get("layers") or fresh["scan"] + fresh["tail"]
    for a, b in zip(nodes, fresh_nodes):
        assert type(a) is type(b)
        assert [t.shape for t in a] == [t.shape for t in b]
        assert [t.dtype for t in a] == [t.dtype for t in b]
    mask = np.array([True, False, True])
    jr = jtfm.cache_reset_slots(jc, jnp.asarray(mask))
    tr = tfm.cache_reset_slots(tc, _t(mask))
    jnodes = jr.get("layers") or jr["scan"] + jr["tail"]
    tnodes = tr.get("layers") or tr["scan"] + tr["tail"]
    for a, b in zip(tnodes, jnodes):
        _assert_cache_equal(a, b)
    if paged:
        np.testing.assert_array_equal(tr["block_table"].numpy(),
                                      np.asarray(jr["block_table"]))
        assert tfm.paged_block_bytes(tc) == jtfm.paged_block_bytes(jc)


def test_caches_from_jax_rejects_unported_cache_types(reduced_cfgs):
    """The int4 caches keep their type; the recurrent states (the RG-LRU
    blocks of recurrentgemma, RWKV-6's) convert to the port's
    ``RGLRUState`` / ``RWKVState``, leaf for leaf; a cache type the port
    does not have still raises."""
    import collections
    jcfg, _ = reduced_cfgs
    jc = jtfm.init_cache(jcfg, 2, 16, dtype=jnp.float32, kv_bits=4)
    assert isinstance(caches_from_jax(_np_tree(jc), CPU)["scan"][0],
                      attn.Quant4KVCache)
    for arch, name in (("recurrentgemma-2b", "RGLRUState"),
                       ("rwkv6-1p6b", "RWKVState")):
        rc = jtfm.init_cache(jget_config(arch).reduced(), 2, 16,
                             dtype=jnp.float32)
        got = caches_from_jax(_np_tree(rc), CPU)["scan"][0]
        want = rc["scan"][0]
        assert type(got).__name__ == name and got._fields == want._fields
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    other = collections.namedtuple("SSMState", "x")(np.zeros(2, np.float32))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        caches_from_jax({"layers": [other]}, CPU)


def test_paged_layout_helpers_match_reference(reduced_cfgs):
    jcfg, cfg = reduced_cfgs
    for max_len, bs in ((64, 8), (128, 16), (20, 8)):
        for fn in ("attn_write_spans",):
            assert getattr(tfm, fn)(cfg, max_len) == \
                getattr(jtfm, fn)(jcfg, max_len)
        for fn in ("paged_lane_blocks", "attn_write_caps",
                   "paged_ring_tokens"):
            assert getattr(tfm, fn)(cfg, max_len, bs) == \
                getattr(jtfm, fn)(jcfg, max_len, bs), (fn, max_len, bs)


def test_block_pool_matches_reference():
    """The same admissions, growth and retirements give the same table and
    gauges as the reference's pool."""
    pools = (BlockPool(12, 4, 3, 4), JBlockPool(12, 4, 3, 4))
    script = [("reserve_and_alloc", (0, 2, 4)), ("reserve_and_alloc",
                                                 (1, 1, 3)),
              ("grow", (0, 3)), ("reserve_and_alloc", (2, 4, 4)),
              ("free_lane", (1,)), ("grow", (0, 4)),
              ("reserve_and_alloc", (1, 2, 4)), ("free_lane", (0,)),
              ("reserve_and_alloc", (0, 1, 2))]
    for name, args in script:
        outs = [getattr(p, name)(*args) for p in pools]
        assert outs[0] == outs[1], name
        np.testing.assert_array_equal(pools[0].table, pools[1].table)
        for gauge in ("blocks_in_use", "blocks_free", "blocks_reserved"):
            assert getattr(pools[0], gauge) == getattr(pools[1], gauge)
        assert pools[0].fragmentation(9) == pools[1].fragmentation(9)
    assert not pools[0].can_reserve(5) and not pools[1].can_reserve(5)
    with pytest.raises(RuntimeError):
        pools[0].grow(0, 3)


# ---------------------------------------------------------------------------
# In-place cache writes against the functional writers they replaced
# ---------------------------------------------------------------------------

def _fresh_cache(kind, window, n_blocks=10, bs=4, batch=3, max_len=12):
    tcfg = attn.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=8,
                           window=window)
    paged, bits = kind.split("-")
    if paged == "paged":
        init = {"16": lambda: attn.init_paged_kv_cache(
                    n_blocks, bs, tcfg, torch.float32, CPU),
                "8": lambda: attn.init_paged_quant_kv_cache(
                    n_blocks, bs, tcfg, CPU),
                "4": lambda: attn.init_paged_quant4_kv_cache(
                    n_blocks, bs, tcfg, CPU)}[bits]
    else:
        init = {"16": lambda: attn.init_kv_cache(batch, max_len, tcfg,
                                                 torch.float32, CPU),
                "8": lambda: attn.init_quant_kv_cache(batch, max_len, tcfg,
                                                      CPU),
                "4": lambda: attn.init_quant4_kv_cache(batch, max_len, tcfg,
                                                       CPU)}[bits]
    return init()


@pytest.mark.parametrize("kind,calibrated", [
    ("dense-16", False), ("dense-8", False), ("dense-8", True),
    ("dense-4", False), ("dense-4", True), ("paged-16", False),
    ("paged-8", False), ("paged-8", True), ("paged-4", False),
    ("paged-4", True)])
@pytest.mark.parametrize("window", [None, 6])
def test_in_place_write_equals_the_functional_writer(kind, calibrated,
                                                     window):
    """A prefill whose first lane is left-padded with dead cells (and, on
    a paged arena, whose third lane maps no block for its tail), then a
    decode step with an idle lane, then a step where every cell is dead:
    the in-place writer leaves the very tensors it was given holding what
    the functional writer returns, bit for bit (a ring layer keeps the
    last min(T, S) tokens, as attention_block passes them)."""
    from torch_cache_oracle import write_kv, write_paged_kv
    rng = np.random.RandomState(11)
    cache = _fresh_cache(kind, window)
    want = type(cache)(*(t.clone() for t in cache))
    ptrs = [t.data_ptr() for t in cache]
    table = _t(np.array([[3, 7, 1], [0, 2, 5], [9, -1, -1]], np.int32))
    pw = np.tile(np.arange(9, dtype=np.int32), (3, 1))
    pw[0, :3] = -1
    pw[0, 3:] = np.arange(6)
    kvq = _KVQ(np.random.RandomState(1), 2, _t) if calibrated else None
    paged = kind.startswith("paged")
    S = attn.paged_capacity(table, 4, window) if paged \
        else cache.pos.shape[1]
    for step_pw in (pw, np.array([[6], [9], [-1]], np.int32),
                    np.full((3, 2), -1, np.int32)):
        keep = min(step_pw.shape[1], S)
        step_pw = step_pw[:, -keep:]
        k = _t(rng.randn(3, keep, 2, 8).astype(np.float32))
        v = _t(rng.randn(3, keep, 2, 8).astype(np.float32))
        p = _t(step_pw)
        if paged:
            got = attn._write_paged_kv(cache, k, v, p, table, window, kvq)
            want = write_paged_kv(want, k, v, p, table, window, kvq)
        else:
            got = attn._write_kv(cache, k, v, p, window, kvq)
            want = write_kv(want, k, v, p, attn._write_slots(p, S, window),
                            kvq)
        assert got is cache
        assert [t.data_ptr() for t in cache] == ptrs
        assert type(want) is type(cache)
        for a, b in zip(cache, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("stacked", [True, False])
def test_steps_write_the_cache_they_were_given(reduced_cfgs, monkeypatch,
                                               kv_bits, paged, stacked):
    """A prefill (one lane left-padded with dead cells) and three decode
    steps (one lane idle) write every layer's slice of the cache they were
    given, return that cache object, and leave it equal bit for bit to the
    same steps through the functional writers, with the same logits; the
    block table is the one that went in."""
    from torch_cache_oracle import use_functional_writers
    _, cfg = reduced_cfgs
    params = tfm.init_params(cfg, 3, stacked=stacked, dtype=torch.float32,
                             device=CPU)
    B, T = 3, 20
    toks = torch.as_tensor(np.random.RandomState(2).randint(0, 128, (B, T)))
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[2, :6] = -1
    pos[2, 6:] = np.arange(14)

    def run():
        cache = tfm.init_cache(cfg, B, 32, stacked=stacked, kv_bits=kv_bits,
                               paged=paged, block_size=8,
                               dtype=torch.float32, device=CPU)
        leaves = [t for t in tfm._cache_nodes(cache) for t in t]
        ptrs = [t.data_ptr() for t in leaves]
        table = cache.get("block_table")
        logits, out = tfm.prefill(cfg, params, toks, cache,
                                  positions=_t(pos))
        outs = [logits]
        assert out is cache
        cur = torch.argmax(logits, -1).to(torch.int32)
        nxt = _t(np.array([[20], [20], [-1]], np.int32))
        for _ in range(3):
            logits, out = tfm.decode_step(cfg, params, cur, nxt, cache)
            assert out is cache
            outs.append(logits)
            cur = torch.argmax(logits, -1).to(torch.int32)
            nxt = torch.where(nxt >= 0, nxt + 1, nxt)
        assert [t.data_ptr() for t in leaves] == ptrs
        assert cache.get("block_table") is table
        return outs, leaves
    got_logits, got = run()
    use_functional_writers(monkeypatch)
    want_logits, want = run()
    for a, b in zip(got_logits, want_logits):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
