"""The port's kernels (``repro_torch.kernels``) against the reference's
Pallas kernels (``repro.kernels.ops``, interpret mode on the CPU).

On the CPU the port's wrappers run the kernels' plain PyTorch versions, so
these tests hold the plain versions — which repeat the CUDA kernels'
arithmetic — to the reference. Inputs come from numpy seeds. Bounds:

* ``peg_quantize`` (K4): bit-exact.
* ``rms_quantize`` (K1) and the int8-requant epilogues of the matmuls: at
  most 1 LSB, on at most 0.1 % of elements. The f32 row reduction (and the
  ``rsqrt``/``tanh`` implementations) differ between XLA and PyTorch in the
  last bit, which moves values sitting on a rounding tie by one step; the
  flips are counted, not hidden in an ``allclose``.
* f32 matmul outputs (K2, K3): ``|delta| <= 1e-5 * max|ref|``.

The on-card comparison (kernel vs plain version on the GPU) is in
``tests/test_torch_cuda.py`` (marked ``cuda``; skips without a GPU) and
phase 2 of ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.deploy


def _flips(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), int((d > 0).sum())


def _assert_lsb(got, want):
    worst, n = _flips(got, want)
    assert worst <= 1 and n <= 1e-3 * np.size(want), (worst, n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(rng, g):
    s = rng.uniform(0.01, 0.05, g).astype(np.float32)
    z = np.round(rng.uniform(-20, 20, g)).astype(np.float32)
    return s, z


@pytest.mark.parametrize("m", [1, 5, 300])
@pytest.mark.parametrize("g", [1, 4])
def test_peg_quantize_bit_exact(m, g):
    rng = np.random.RandomState(m * 10 + g)
    x = (rng.randn(m, 64) * 2).astype(np.float32)
    s, z = _grid(rng, g)
    want = jops.peg_quantize(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z),
                             qmin=-128, qmax=127)
    got = ops.peg_quantize(_t(x), _t(s), _t(z), qmin=-128, qmax=127)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,d,g,dtype", [
    (300, 64, 1, "float32"), (300, 64, 4, "float32"), (5, 80, 4, "float32"),
    (1, 64, 1, "float32"), (300, 64, 4, "bfloat16")])
def test_rms_quantize_within_one_lsb(m, d, g, dtype):
    rng = np.random.RandomState(m + d + g)
    x = (rng.randn(m, d) * 3).astype(np.float32)
    gamma = (rng.randn(d) * 0.1).astype(np.float32)
    s, z = _grid(rng, g)
    jx = jnp.asarray(x, dtype=dtype)
    want = jops.rms_quantize(jx, jnp.asarray(gamma), jnp.asarray(s),
                             jnp.asarray(z), qmin=-128, qmax=127)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ops.rms_quantize(tx, _t(gamma), _t(s), _t(z), qmin=-128, qmax=127)
    assert got.dtype == torch.int8
    _assert_lsb(got.numpy(), want)


def _epilogue_kwargs(rng, kind, m, n):
    """(jax kwargs, torch kwargs) for one epilogue variant."""
    kw = {}
    if kind in ("bias", "all"):
        kw["bias"] = (rng.randn(n) * 0.2).astype(np.float32)
    if kind in ("gelu", "silu", "relu"):
        kw["activation"] = kind
    if kind == "all":
        kw["activation"] = "gelu"
        kw["mul"] = rng.randn(m, n).astype(np.float32)
    if kind in ("requant", "all"):
        kw["out_scale"] = np.float32(0.04)
        kw["out_zp"] = np.float32(-7.0)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    return jkw, tkw


def _compare(got, want, requant):
    want = np.asarray(want)
    if requant:
        assert got.dtype == torch.int8
        _assert_lsb(got.numpy(), want)
    else:
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), err


MATMUL_CASES = [  # (m, k, n, epilogue)
    (1, 64, 96, "none"), (5, 64, 96, "bias"), (300, 64, 32, "gelu"),
    (5, 80, 48, "silu"), (37, 64, 64, "relu"), (300, 64, 96, "requant"),
    (5, 80, 64, "all"), (300, 64, 96, "all")]


@pytest.mark.parametrize("m,k,n,epi", MATMUL_CASES)
def test_int8_matmul(m, k, n, epi):
    rng = np.random.RandomState(m + k + n)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    jkw, tkw = _epilogue_kwargs(rng, epi, m, n)
    want = jops.int8_matmul(jnp.asarray(a), jnp.asarray(w), s_a=0.03,
                            s_w=0.01, z_a=5.0, block_m=256, block_n=256,
                            block_k=512, **jkw)
    got = ops.int8_matmul(_t(a), _t(w), s_a=0.03, s_w=0.01, z_a=5.0, **tkw)
    _compare(got, want, "out_scale" in tkw)


@pytest.mark.parametrize("m,k,n,epi", MATMUL_CASES)
@pytest.mark.parametrize("g", [1, 4])
def test_int8_matmul_peg(m, k, n, epi, g):
    rng = np.random.RandomState(m + k + n + g)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s, z = _grid(rng, g)
    jkw, tkw = _epilogue_kwargs(rng, epi, m, n)
    want = jops.int8_matmul_peg(jnp.asarray(a), jnp.asarray(w),
                                jnp.asarray(s), jnp.asarray(z), w_scale=0.02,
                                **jkw)
    got = ops.int8_matmul_peg(_t(a), _t(w), _t(s), _t(z), w_scale=0.02,
                              **tkw)
    _compare(got, want, "out_scale" in tkw)


def test_batched_rows_and_colsum_default():
    """(B, T, K) inputs flatten to rows and come back; a missing colsum is
    computed from the int8 weights, as in the reference wrapper."""
    rng = np.random.RandomState(3)
    a = rng.randint(-128, 128, (3, 11, 64)).astype(np.int8)
    w = rng.randint(-127, 128, (64, 32)).astype(np.int8)
    want = jops.int8_matmul(jnp.asarray(a), jnp.asarray(w), s_a=0.03,
                            s_w=0.01, z_a=5.0)
    got = ops.int8_matmul(_t(a), _t(w), s_a=0.03, s_w=0.01, z_a=5.0)
    assert got.shape == (3, 11, 32)
    _compare(got, want, False)
    np.testing.assert_array_equal(
        ref.w_colsum_groups(_t(w), 4).numpy(),
        np.asarray(jref.w_colsum_groups(jnp.asarray(w), 4)))


@pytest.mark.parametrize("epi", ["none", "all"])
def test_oracles_match_reference_oracles(epi):
    """The dequantize-then-compute oracles of both packages agree."""
    rng = np.random.RandomState(11)
    m, k, n, g = 7, 64, 32, 4
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s, z = _grid(rng, g)
    jkw, tkw = _epilogue_kwargs(rng, epi, m, n)
    _compare(ref.int8_matmul_peg_fused_ref(_t(a), _t(w), _t(s), _t(z), 0.02,
                                           **tkw),
             jref.int8_matmul_peg_fused_ref(
                 jnp.asarray(a), jnp.asarray(w), jnp.asarray(s),
                 jnp.asarray(z), 0.02, **jkw), "out_scale" in tkw)
    _compare(ref.int8_matmul_fused_ref(_t(a), _t(w), 0.03, 0.01, z_a=5.0,
                                       **tkw),
             jref.int8_matmul_fused_ref(jnp.asarray(a), jnp.asarray(w), 0.03,
                                        0.01, z_a=5.0, **jkw),
             "out_scale" in tkw)


def test_device_dispatch_rejects_other_devices():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.peg_quantize(x, torch.ones(1), torch.zeros(1))


def test_four_bit_weights_not_yet_ported():
    """4-bit weights are ported now (``tests/test_torch_lowbit.py`` holds
    them to the reference): a (K/2, N) payload gives the (M, N) product,
    and bit widths the kernels do not have stay refused."""
    a = torch.zeros((2, 8), dtype=torch.int8)
    w = torch.zeros((4, 4), dtype=torch.int8)
    out = ops.int8_matmul(a, w, s_a=1.0, s_w=1.0, w_colsum=torch.zeros(4),
                          w_bits=4)
    assert out.shape == (2, 4)
    with pytest.raises(ValueError, match="w_bits must be 4 or 8"):
        ops.int8_matmul(a, w, s_a=1.0, s_w=1.0, w_colsum=torch.zeros(4),
                        w_bits=2)


# ---------------------------------------------------------------------------
# K8-K10: the LayerNorm emit and the fake-quant (dequantized) outputs
# ---------------------------------------------------------------------------

def _assert_steps(got, want, s, d):
    """Fake-quant outputs: equal but for values one grid step away (a 1-LSB
    flip at a tie, plus the rounding of the output dtype), on at most 0.1 %
    of elements."""
    eps = float(torch.finfo(got.dtype).eps)
    got = np.asarray(got.float().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    step = np.repeat(np.asarray(s, np.float64), d // np.size(s))[None, :]
    err = np.abs(got - want)
    off = err > 1e-6 * np.abs(want).max()
    assert off.sum() <= 1e-3 * want.size, off.sum()
    assert (err <= step * (1 + 1e-2) + np.abs(want) * eps).all()


NORM_CASES = [(300, 64, 1, "float32"), (5, 80, 4, "float32"),
              (64, 2304, 4, "bfloat16"), (1, 64, 1, "float32")]


@pytest.mark.parametrize("m,d,g,dtype", NORM_CASES)
@pytest.mark.parametrize("kernel", ["ln_quantize", "ln_fake_quant",
                                    "rms_fake_quant"])
def test_norm_quant_variants_match_reference(m, d, g, dtype, kernel):
    """K8 (LayerNorm + int8 emit), K9b (LayerNorm fake-quant) and K9a
    (RMSNorm fake-quant) against the reference's Pallas kernels; bf16 rows
    return bf16, rounded at the store."""
    rng = np.random.RandomState(m + d + g)
    x = (rng.randn(m, d) * 3 + 0.5).astype(np.float32)
    gamma = (1.0 + rng.randn(d) * 0.1).astype(np.float32)
    beta = (rng.randn(d) * 0.1).astype(np.float32)
    s, z = _grid(rng, g)
    jx = jnp.asarray(x, dtype=dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    affine = (gamma, beta) if kernel.startswith("ln") else (gamma,)
    want = getattr(jops, kernel)(jx, *map(jnp.asarray, affine),
                                 jnp.asarray(s), jnp.asarray(z), qmin=-128,
                                 qmax=127)
    got = getattr(ops, kernel)(tx, *map(_t, affine), _t(s), _t(z),
                               qmin=-128, qmax=127)
    if kernel == "ln_quantize":
        assert got.dtype == torch.int8
        _assert_lsb(got.numpy(), want)
    else:
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _assert_steps(got, np.asarray(want.astype(jnp.float32)), s, d)
    oracle = getattr(jref, kernel + "_ref")(
        jx, *map(jnp.asarray, affine), jnp.asarray(s), jnp.asarray(z),
        qmin=-128, qmax=127)
    port_oracle = getattr(ref, kernel + "_ref")(
        tx, *map(_t, affine), _t(s), _t(z), qmin=-128, qmax=127)
    if kernel == "ln_quantize":
        _assert_lsb(port_oracle.numpy(), oracle)
    else:
        _assert_steps(port_oracle, np.asarray(oracle.astype(jnp.float32)),
                      s, d)


@pytest.mark.parametrize("m,g,dtype", [(1, 1, "float32"),
                                       (300, 4, "float32"),
                                       (64, 4, "bfloat16")])
def test_peg_fake_quant_matches_reference(m, g, dtype):
    """K10: bit-exact (an elementwise quantize-dequantize has no
    reduction whose order could differ)."""
    rng = np.random.RandomState(m * 10 + g)
    x = (rng.randn(m, 64) * 2).astype(np.float32)
    s, z = _grid(rng, g)
    jx = jnp.asarray(x, dtype=dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want = jops.peg_fake_quant(jx, jnp.asarray(s), jnp.asarray(z),
                               qmin=-128, qmax=127)
    got = ops.peg_fake_quant(tx, _t(s), _t(z), qmin=-128, qmax=127)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(
        ref.peg_fake_quant_ref(tx, _t(s), _t(z), qmin=-128,
                               qmax=127).float().numpy(),
        np.asarray(jref.peg_fake_quant_ref(jx, jnp.asarray(s),
                                           jnp.asarray(z), qmin=-128,
                                           qmax=127).astype(jnp.float32)))


def test_layernorm_norm_quantize_with_permutation_matches_reference():
    """deploy.norm_quantize("layernorm", ...) under a PEG permutation: the
    input and both affine vectors (γ and β) are permuted, then K8 emits
    int8 on the group grids — as the reference's (tests/test_deploy.py)."""
    from repro.core import deploy as jdeploy
    from repro_torch.core import deploy
    rng = np.random.RandomState(4)
    d, g = 64, 4
    x = (rng.randn(1, 7, d) * 3).astype(np.float32)
    gamma = (1.0 + rng.randn(d) * 0.1).astype(np.float32)
    beta = (rng.randn(d) * 0.1).astype(np.float32)
    perm = rng.permutation(d)
    s, z = _grid(rng, g)
    jaq = jdeploy.ActQuant(scales=jnp.asarray(s), zps=jnp.asarray(z),
                           qmin=-128, qmax=127, perm=jnp.asarray(perm))
    taq = deploy.ActQuant(scales=_t(s), zps=_t(z), qmin=-128, qmax=127,
                          perm=_t(perm))
    want = jdeploy.norm_quantize("layernorm", {"g": jnp.asarray(gamma),
                                               "b": jnp.asarray(beta)},
                                 jnp.asarray(x), jaq)
    got = deploy.norm_quantize("layernorm", {"g": _t(gamma), "b": _t(beta)},
                               _t(x), taq)
    assert got.q.shape == (1, 7, d) and got.q.dtype == torch.int8
    _assert_lsb(got.q.numpy(), want.q)
    np.testing.assert_array_equal(got.scales.numpy(), s)
