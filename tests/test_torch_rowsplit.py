"""K1's row split (``fused_ln_quant.plan_row_split``) and a PyTorch model
of the cluster kernel's reduction order, on the CPU.

* The planner cuts a row into C slices, one block each (one thread-block
  cluster per row): C a power of two up to 16, rows x C about one wave of
  the card's 132 SMs, every slice a whole number of 8-column vectors (16
  bytes of bf16) with no vector across two PEG groups and at least 128
  columns; C = 1 at the reduced width d = 64.
* The model sums a row statistic as ``csrc/norm_quant.cu`` does: each
  thread its vectors in order, an xor butterfly over each warp, the warps
  of a rank in order, then the ranks 0..C-1. Its int8 emit must match the
  port's plain versions (``rms_quantize_plain``, ``ln_quantize_plain``),
  the JAX reference's oracles (``repro.kernels.ref``) and the reference's
  Pallas kernels in interpret mode within 1 LSB on at most 0.1 % of the
  elements: the reduction orders differ, so a value on a rounding tie may
  move one step.

Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_ln_quant as lnq


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d,groups", [
    (64, 1), (64, 4), (80, 4), (2304, 1), (2304, 4), (2304, 6), (4096, 1),
    (4096, 8), (8192, 4), (18, 2)])
@pytest.mark.parametrize("rows", [1, 4, 33, 64, 132, 4096])
def test_row_split_covers_every_column_once(rows, d, groups):
    split = lnq.plan_row_split(rows, d, groups)
    assert 1 <= split <= lnq.MAX_ROW_SPLIT and split & (split - 1) == 0
    spans = lnq.row_split_cols(d, split)
    assert len(spans) == split and spans[0][0] == 0 and spans[-1][1] == d
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c and b - a == d // split   # in order, equal slices
    gs = d // groups
    if lnq.row_vectorizable(d, groups):
        for a, b in spans:
            assert (b - a) % lnq.ROW_VEC == 0
            assert split == 1 or b - a >= lnq.MIN_SLICE_COLS
            for v in range(a, b, lnq.ROW_VEC):  # no vector across groups
                assert v // gs == (v + lnq.ROW_VEC - 1) // gs
    else:
        assert split == 1
    # the largest such power of two within one wave (SMS blocks)
    cap = max(1, min(-(-lnq.SMS // rows), lnq.MAX_ROW_SPLIT))
    fits = [c for c in (1, 2, 4, 8, 16) if c <= cap and (c == 1 or (
        lnq.row_vectorizable(d, groups) and d % (c * lnq.ROW_VEC) == 0
        and d // c >= lnq.MIN_SLICE_COLS))]
    assert split == max(fits)
    vec = lnq.ROW_VEC if lnq.row_vectorizable(d, groups) else 1
    nv, threads = lnq.row_threads(d // split, vec, split)
    assert threads % 32 == 0 and threads <= lnq.MAX_ROW_THREADS
    assert threads // 32 * split <= 32          # a lane per warp sum
    assert threads * nv * vec >= d // split > (threads - 32) * nv * vec


def test_row_split_serving_shapes():
    """gemma2-2b: 16 slices of 144 columns for the 4 decode rows, 2 for a
    64-row prefill chunk, none at the reduced d = 64."""
    assert lnq.plan_row_split(4, 2304, 1) == 16
    assert lnq.plan_row_split(4, 2304, 4) == 16
    assert lnq.plan_row_split(64, 2304, 1) == 2
    assert lnq.plan_row_split(4, 64, 4) == 1
    assert lnq.plan_row_split(64, 64, 1) == 1
    assert lnq.plan_row_split(1, 4096, 1) == 16
    assert lnq.plan_row_split(64, 4096, 4) == 2
    assert lnq.plan_row_split(4096, 4096, 8) == 1
    assert lnq.row_threads(144, 8, 16) == (1, 32)
    assert lnq.row_threads(1152, 8, 2) == (1, 160)


def _kernel_order_sum(terms, split, vec, nv, threads):
    """Row sums of ``terms`` (rows, d) f32 in the kernel's order: thread t
    of rank r sums its vectors t, t + threads, ... and their columns in
    order, a butterfly sums each warp, the warps of a rank are added in
    order, then the ranks in order."""
    rows, d = terms.shape
    nvec = d // split // vec
    t = terms.reshape(rows, split, nvec, vec)
    t = torch.cat([t, torch.zeros(rows, split, nv * threads - nvec, vec)], 2)
    t = t.reshape(rows, split, nv, threads, vec)
    acc = torch.zeros(rows, split, threads)
    for k in range(nv):
        for e in range(vec):
            acc = acc + t[:, :, k, :, e]
    lanes = acc.reshape(rows, split, threads // 32, 32)
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ off]
    warps = lanes[..., 0]
    total = None
    for r in range(split):
        part = warps[:, r, 0]
        for w in range(1, threads // 32):
            part = part + warps[:, r, w]
        total = part if total is None else total + part
    return total[:, None]


def _kernel_model(x, gamma, beta, s, z, *, ln, qmin, qmax, eps=1e-6):
    """The cluster kernel's int8 emit, with its reduction order."""
    rows, d = x.shape
    g = s.numel()
    split = lnq.plan_row_split(rows, d, g)
    vec = lnq.ROW_VEC if lnq.row_vectorizable(d, g) else 1
    plan = (split, vec) + lnq.row_threads(d // split, vec, split)
    xf = x.float()
    if ln:
        xc = xf - _kernel_order_sum(xf, *plan) / d
        y = xc * torch.rsqrt(_kernel_order_sum(xc * xc, *plan) / d + eps) \
            * gamma + beta
    else:
        y = xf * torch.rsqrt(_kernel_order_sum(xf * xf, *plan) / d + eps) \
            * (1.0 + gamma)
    sx = s.repeat_interleave(d // g)[None, :]
    zx = z.repeat_interleave(d // g)[None, :]
    return torch.clamp(torch.round(y / sx) + zx, qmin, qmax).to(torch.int8)


def _assert_lsb(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= 1e-3 * diff.size, \
        (int(diff.max()), int((diff > 0).sum()))


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("rows,d,dtype", [
    (4, 64, "float32"), (300, 64, "float32"), (4, 2304, "bfloat16"),
    (64, 2304, "bfloat16")])
def test_cluster_reduction_order_matches_plain_and_reference(rows, d, dtype,
                                                             groups, kind):
    """At d = 2304 the decode rows split 16 ways and a 64-row chunk 2 ways;
    d = 64 stays whole. Emit K1 (RMSNorm) and K8 (LayerNorm)."""
    rng = np.random.RandomState(rows + d + groups + len(kind))
    x = (rng.randn(rows, d) * 3 + (0.5 if kind == "ln" else 0.0)).astype(
        np.float32)
    gamma = (rng.randn(d) * 0.1 + (1.0 if kind == "ln" else 0.0)).astype(
        np.float32)
    beta = (rng.randn(d) * 0.1).astype(np.float32)
    s = rng.uniform(0.02, 0.05, groups).astype(np.float32)
    z = np.round(rng.uniform(-20, 20, groups)).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tg, tb, ts, tz = map(torch.from_numpy, (gamma, beta, s, z))
    kw = dict(qmin=-128, qmax=127)
    affine = (gamma, beta) if kind == "ln" else (gamma,)
    taffine = (tg, tb) if kind == "ln" else (tg,)
    got = _kernel_model(tx, tg, tb, ts, tz, ln=kind == "ln", **kw)
    plain = getattr(lnq, f"{kind}_quantize_plain")(tx, *taffine, ts, tz,
                                                  **kw)
    _assert_lsb(got.numpy(), plain.numpy())
    jargs = (jx, *map(jnp.asarray, affine), jnp.asarray(s), jnp.asarray(z))
    _assert_lsb(got.numpy(), getattr(jref, f"{kind}_quantize_ref")(*jargs,
                                                                    **kw))
    _assert_lsb(got.numpy(), getattr(jops, f"{kind}_quantize")(
        *jargs, interpret=True, **kw))
