"""The host planners of the split kernels (K3 ``int8_matmul`` split-K, K2
``int8_matmul_peg`` split by PEG group spans, K5 ``int8_attend_decode``
and K6 ``paged_int8_attend_decode`` split-KV) and PyTorch models of their
merges, on the CPU.

* The planners must cover every K tile, every dense cell and every paged
  block exactly once, in order, with no empty split; a K split keeps at
  least two K tiles, and a tile's K splits fit one thread-block cluster
  (at most 16); a KV split holds at most 128 cells, and there are at most
  32.
* Split-K: the splits' int32 partials, summed, equal the unsplit product
  exactly (8-bit and pairwise-row 4-bit weights).
* K2: the PEG planner's runs cover every K tile of every group once, none
  across a group, none empty, at most 16 blocks a cluster. A model of the
  cluster reduction (each group's int32 partial summed over its runs, the
  groups folded in group order) equals ``int8_matmul_peg_plain`` bit for
  bit, and the reference's Pallas kernel (interpret mode) bit for bit at
  G = 1; at G = 4 XLA rounds the group fold differently in the last bit,
  so there, and against the reference's dequantize-then-matmul oracle
  (which multiplies dequantized floats in another order), the bounds of
  ``tests/test_torch_kernels.py`` hold: f32 within 1e-5 of max|out|,
  requant within 1 LSB on at most 0.1 % of the elements.
* Split-KV: each split's softmax state (m_j, l_j, acc_j) over its blocks
  (K6) or cells (K5), merged in split order the way the kernel merges it
  (one pass, and the two-pass ``softmax_out`` schedule, where every split
  quantizes p on the global (m, l)), against
  ``paged_int8_attend_decode_plain`` and ``int8_attend_decode_plain`` with
  chip_smoke's bounds: within 1e-5 of max|out|, and with ``softmax_out``
  at most 0.1 % of the rows off, each by at most one step x max|v|. K7's
  float mode of the same body (f32 logits q . k on the stored f32 or bf16
  values, then the same merge with v_s = 1 and z_v = 0) is held with the
  same bounds to ``paged_attend_decode_plain``, to the reference's
  ``paged_attend_decode_ref`` and to its Pallas kernel in interpret mode.

The merge models live here, not in the package: the kernels are their only
implementation there. Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import int8_attend_decode as iad
from repro_torch.kernels import int8_matmul as imm
from repro_torch.kernels import nibble
from repro_torch.kernels import paged_attend_decode as pad
from repro_torch.kernels.int8_attend_decode import (NEG_INF, int8_logits,
                                                    kv_values)
from repro_torch.kernels.ref import (decode_valid, paged_gather_ref,
                                     paged_positions_ref, site_fake_quant)

MS, NS, KS = (1, 4, 16, 17, 64), (48, 1024, 2048, 2304), (64, 80, 2304)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", MS)
def test_k_split_plan_covers_every_tile_once(m, n, k):
    bm, bn, splits = imm.plan_k_splits(m, n, k)
    assert (bm, bn) == ((16, 128) if m <= 16 else (64, 64))
    kt = -(-k // imm.K_TILE)
    spans = imm.k_split_tiles(k, splits)
    assert len(spans) == splits and spans[0][0] == 0 and spans[-1][1] == kt
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c                           # in order, no gap or overlap
    assert all(b > a for a, b in spans)         # no empty split
    if splits > 1:
        assert all(b - a >= 2 for a, b in spans)
    tiles = -(-m // bm) * -(-n // bn)
    # the largest power of two that keeps the grid within twice the card,
    # a cluster, and two K tiles a split
    cap = max(1, min(-(-2 * imm.SMS // tiles), imm.MAX_K_SPLITS, kt // 2))
    assert splits & (splits - 1) == 0 and splits <= cap < 2 * splits


@pytest.mark.parametrize("s_cap,bs", [(128, 16), (4096, 16), (64, 8),
                                      (16, 8), (587, 16), (397, 8),
                                      (16, 16), (3, 8)])
@pytest.mark.parametrize("batch,kv", [(4, 4), (4, 2), (1, 1), (3, 8)])
def test_kv_split_plan_covers_every_block_once(s_cap, bs, batch, kv):
    nb = -(-s_cap // bs)
    splits, bps = pad.plan_kv_splits(batch, kv, nb, bs)
    spans = pad.kv_split_blocks(nb, splits, bps)
    assert 1 <= splits <= pad.MAX_SPLITS and bps <= pad.MAX_SPLIT_BLOCKS
    assert spans[0][0] == 0 and spans[-1][1] == nb
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c and b - a == bps
    assert all(b > a for a, b in spans)
    # a wave of blocks, unless the splits are as short as the blocks and
    # the kernel's split limit allow; <= 128 cells a split
    assert splits * batch * kv >= pad.SMS or bps == -(-nb // pad.MAX_SPLITS)
    assert bps * bs <= pad.MAX_SPLIT_CELLS or splits == pad.MAX_SPLITS \
        or bps == 1


@pytest.mark.parametrize("s_len", [1, 16, 40, 128, 300, 413, 587, 4000,
                                   4096])
@pytest.mark.parametrize("batch,kv", [(4, 4), (4, 2), (1, 1), (3, 8)])
def test_dense_kv_split_plan_covers_every_cell_once(s_len, batch, kv):
    splits, cps = iad.plan_dense_kv_splits(batch, kv, s_len)
    spans = iad.dense_split_cells(s_len, splits, cps)
    assert 1 <= splits <= iad.MAX_SPLITS and cps <= iad.MAX_SPLIT_CELLS
    assert cps % iad.SPLIT_UNIT == 0
    assert spans[0][0] == 0 and spans[-1][1] == s_len
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c and b - a == cps          # in order, no gap or overlap
    assert all(b > a for a, b in spans)         # none empty
    # a wave of blocks, unless the splits are as short as the unit and the
    # kernel's split limit allow
    units = -(-s_len // iad.SPLIT_UNIT)
    assert splits * batch * kv >= iad.SMS or \
        cps == iad.SPLIT_UNIT * -(-units // iad.MAX_SPLITS)


def test_dense_kv_split_plan_serving_shapes():
    """The full-width dense shapes: 8 splits of 16 cells at S = 128 (the
    cells K6 cuts at s_cap 128, bs 16), 32 of 128 at the 4096 window."""
    assert iad.plan_dense_kv_splits(4, 4, 128) == (8, 16)
    assert iad.plan_dense_kv_splits(4, 4, 4096) == (32, 128)


def test_kv_split_plan_serving_shapes():
    """The full-width serving shapes: 8 one-block splits at s_cap 128
    (128 blocks of threads), 32 splits of 8 blocks at the 4096 window."""
    assert pad.plan_kv_splits(4, 4, 8, 16) == (8, 1)
    assert pad.plan_kv_splits(4, 4, 256, 16) == (32, 8)


@pytest.mark.parametrize("m,k,n,w_bits", [
    (4, 2304, 2048, 8), (17, 2304, 48, 8), (1, 2304, 1024, 4),
    (64, 80, 48, 8), (16, 2304, 2304, 4)])
def test_split_k_partials_sum_to_the_product(m, k, n, w_bits):
    rng = np.random.default_rng(k + n + m)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    lo = -8 if w_bits == 4 else -127
    hi = 8 if w_bits == 4 else 128
    w = torch.from_numpy(rng.integers(lo, hi, (k, n), dtype=np.int8))
    w_q = nibble.pack_rows(w) if w_bits == 4 else w
    w_vals = nibble.unpack_rows(w_q) if w_bits == 4 else w_q
    _, _, splits = imm.plan_k_splits(m, n, k)
    total = torch.zeros((m, n), dtype=torch.int32)
    for t0, t1 in imm.k_split_tiles(k, splits):
        k0, k1 = t0 * imm.K_TILE, min(k, t1 * imm.K_TILE)
        assert k0 % 2 == 0                      # no nibble byte is split
        part = a[:, k0:k1].long() @ w_vals[k0:k1].long()
        total += part.to(torch.int32)           # int32 adds, any order
    assert torch.equal(total, (a.long() @ w.long()).to(torch.int32))
    got = imm.int8_matmul_plain(a, w_q, 0.03, 0.01, w_bits=w_bits)
    want = (a.double() @ w.double()).float() * (torch.tensor(0.03) *
                                                torch.tensor(0.01))
    assert torch.equal(got, want)


PEG_SHAPES = [(m, n, k, g) for m in (1, 4, 17, 64) for n in (128, 9216)
              for k, g in ((64, 4), (2304, 4), (2304, 6), (2304, 1),
                           (1024, 4), (256, 1), (2304, 36))]


@pytest.mark.parametrize("m,n,k,g", PEG_SHAPES)
def test_peg_split_plan_covers_every_group_tile_once(m, n, k, g):
    bm, bn, runs, per_cluster = imm.plan_peg_splits(m, n, k, g)
    assert (bm, bn) == ((16, 128) if m <= 16 else (64, 64))
    assert runs & (runs - 1) == 0 and runs * per_cluster <= imm.MAX_K_SPLITS
    kt = -(-(k // g) // imm.K_TILE)             # K tiles of a group
    seen = {grp: [] for grp in range(g)}
    rounds = imm.peg_split_runs(k, g, runs, per_cluster)
    assert len(rounds) == -(-g // per_cluster)
    for rnd in rounds:
        assert len({rank for rank, *_ in rnd}) == len(rnd)
        assert all(rank < runs * per_cluster for rank, *_ in rnd)
        for _, grp, t0, t1 in rnd:
            assert t1 > t0                       # no empty run
            assert t1 - t0 >= 2 or kt < 2 * runs  # two tiles where it can
            seen[grp].append((t0, t1))
    for grp, spans in seen.items():              # each group's tiles once,
        spans.sort()                             # in runs inside the group
        assert spans[0][0] == 0 and spans[-1][1] == kt
        assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    # no more runs than fill the card about twice, unless one run a group;
    # no more blocks than the card holds at once, unless one group a
    # cluster; equal rounds
    tiles = -(-m // bm) * -(-n // bn)
    assert runs == 1 or tiles * runs * per_cluster <= 2 * imm.SMS + tiles * \
        per_cluster
    assert per_cluster == 1 or tiles * runs * per_cluster <= \
        imm.PEG_BLOCKS_PER_SM * imm.SMS
    assert len(rounds) * per_cluster - g < len(rounds)


def test_peg_split_plan_serving_shapes():
    """The full-width FFN shapes one run per group: 288 blocks at 64 rows
    (clusters of two groups, walked in two rounds at G = 4, three at G =
    6) and at the decode rows (all four groups a cluster; G = 6 in two
    rounds of three); the reduced one (4 groups of 16) one cluster of four
    one-tile runs."""
    assert imm.plan_peg_splits(64, 9216, 2304, 4) == (64, 64, 1, 2)
    assert imm.plan_peg_splits(4, 9216, 2304, 4) == (16, 128, 1, 4)
    assert imm.plan_peg_splits(64, 9216, 2304, 6) == (64, 64, 1, 2)
    assert imm.plan_peg_splits(4, 9216, 2304, 6) == (16, 128, 1, 3)
    assert imm.plan_peg_splits(8, 128, 64, 4) == (16, 128, 1, 4)


def _peg_cluster_model(a, w_q, s, z, s_w, colsum, *, w_bits, **epi):
    """K2's arithmetic as the cluster kernel runs it: per round, each
    group's int32 partial summed over its runs (in run order; int32 sums
    are exact), the groups folded into the f32 accumulator in group
    order, then the epilogue."""
    m, k = a.shape
    w = nibble.unpack_rows(w_q) if w_bits == 4 else w_q
    g = s.numel()
    gs = k // g
    _, _, runs, per_cluster = imm.plan_peg_splits(m, w.shape[1], k, g)
    facc = torch.zeros((m, w.shape[1]), dtype=torch.float32)
    for rnd in imm.peg_split_runs(k, g, runs, per_cluster):
        parts = {}
        for _, grp, t0, t1 in rnd:
            k0 = grp * gs + t0 * imm.K_TILE
            k1 = min((grp + 1) * gs, grp * gs + t1 * imm.K_TILE)
            assert k0 % 2 == 0 and k0 < k1      # no nibble byte is split
            part = (a[:, k0:k1].long() @ w[k0:k1].long()).to(torch.int32)
            parts[grp] = parts.get(grp, 0) + part
        for grp in sorted(parts):
            facc = facc + s[grp] * (parts[grp].float()
                                    - z[grp] * colsum[grp].float()[None, :])
    return imm.epilogue(facc * torch.tensor(s_w, dtype=torch.float32), **epi)


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("m,k,n", [(4, 64, 128), (8, 256, 96),
                                   (64, 1024, 64), (17, 1024, 128)])
def test_peg_cluster_reduction_matches_plain_and_reference(m, k, n, g,
                                                           requant, w_bits):
    rng = np.random.RandomState(m + k + n + g + w_bits)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    lo, hi = (-8, 8) if w_bits == 4 else (-127, 128)
    w = rng.randint(lo, hi, (k, n)).astype(np.int8)
    w_q = nibble.pack_rows(torch.from_numpy(w)) if w_bits == 4 else \
        torch.from_numpy(w)
    s = rng.uniform(0.01, 0.05, g).astype(np.float32)
    z = np.round(rng.uniform(-20, 20, g)).astype(np.float32)
    colsum = np.stack([w[i * (k // g):(i + 1) * (k // g)].astype(
        np.int32).sum(0) for i in range(g)])
    epi = {}
    if requant:
        epi = dict(activation="gelu", mul=rng.randn(m, n).astype(np.float32),
                   out_scale=np.float32(0.04), out_zp=np.float32(-7.0))
    tepi = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for key, v in epi.items()}
    ts, tz, tcs = (torch.from_numpy(x) for x in (s, z, colsum))
    got = _peg_cluster_model(torch.from_numpy(a), w_q, ts, tz, 0.02, tcs,
                             w_bits=w_bits, **tepi)
    plain = imm.int8_matmul_peg_plain(torch.from_numpy(a), w_q, ts, tz, 0.02,
                                      tcs, w_bits=w_bits, **tepi)
    assert got.dtype == plain.dtype and torch.equal(got, plain)
    jkw = {key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for key, v in epi.items()}
    pallas = jops.int8_matmul_peg(
        jnp.asarray(a), jnp.asarray(w_q.numpy()), jnp.asarray(s),
        jnp.asarray(z), w_scale=0.02, w_colsum=jnp.asarray(colsum),
        w_bits=w_bits, **jkw)
    oracle = jref.int8_matmul_peg_fused_ref(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(s), jnp.asarray(z), 0.02,
        **jkw)
    if g == 1:          # one group: no fold, the same f32 operations
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    for want in (np.asarray(pallas), np.asarray(oracle)):
        if requant:
            d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.size
        else:
            err = float(np.abs(got.numpy() - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), err


def _masked_logits(q_q, q_scale, q_zp, k_zp, k, k_scale, valid, **kw):
    return _sites_and_mask(int8_logits(q_q, q_scale, q_zp, k_zp, k,
                                       k_scale), valid, **kw)


def _sites_and_mask(s, valid, *, logit_softcap, sm_quant, sm_qmin,
                    sm_qmax):
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if sm_quant is not None:
        s = site_fake_quant(s, sm_quant, sm_qmin, sm_qmax)
    return torch.where(valid[:, None, None, :], s, NEG_INF)


def _merge_splits(s, v, v_scale, v_zp, cells, *, smo_quant, smo_qmin,
                  smo_qmax):
    """The split-KV kernels' arithmetic on masked logits s (B, KV, G, S):
    each split's softmax state over its cells, merged in split order."""
    b, kv, g, _ = s.shape
    hd = v.shape[-1]
    vs = v_scale.float().permute(0, 2, 1)[:, :, None]
    zv = v_zp.float()[:, :, None, None]

    def partial(p, c):                       # sum p v_s v - z_v sum p v_s
        pv = p * vs[..., c]
        return (torch.einsum("bkgs,bskd->bkgd", pv, v[:, c].float())
                - zv * pv.sum(-1, keepdim=True))

    ms = [torch.clamp_min(s[..., c].amax(-1, keepdim=True), NEG_INF)
          for c in cells]
    ls = [torch.exp(s[..., c] - mj).sum(-1, keepdim=True)
          for c, mj in zip(cells, ms)]
    m = ms[0]
    for mj in ms[1:]:
        m = torch.maximum(m, mj)
    l = torch.zeros_like(m)
    for mj, lj in zip(ms, ls):
        l = l + lj * torch.exp(mj - m)
    l = torch.clamp_min(l, 1e-30)
    out = torch.zeros((b, kv, g, hd))
    for c, mj in zip(cells, ms):
        if smo_quant is None:
            out = out + partial(torch.exp(s[..., c] - mj), c) * torch.exp(
                mj - m)
        else:
            p = site_fake_quant(torch.exp(s[..., c] - m) / l, smo_quant,
                                smo_qmin, smo_qmax)
            out = out + partial(p, c)
    return out if smo_quant is not None else out / l


def _split_attend(args, *, s_cap, window, logit_softcap, sm_quant, sm_qmin,
                  sm_qmax, smo_quant, smo_qmin, smo_qmax, kv_bits):
    """K6's split-KV arithmetic in PyTorch: per-split softmax states over
    runs of paged blocks, merged in split order."""
    (q_q, q_scale, q_zp, k_zp, v_zp, k_arena, k_scale, v_arena, v_scale,
     table, q_pos) = args
    b, kv, g, hd = q_q.shape
    nb, bs = table.shape[1], k_arena.shape[1]
    k, v = kv_values(paged_gather_ref(k_arena, table),
                     paged_gather_ref(v_arena, table), hd, kv_bits)
    kp = paged_positions_ref(table, q_pos, s_cap=s_cap, block_size=bs)
    s = _masked_logits(q_q, q_scale, q_zp, k_zp, k,
                       paged_gather_ref(k_scale, table),
                       decode_valid(kp, q_pos, window),
                       logit_softcap=logit_softcap, sm_quant=sm_quant,
                       sm_qmin=sm_qmin, sm_qmax=sm_qmax)
    splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
    cells = [slice(a * bs, e * bs)
             for a, e in pad.kv_split_blocks(nb, splits, bps)]
    return _merge_splits(s, v, paged_gather_ref(v_scale, table), v_zp,
                         cells, smo_quant=smo_quant, smo_qmin=smo_qmin,
                         smo_qmax=smo_qmax)


def _dense_split_attend(args, *, window, logit_softcap, sm_quant, sm_qmin,
                        sm_qmax, smo_quant, smo_qmin, smo_qmax, kv_bits):
    """K5's split-KV arithmetic in PyTorch: per-split softmax states over
    runs of dense cells, valid by their stored positions, merged in split
    order."""
    (q_q, q_scale, q_zp, k_zp, v_zp, k_q, k_scale, v_q, v_scale, k_pos,
     q_pos) = args
    b, kv, g, hd = q_q.shape
    s_len = k_pos.shape[1]
    k, v = kv_values(k_q, v_q, hd, kv_bits)
    s = _masked_logits(q_q, q_scale, q_zp, k_zp, k, k_scale,
                       decode_valid(k_pos, q_pos, window),
                       logit_softcap=logit_softcap, sm_quant=sm_quant,
                       sm_qmin=sm_qmin, sm_qmax=sm_qmax)
    splits, cps = iad.plan_dense_kv_splits(b, kv, s_len)
    cells = [slice(a, e) for a, e in iad.dense_split_cells(s_len, splits,
                                                           cps)]
    return _merge_splits(s, v, v_scale, v_zp, cells, smo_quant=smo_quant,
                         smo_qmin=smo_qmin, smo_qmax=smo_qmax)


def _attend_check(got, want, smo_step, v_absmax):
    """chip_smoke's attend_check."""
    err = (got - want).abs()
    tol = 1e-5 * float(want.abs().max())
    if smo_step is None:
        assert float(err.max()) <= tol
        return
    rows = err.amax(dim=-1)
    assert int((rows > tol).sum()) <= 1e-3 * rows.numel()
    assert float(err.max()) <= smo_step * v_absmax * (1 + 1e-5)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("site", ["none", "softmax_in", "softmax_out"])
@pytest.mark.parametrize("b,kv,g,hd,bs,s_cap,window", [
    (4, 2, 2, 16, 16, 587, 200), (3, 2, 2, 16, 8, 397, None),
    (4, 1, 4, 32, 16, 128, 64)])
def test_split_kv_merge_matches_plain(b, kv, g, hd, bs, s_cap, window,
                                      site, kv_bits):
    """Holes (an unmapped tail and an unmapped whole split), an idle lane,
    a short lane, s_cap both a multiple and not a multiple of bs."""
    rng = np.random.default_rng(s_cap + bs + kv_bits)
    nb = -(-s_cap // bs)
    n_blocks = b * nb + 3
    table = torch.from_numpy(rng.permutation(n_blocks)[:b * nb].reshape(
        b, nb).astype(np.int32))
    splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
    if splits > 2:
        table[0, bps:2 * bps] = -1              # a whole split unmapped
    table[1, nb - 1:] = -1                      # an unmapped tail
    q_pos = torch.tensor([s_cap + 37, s_cap // 3, -1, 2 * s_cap - 1][:b],
                         dtype=torch.int32)

    def f32(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    def zp(*shape):
        lim = 3 if kv_bits == 4 else 20
        return torch.round(f32(-lim, lim, *shape)) if site != "none" else \
            torch.zeros(shape)
    width = hd // 2 if kv_bits == 4 else hd
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)

    def payload():
        x = torch.from_numpy(rng.integers(lo, hi, (n_blocks, bs, kv, hd),
                                          dtype=np.int8))
        return nibble.pack_nibbles(x) if kv_bits == 4 else x
    k_a, v_a = payload(), payload()
    assert k_a.shape[-1] == width
    v_s, v_zp = f32(0.01, 0.05, n_blocks, bs, kv), zp(b, kv)
    args = (torch.from_numpy(rng.integers(-127, 128, (b, kv, g, hd),
                                          dtype=np.int8)),
            f32(0.01, 0.03, b, kv, g) / 16, zp(b, kv, g), zp(b, kv), v_zp,
            k_a, f32(0.01, 0.05, n_blocks, bs, kv), v_a, v_s, table, q_pos)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              sm_quant=None, sm_qmin=0, sm_qmax=255, smo_quant=None,
              smo_qmin=0, smo_qmax=255, kv_bits=kv_bits)
    if site != "none":
        kw["sm_quant"] = torch.tensor([0.05, 128.0])
    if site == "softmax_out":
        kw["smo_quant"] = torch.tensor([1 / 255, 0.0])
    want = pad.paged_int8_attend_decode_plain(*args, **kw)
    got = _split_attend(args, **kw)
    v_max = 8 if kv_bits == 4 else 127
    v_absmax = float((v_max + v_zp.abs().max()) * v_s.max())
    _attend_check(got, want, 1 / 255 if site == "softmax_out" else None,
                  v_absmax)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("site", ["none", "softmax_in", "softmax_out"])
@pytest.mark.parametrize("b,kv,g,hd,s_len,window", [
    (4, 2, 2, 16, 587, 200), (4, 2, 2, 16, 413, None),
    (4, 1, 4, 32, 128, 64), (4, 4, 2, 16, 4096, 2048)])
def test_dense_split_kv_merge_matches_plain(b, kv, g, hd, s_len, window,
                                            site, kv_bits):
    """K5: an empty run over a whole split (lane 0), a short lane with an
    empty prefix (lane 1), an idle lane (lane 2), a ring that wrapped
    (lane 3: slot c holds the newest position congruent to c), S both a
    multiple and not a multiple of the split length."""
    rng = np.random.default_rng(s_len + kv_bits + g)
    splits, cps = iad.plan_dense_kv_splits(b, kv, s_len)
    cells = torch.arange(s_len, dtype=torch.int32)
    q_pos = torch.tensor([s_len - 1, s_len // 3, -1, 2 * s_len - 6],
                         dtype=torch.int32)
    k_pos = cells.repeat(b, 1)
    if splits > 2:
        k_pos[0, cps:2 * cps] = -1              # a whole split empty
    k_pos[1, :5] = -1                           # an empty prefix
    k_pos[3] = q_pos[3] - (q_pos[3] - cells) % s_len

    def f32(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    def zp(*shape):
        lim = 3 if kv_bits == 4 else 20
        return torch.round(f32(-lim, lim, *shape)) if site != "none" else \
            torch.zeros(shape)
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)

    def payload():
        x = torch.from_numpy(rng.integers(lo, hi, (b, s_len, kv, hd),
                                          dtype=np.int8))
        return nibble.pack_nibbles(x) if kv_bits == 4 else x
    v_s, v_zp = f32(0.01, 0.05, b, s_len, kv), zp(b, kv)
    args = (torch.from_numpy(rng.integers(-127, 128, (b, kv, g, hd),
                                          dtype=np.int8)),
            f32(0.01, 0.03, b, kv, g) / 16, zp(b, kv, g), zp(b, kv), v_zp,
            payload(), f32(0.01, 0.05, b, s_len, kv), payload(), v_s, k_pos,
            q_pos)
    kw = dict(window=window, logit_softcap=50.0, sm_quant=None, sm_qmin=0,
              sm_qmax=255, smo_quant=None, smo_qmin=0, smo_qmax=255,
              kv_bits=kv_bits)
    if site != "none":
        kw["sm_quant"] = torch.tensor([0.05, 128.0])
    if site == "softmax_out":
        kw["smo_quant"] = torch.tensor([1 / 255, 0.0])
    want = iad.int8_attend_decode_plain(*args, **kw)
    got = _dense_split_attend(args, **kw)
    v_max = 8 if kv_bits == 4 else 127
    v_absmax = float((v_max + v_zp.abs().max()) * v_s.max())
    _attend_check(got, want, 1 / 255 if site == "softmax_out" else None,
                  v_absmax)


def _float_split_attend(args, *, s_cap, window, logit_softcap, sm_quant,
                        sm_qmin, sm_qmax, smo_quant, smo_qmin, smo_qmax):
    """K7's split-KV arithmetic in PyTorch: f32 logits of the queries (the
    attention scale folded in) against the stored f32 or bf16 keys, then
    the merge of K6 with v_s = 1 and z_v = 0."""
    q, k_arena, v_arena, table, q_pos = args
    b, kv, _, _ = q.shape
    nb, bs = table.shape[1], k_arena.shape[1]
    k = paged_gather_ref(k_arena, table).float()
    v = paged_gather_ref(v_arena, table).float()
    kp = paged_positions_ref(table, q_pos, s_cap=s_cap, block_size=bs)
    s = _sites_and_mask(torch.einsum("bkgd,bskd->bkgs", q, k),
                        decode_valid(kp, q_pos, window),
                        logit_softcap=logit_softcap, sm_quant=sm_quant,
                        sm_qmin=sm_qmin, sm_qmax=sm_qmax)
    splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
    cells = [slice(a * bs, e * bs)
             for a, e in pad.kv_split_blocks(nb, splits, bps)]
    return _merge_splits(s, v, torch.ones(v.shape[:3]), torch.zeros(b, kv),
                         cells, smo_quant=smo_quant, smo_qmin=smo_qmin,
                         smo_qmax=smo_qmax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", ["none", "softmax_in", "softmax_out"])
@pytest.mark.parametrize("b,kv,g,hd,bs,s_cap,window", [
    (4, 2, 2, 16, 8, 16, 16), (4, 2, 2, 16, 8, 64, None),
    (4, 2, 2, 32, 16, 128, 64), (4, 2, 2, 16, 16, 587, 200),
    (4, 1, 4, 16, 8, 405, None)])
def test_float_split_kv_merge_matches_plain_and_reference(
        b, kv, g, hd, bs, s_cap, window, site, dtype):
    """K7: block sizes 8 and 16; a 16-cell ring that wrapped (lanes 0 and
    3 are past s_cap); blocks not a multiple of the split (587 and 405
    cells: 19 and 26 splits of 2 blocks, the last of 1); a whole split
    unmapped (lane 0), an unmapped tail (lane 1) and an idle lane (lane
    2); f32 and bf16 arenas (bf16 values, held as f32 by numpy)."""
    rng = np.random.default_rng(s_cap + bs + g)
    nb = -(-s_cap // bs)
    n_blocks = b * nb + 3
    table = torch.from_numpy(rng.permutation(n_blocks)[:b * nb].reshape(
        b, nb).astype(np.int32))
    splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
    assert nb % bps != 0 or s_cap <= 128
    if splits > 2:
        table[0, bps:2 * bps] = -1              # a whole split unmapped
    table[1, nb - 1:] = -1                      # an unmapped tail
    q_pos = torch.tensor([s_cap + 37, s_cap // 3, -1, 2 * s_cap - 1],
                         dtype=torch.int32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    q = (rng.standard_normal((b, kv, g, hd)) * 0.3).astype(np.float32)
    k, v = (torch.from_numpy(rng.standard_normal(
        (n_blocks, bs, kv, hd)).astype(np.float32)).to(tdt).float().numpy()
        for _ in range(2))
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              sm_quant=None, sm_qmin=0, sm_qmax=255, smo_quant=None,
              smo_qmin=0, smo_qmax=255)
    if site != "none":
        kw["sm_quant"] = torch.tensor([0.05, 128.0])
    if site == "softmax_out":
        kw["smo_quant"] = torch.tensor([1 / 255, 0.0])
    args = (torch.from_numpy(q), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), table, q_pos)
    got = _float_split_attend(args, **kw)
    jkw = {key: jnp.asarray(val.numpy()) if isinstance(val, torch.Tensor)
           else val for key, val in kw.items()}
    jargs = (jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             jnp.asarray(table.numpy()), jnp.asarray(q_pos.numpy()))
    step = 1 / 255 if site == "softmax_out" else None
    for want in (pad.paged_attend_decode_plain(*args, **kw),
                 torch.from_numpy(np.array(
                     jref.paged_attend_decode_ref(*jargs, **jkw))),
                 torch.from_numpy(np.array(
                     jops.paged_attend_decode(*jargs, **jkw)))):
        _attend_check(got, want, step, float(np.abs(v).max()))
