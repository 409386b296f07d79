"""Multi-head attention with KV caches (port of the parts of
``repro.models.attention`` the serving path uses): GQA, sliding window,
logit soft-capping, RoPE, the dense, the chunked (online-softmax) and
the banded (sliding-window) attend; dense, int8, nibble-packed int4,
block-paged and paged int8 / int4 caches; decode through the attention
kernels (K5-K7) and chunked (append) prefill.

Absolute positions drive masking and cache writes; position -1 marks a DEAD
cell (a prompt pad or an idle lane): it is masked out of attention and its
cache write is dropped, so packing and idle lanes never perturb other lanes.

Cache writes are in place, as the reference's donated buffers make them:
each field takes one ``index_copy_`` of the written rows, and the writer
returns the cache it was given (a layer's view of a stacked cache writes
the stacked tensor). Dropped writes (dead cells, unmapped blocks) need no
data-dependent shape and no host sync: each repeats a live write of the
same call, cell and value (see :func:`_scatter_plan`).

Tensor-parallel (``dist``): with the caches on their KV heads a rank
attends for its heads over its KV heads; with the caches on the sequence
dim (the default, ``kv_seq_shard``) every rank holds the cells
[r*S/N, (r+1)*S/N) of a dense cache (in-block cells [r*bs/N, (r+1)*bs/N)
of a paged arena) for all heads, writes only the cells it holds, and a
decode step runs the kernel of the cache's type in partial mode over its
cells; the ranks gather the partials and merge them in (rank, split)
order (``kernels.ops.merge_partials``), so every rank holds the same
output.

Quantization sites (paper Fig. 1 naming), threaded via QuantCtx:
  {prefix}/q, {prefix}/k, {prefix}/v, {prefix}/softmax_in,
  {prefix}/softmax_out, {prefix}/ctx_out; matmul inputs {prefix}/wo_in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.nibble import pack_nibbles, unpack_nibbles
from repro_torch.kernels.ref import paged_gather_ref, paged_positions_ref
from repro_torch.models.common import (apply_rope, dense_init, dot,
                                       dot_row_parallel, matmul_dtype,
                                       resolve_weight, softcap)
from repro_torch.parallel import collectives as coll

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None          # sliding-window size (None = global)
    logit_softcap: Optional[float] = None
    rope_theta: Optional[float] = 10000.0
    query_scale: Optional[float] = None   # default 1/sqrt(head_dim)

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else 1.0 / math.sqrt(self.head_dim))


class KVCache(NamedTuple):
    """k/v: (B, S, KV, hd); pos: (B, S) absolute positions (-1 = empty).
    S = max_len for global attention, min(max_len, window) for sliding."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class QuantKVCache(NamedTuple):
    """Int8 KV cache: k_q/v_q (B, S, KV, hd) int8 payloads with per-head,
    per-slot scales k_s/v_s (B, S, KV) f32 (zero-points are static per
    head, see :func:`quantize_kv`); pos as in :class:`KVCache`."""
    k_q: torch.Tensor
    v_q: torch.Tensor
    k_s: torch.Tensor
    v_s: torch.Tensor
    pos: torch.Tensor


class Quant4KVCache(QuantKVCache):
    """Packed int4 KV cache: the fields and scale layout of
    :class:`QuantKVCache`, but k_q/v_q hold two int4 cells per byte —
    (B, S, KV, hd/2) split-half nibbles (``kernels.nibble``). The TYPE is the
    bit-width marker: every isinstance check on the int8 base class still
    applies, and the write, read and decode paths pick the int4 quantizer
    and the ``kv_bits=4`` kernels by this subclass."""
    __slots__ = ()


class PagedKVCache(NamedTuple):
    """Block-paged f32/bf16 KV cache: k/v (N, bs, KV, hd), one arena of N
    blocks of bs cells with no batch axis; the (B, nb) block table that maps
    lanes onto blocks travels at the top of the whole-model cache dict.
    ``pos`` (N, bs) keeps the dead-cell sentinel; the read paths derive
    validity from (logical cell, q_pos) instead (:func:`paged_key_positions`),
    so a reused block's stale cells are unreadable."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class PagedQuantKVCache(NamedTuple):
    """Paged int8 KV cache: the :class:`QuantKVCache` fields over the arena
    of :class:`PagedKVCache` — k_q/v_q (N, bs, KV, hd) int8, k_s/v_s
    (N, bs, KV) f32, pos (N, bs)."""
    k_q: torch.Tensor
    v_q: torch.Tensor
    k_s: torch.Tensor
    v_s: torch.Tensor
    pos: torch.Tensor


class PagedQuant4KVCache(PagedQuantKVCache):
    """Paged packed int4 KV cache: :class:`Quant4KVCache` payloads over the
    block arena — k_q/v_q (N, bs, KV, hd/2) nibbles, k_s/v_s (N, bs, KV)
    f32, pos (N, bs): half the payload bytes of an int8 block."""
    __slots__ = ()


_INT4_CACHES = (Quant4KVCache, PagedQuant4KVCache)


# Arenas are zeroed, as in the reference: an idle lane's rows read block 0,
# and an uninitialised arena could hold NaN.

def _cache_size(max_len: int, cfg: AttnConfig) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    dev = resolve_device(device)
    size = _cache_size(max_len, cfg)
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   pos=torch.full((batch, size), -1, dtype=torch.int32,
                                  device=dev))


def _quant_fields(cells, cfg: AttnConfig, dev, bits: int = 8):
    """(k_q, v_q, k_s, v_s, pos) zeroed over ``cells`` (a shape prefix);
    4-bit payloads are hd/2 bytes wide."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if bits == 4:
        if hd % 2:
            raise ValueError(f"int4 KV cache needs an even head_dim, got "
                             f"{hd}")
        hd //= 2
    return (torch.zeros((*cells, kv, hd), dtype=torch.int8, device=dev),
            torch.zeros((*cells, kv, hd), dtype=torch.int8, device=dev),
            torch.zeros((*cells, kv), dtype=torch.float32, device=dev),
            torch.zeros((*cells, kv), dtype=torch.float32, device=dev),
            torch.full(cells, -1, dtype=torch.int32, device=dev))


def init_quant_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                        device=None) -> QuantKVCache:
    return QuantKVCache(*_quant_fields((batch, _cache_size(max_len, cfg)),
                                       cfg, resolve_device(device)))


def init_paged_kv_cache(num_blocks: int, block_size: int, cfg: AttnConfig,
                        dtype=torch.bfloat16, device=None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev),
                        pos=torch.full((num_blocks, block_size), -1,
                                       dtype=torch.int32, device=dev))


def init_paged_quant_kv_cache(num_blocks: int, block_size: int,
                              cfg: AttnConfig,
                              device=None) -> PagedQuantKVCache:
    return PagedQuantKVCache(*_quant_fields((num_blocks, block_size), cfg,
                                            resolve_device(device)))


def init_quant4_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                         device=None) -> Quant4KVCache:
    return Quant4KVCache(*_quant_fields((batch, _cache_size(max_len, cfg)),
                                        cfg, resolve_device(device), 4))


def init_paged_quant4_kv_cache(num_blocks: int, block_size: int,
                               cfg: AttnConfig,
                               device=None) -> PagedQuant4KVCache:
    return PagedQuant4KVCache(*_quant_fields((num_blocks, block_size), cfg,
                                             resolve_device(device), 4))


def paged_capacity(block_table, block_size: int,
                   window: Optional[int]) -> int:
    """A layer's logical capacity over a paged cache: the table's
    nb * bs cells, wrapped at the window for ring (sliding-window) layers."""
    cap = block_table.shape[-1] * block_size
    return min(cap, window) if window else cap


def _grid_step(amax, qmax: int):
    """The dynamic grid step amax / qmax as the reference computes it in
    its jitted steps: XLA turns a division by a constant into a product
    with the constant's f32 reciprocal, which differs from the quotient in
    the last bit for about half the inputs, and a value at exactly
    amax / 2 then rounds to the other side of its tie."""
    return amax * float(np.float32(1.0) / np.float32(qmax))


def quantize_kv(x, grid_scale=None, zero_point=None):
    """Per-head int8 quantization over the last axis (..., KV, hd).

    Without a calibration each (token, head) vector gets its own symmetric
    scale amax/127. With a calibrated site grid (``grid_scale`` and
    ``zero_point`` (KV,) from ``deploy.kv_quant_for``) the write re-uses the
    site's affine grid shifted onto int8, so values the simulate path
    already fake-quantized store exactly; the zero-point is static per head
    and corrected inside the decode kernels. Returns (q int8, scale f32 of
    shape x.shape[:-1])."""
    xf = x.float()
    if zero_point is not None:
        s = torch.as_tensor(grid_scale, dtype=torch.float32,
                            device=x.device).expand(xf.shape[:-1])
        z = torch.as_tensor(zero_point, dtype=torch.float32, device=x.device)
        q = torch.clamp(torch.round(xf / s[..., None]) + z[..., None],
                        -128, 127).to(torch.int8)
        return q, s
    s = _grid_step(xf.abs().amax(dim=-1), 127)
    if grid_scale is not None:
        s = torch.maximum(s, torch.as_tensor(grid_scale, dtype=torch.float32,
                                             device=x.device))
    s = torch.clamp_min(s, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(xf / s[..., None]), -127,
                    127).to(torch.int8)
    return q, s


def quantize_kv4(x, grid_scale=None, zero_point=None):
    """Per-head int4 quantization + split-half nibble pack, the 4-bit twin
    of :func:`quantize_kv`: calibrated grids (zero-point already shifted
    onto the int4 grid) clip to [-8, 7]; dynamic symmetric grids use
    amax/7 on [-7, 7]. Returns (packed int8 (..., hd/2), scale f32 of shape
    x.shape[:-1])."""
    xf = x.float()
    if zero_point is not None:
        s = torch.as_tensor(grid_scale, dtype=torch.float32,
                            device=x.device).expand(xf.shape[:-1])
        z = torch.as_tensor(zero_point, dtype=torch.float32, device=x.device)
        q = torch.clamp(torch.round(xf / s[..., None]) + z[..., None],
                        -8, 7).to(torch.int8)
        return pack_nibbles(q), s
    s = _grid_step(xf.abs().amax(dim=-1), 7)
    if grid_scale is not None:
        s = torch.maximum(s, torch.as_tensor(grid_scale, dtype=torch.float32,
                                             device=x.device))
    s = torch.clamp_min(s, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(xf / s[..., None]), -7, 7).to(torch.int8)
    return pack_nibbles(q), s


def _payload_values(cache, kq, vq):
    """The int K/V values of (gathered) payloads: int4 caches unpack their
    nibbles (hd = twice the stored width)."""
    if isinstance(cache, _INT4_CACHES):
        hd = 2 * kq.shape[-1]
        return unpack_nibbles(kq, hd), unpack_nibbles(vq, hd)
    return kq, vq


def dequantize_kv(cache, kvq=None):
    """(k, v) f32 views of a quantized cache; ``kvq`` (deploy.KVQuant)
    carries the static zero-points it was written with (None: symmetric)."""
    kq, vq = _payload_values(cache, cache.k_q, cache.v_q)
    kq, vq = kq.float(), vq.float()
    if kvq is not None:
        kq = kq - kvq.k_zp.float()[..., None]
        vq = vq - kvq.v_zp.float()[..., None]
    return kq * cache.k_s[..., None], vq * cache.v_s[..., None]


def _mask(q_pos, k_pos, cfg: AttnConfig):
    """Boolean validity mask (..., T, S) from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    valid = kp >= 0
    if cfg.causal:
        valid = valid & (kp <= qp)
    if cfg.window is not None:
        valid = valid & (kp > qp - cfg.window)
    return valid


def _dense_attend(q, k, v, q_pos, k_pos, cfg: AttnConfig, ctx=None,
                  prefix="", part=False):
    """q: (B,T,H,hd), k/v: (B,S,KV,hd). Returns (B,T,H,hd). ``part``: the
    heads are this rank's part of the layer's (the softmax sites' tensors
    are cut over ``model``)."""
    B, T, H, hd = q.shape
    KV, G = cfg.num_kv_heads, cfg.q_groups
    qg = q.reshape(B, T, KV, G, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                          k.float()) * cfg.scale
    logits = softcap(logits, cfg.logit_softcap)
    if ctx is not None:
        logits = ctx.act(f"{prefix}/softmax_in", logits)
    valid = _mask(q_pos, k_pos, cfg)[:, None, None]       # (B,1,1,T,S)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if ctx is not None:
        probs = ctx.act(f"{prefix}/softmax_out", probs)
        if part:
            ctx.mark_cut(f"{prefix}/softmax_in", f"{prefix}/softmax_out")
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def _chunked_attend(q, k, v, q_pos, k_pos, cfg: AttnConfig,
                    kv_chunk: int = 1024):
    """Online-softmax loop over KV chunks; never materializes the full
    (T, S) score matrix. Numerically matches _dense_attend (no sites)."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    KV, G = cfg.num_kv_heads, cfg.q_groups
    qg = q.reshape(B, T, KV, G, hd).float() * cfg.scale
    m = torch.full((B, KV, G, T), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G, T), device=q.device)
    acc = torch.zeros((B, KV, G, T, hd), device=q.device)
    for lo in range(0, S, kv_chunk):
        kc, vc = k[:, lo:lo + kv_chunk].float(), v[:, lo:lo + kv_chunk].float()
        s = torch.einsum("btkgd,bckd->bkgtc", qg, kc)
        s = softcap(s, cfg.logit_softcap)
        valid = _mask(q_pos, k_pos[:, lo:lo + kv_chunk], cfg)[:, None, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.clamp_min(torch.maximum(m, s.amax(dim=-1)), NEG_INF)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgtc,bckd->bkgtd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


def _banded_attend(q, k, v, q_pos, k_pos, cfg: AttnConfig,
                   block: int = 1024):
    """Sliding-window attention that computes only the band: queries in
    blocks of ``block``, each against the ``ceil(W / block) + 1`` kv blocks
    its window can reach, O(T * W) instead of O(T^2). Needs the
    self-attention layout (q_pos == k_pos, T == S) and ``cfg.window``."""
    B, T, H, hd = q.shape
    W = cfg.window
    assert W is not None
    nq = -(-T // block)
    pad = nq * block - T
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=-10**9)
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    nband = -(-W // block) + 1            # kv blocks a q block can reach
    KV = cfg.num_kv_heads
    kb = k.reshape(B, nq, block, KV, hd)
    vb = v.reshape(B, nq, block, KV, hd)
    kp = k_pos.reshape(B, nq, block)
    # q block i reads kv blocks i - nband + 1 .. i; those before the first
    # are clamped to it and masked out
    idx = (torch.arange(nq, device=q.device)[:, None] - (nband - 1)
           + torch.arange(nband, device=q.device)[None, :])
    idx_c = idx.clamp(0, nq - 1)
    k_band = kb[:, idx_c].reshape(B * nq, nband * block, KV, hd)
    v_band = vb[:, idx_c].reshape(B * nq, nband * block, KV, hd)
    kp_band = torch.where((idx >= 0)[None, :, :, None], kp[:, idx_c],
                          torch.full_like(kp[:, idx_c], -1))
    # (B, nq) folded into the batch: the dense attend per band
    out = _dense_attend(q.reshape(B * nq, block, H, hd), k_band, v_band,
                        q_pos.reshape(B * nq, block),
                        kp_band.reshape(B * nq, nband * block), cfg)
    return out.reshape(B, nq * block, H, hd)[:, :T]


def attend(q, k, v, q_pos, k_pos, cfg: AttnConfig, *, ctx=None, prefix="",
           chunked: Optional[bool] = None, kv_chunk: int = 1024,
           banded: bool = False, part: bool = False):
    """Dense (supports the quantization sites), chunked (long contexts) or
    banded (``banded`` or ``chunked="banded"``: only the sliding-window
    band, when ``cfg.window`` is set, T == S and T > window; otherwise
    "banded" falls back to the automatic choice). ``part``: see
    :func:`_dense_attend`."""
    T, S = q.shape[1], k.shape[1]
    if (banded or chunked == "banded") and cfg.window is not None \
            and T == S and T > cfg.window:
        return _banded_attend(q, k, v, q_pos, k_pos, cfg)
    if chunked is None or chunked == "banded":
        chunked = T * S > 4096 * 4096
    if chunked:
        return _chunked_attend(q, k, v, q_pos, k_pos, cfg, kv_chunk)
    return _dense_attend(q, k, v, q_pos, k_pos, cfg, ctx, prefix, part)


def _write_slots(pw, S, window):
    """Cache slot per new token from its absolute position; dead cells
    (position < 0) get slot S, out of bounds, so their write is dropped."""
    base = torch.remainder(pw, S) if window else pw
    return torch.where(pw >= 0, base, torch.full_like(pw, S))


def _quantize_kv_writes(cache, k_new, v_new, kvq):
    """(kq, ks, vq, vs) on the cache's own grid: packed int4 for the int4
    subclasses, int8 otherwise (``kvq``: calibrated)."""
    qfn = quantize_kv4 if isinstance(cache, _INT4_CACHES) else quantize_kv
    if kvq is None:
        kq, ks = qfn(k_new)
        vq, vs = qfn(v_new)
    else:
        kq, ks = qfn(k_new, kvq.k_grid, kvq.k_zp)
        vq, vs = qfn(v_new, kvq.v_grid, kvq.v_zp)
    return kq, ks, vq, vs


def _scatter_plan(flat, live):
    """(target rows, source entries, any live) for an in-place scatter of
    n entries that drops the entries where ``live`` is False, with no shape
    that depends on data: a dropped entry repeats the first live one (the
    same row and value, so the duplicates agree whichever lands last);
    when none is live every entry targets row 0, rewritten with its own
    value by :func:`_scatter_rows`."""
    flat, live = flat.reshape(-1), live.reshape(-1)
    # (1,) index tensors throughout: indexing with a 0-d tensor would read
    # it back to the host
    donor = torch.argmax(live.to(torch.int32)).reshape(1)   # first live
    has = live.index_select(0, donor)
    rows = torch.where(live, flat,
                       torch.where(has, flat.index_select(0, donor), 0))
    src = torch.where(live, torch.arange(flat.shape[0], device=flat.device),
                      donor)
    return rows.long(), src, has


def _scatter_rows(field, plan, new):
    """Write ``new`` (one row per entry of ``plan``) into ``field`` in
    place, ``field`` viewed as rows over its first two axes (a lane's or
    a block's cells)."""
    rows_at, src, has = plan
    rows = field.view(field.shape[0] * field.shape[1], *field.shape[2:])
    vals = new.reshape(src.shape[0], *rows.shape[1:]).to(rows.dtype)
    vals = torch.where(has.reshape((1,) * vals.dim()),
                       vals.index_select(0, src), rows[:1])
    rows.index_copy_(0, rows_at, vals)


def _write_fields(cache, plan, k_new, v_new, pw, kvq):
    """Scatter the new tokens into every field of ``cache`` (quantized
    first on the cache's own grid for int8 / int4 caches); returns
    ``cache``."""
    if isinstance(cache, (QuantKVCache, PagedQuantKVCache)):
        kq, ks, vq, vs = _quantize_kv_writes(cache, k_new, v_new, kvq)
        news = (kq, vq, ks, vs, pw)
    else:
        news = (k_new, v_new, pw)
    for field, new in zip(cache, news):
        _scatter_rows(field, plan, new)
    return cache


def _plan_for(plans, key, make):
    """The scatter plan under ``key`` in ``plans`` (one forward's layers
    share the plans of their capacity), made on first use."""
    if plans is None:
        return make()
    if key not in plans:
        plans[key] = make()
    return plans[key]


def _write_kv(cache, k_new, v_new, pw, window, kvq=None, plans=None,
              shard=(0, 1)):
    """Write the (B, T) new tokens into the dense cache in place, each at
    its slot (:func:`_write_slots`); dead cells write nothing. Live slots
    of one lane are distinct (positions are), so each cell has at most
    one source. ``plans``: a forward's shared scatter plans. ``shard``
    (r, N): the cache holds the cells [r*S, (r+1)*S) of N*S (its sequence
    dim cut over N ranks), and writes to the other ranks' cells are
    dropped. Returns ``cache``."""
    B, S = cache.pos.shape
    r, n = shard

    def make():
        mine = _write_slots(pw, S * n, window) - r * S
        lane = torch.arange(B, device=mine.device)[:, None]
        return _scatter_plan(lane * S + mine,
                             (pw >= 0) & (mine >= 0) & (mine < S))
    plan = _plan_for(plans, ("dense", S, n, window, pw.shape[1]), make)
    return _write_fields(cache, plan, k_new, v_new, pw, kvq)


def _write_paged_kv(cache, k_new, v_new, pw, block_table, window, kvq=None,
                    plans=None, shard=(0, 1)):
    """Write the (B, T) tokens into the arena through the lanes' block
    table, in place: logical cell ``pw % s_cap``, physical block from the
    table. Dead cells (pw < 0) and unmapped blocks are dropped. ``plans``:
    a forward's shared scatter plans (one per capacity). ``shard`` (r, N):
    the arena holds the in-block cells [r*bs, (r+1)*bs) of blocks of N*bs,
    and writes to the other ranks' cells are dropped. Returns ``cache``."""
    bs = cache.pos.shape[1]
    r, n = shard
    s_cap = paged_capacity(block_table, bs * n, window)

    def make():
        L = torch.remainder(torch.clamp_min(pw, 0), s_cap)
        phys = torch.gather(block_table, 1, (L // (bs * n)).long())
        o = L % (bs * n) - r * bs
        return _scatter_plan(phys * bs + o,
                             (pw >= 0) & (phys >= 0) & (o >= 0) & (o < bs))
    plan = _plan_for(plans, ("paged", s_cap, bs, n, pw.shape[1]), make)
    return _write_fields(cache, plan, k_new, v_new, pw, kvq)


def _whole_cells(cache, dist):
    """The whole cache from the ranks' sequence slices (every field's dim 1:
    a dense lane's cells or a paged block's), gathered in rank order: the
    read-back of the paths the decode kernels do not take (prefill chunks,
    float dense caches, sites that are not per-tensor)."""
    return type(cache)(*(coll.all_gather(f, dist, dim=1) for f in cache))


def paged_key_positions(block_table, q_pos, s_cap: int, block_size: int):
    """Derived key positions (B, nb*bs) of each lane's block view (nb =
    ceil(s_cap / bs)): cell L holds ``q_pos - ((q_pos - L) mod s_cap)``;
    unwritten, stale and unmapped cells and idle lanes derive -1."""
    return paged_positions_ref(kops._lane_blocks(block_table, s_cap,
                                                 block_size),
                               q_pos, s_cap=s_cap, block_size=block_size)


def paged_gather_kv(cache, block_table, window, kvq=None):
    """Dense (B, nb*bs, KV, hd) f32 view of each lane's blocks (the read
    path of chunked prefill and of sites the kernels cannot express); int8
    arenas dequantize on gather. Pair with :func:`paged_key_positions`."""
    bs = cache.pos.shape[1]
    cols = kops._lane_blocks(block_table,
                             paged_capacity(block_table, bs, window), bs)
    if isinstance(cache, PagedQuantKVCache):
        kq, vq = _payload_values(cache, paged_gather_ref(cache.k_q, cols),
                                 paged_gather_ref(cache.v_q, cols))
        kq, vq = kq.float(), vq.float()
        if kvq is not None:
            kq = kq - kvq.k_zp.float()[..., None]
            vq = vq - kvq.v_zp.float()[..., None]
        return (kq * paged_gather_ref(cache.k_s, cols)[..., None],
                vq * paged_gather_ref(cache.v_s, cols)[..., None])
    return (paged_gather_ref(cache.k, cols).float(),
            paged_gather_ref(cache.v, cols).float())


def reset_paged_lanes(cache, lane_mask, block_table):
    """Empty every block the masked lanes map, in place (``pos`` -> -1;
    payloads stay, masked by position). Takes (N, bs) and stacked
    (n, N, bs) arenas; the block table itself is host-owned and not
    touched. Returns ``cache``."""
    num_blocks = cache.pos.shape[-2]
    ids = torch.where(lane_mask.bool()[:, None] & (block_table >= 0),
                      block_table, num_blocks).reshape(-1).long()
    hit = torch.zeros(num_blocks + 1, dtype=torch.bool,
                      device=cache.pos.device)
    hit[ids] = True
    cache.pos.masked_fill_(hit[:num_blocks, None], -1)
    return cache


def reset_kv_lanes(cache, lane_mask, batch_axis: int = 0):
    """Empty the masked batch lanes of a dense (int8) cache for slot reuse,
    in place: ``pos`` -> -1 on those lanes; payloads and scales stay,
    masked by position. ``batch_axis`` is 1 for stacked leaves. Returns
    ``cache``."""
    shape = [1] * cache.pos.dim()
    shape[batch_axis] = lane_mask.shape[0]
    cache.pos.masked_fill_(lane_mask.bool().reshape(shape), -1)
    return cache


# ---------------------------------------------------------------------------
# Decode through the attention kernels
# ---------------------------------------------------------------------------

def _sites_active(ctx) -> bool:
    if ctx is None or not ctx.act_state:
        return False
    from repro_torch.core.calibration import Mode
    return ctx.mode in (Mode.APPLY, Mode.DEPLOY)


def _site_quant(ctx, site):
    """((scale, zp) (2,), qmin, qmax) of an in-kernel fake-quant site;
    (None, 0, 0) when inactive; False when calibrated but not per-tensor
    (the caller then falls back to dequantize-then-attend)."""
    qp = ctx.act_state.get(site)
    acfg = ctx.policy.act_config(site)
    if qp is None or not acfg.enabled:
        return None, 0, 0
    if qp.scale.numel() != 1 or qp.group_index is not None:
        return False
    sm = torch.stack([qp.scale.float().reshape(()),
                      qp.zero_point.float().reshape(())])
    return sm, acfg.qmin, acfg.qmax


def _q_site_quant(ctx, prefix):
    """(scale, shifted zero-point, qmin, qmax, shift) of the calibrated
    per-tensor 8-bit ``{prefix}/q`` site, or None: queries that site
    already fake-quantized enter the kernel exactly."""
    qp = ctx.act_state.get(f"{prefix}/q")
    acfg = ctx.policy.act_config(f"{prefix}/q")
    if qp is None or not acfg.enabled or acfg.bits != 8 \
            or qp.scale.numel() != 1:
        return None
    shift = 128 if acfg.qmin == 0 else 0
    return (qp.scale.float().reshape(()), qp.zero_point.float().reshape(()),
            acfg.qmin, acfg.qmax, shift)


def _decode_site_params(ctx, prefix):
    """(site kwargs of the decode kernels, q site), or None when a
    calibrated softmax site is not per-tensor (the caller falls back)."""
    sm_quant = smo_quant = None
    sm_qmin = sm_qmax = smo_qmin = smo_qmax = 0
    q_site = None
    if _sites_active(ctx):
        sm = _site_quant(ctx, f"{prefix}/softmax_in")
        smo = _site_quant(ctx, f"{prefix}/softmax_out")
        if sm is False or smo is False:
            return None
        sm_quant, sm_qmin, sm_qmax = sm
        smo_quant, smo_qmin, smo_qmax = smo
        q_site = _q_site_quant(ctx, prefix)
    return (dict(sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
                 smo_quant=smo_quant, smo_qmin=smo_qmin,
                 smo_qmax=smo_qmax), q_site)


def _quantize_decode_q(qg, q_site):
    """(q_q int8, scales (B, KV, G), zero-points or None): on the
    calibrated ``{prefix}/q`` grid shifted onto int8 when there is one,
    else dynamic symmetric per head."""
    B, KV, G, _ = qg.shape
    if q_site is not None:
        s_q, z_q, qmin, qmax, shift = q_site
        q_q = (torch.clamp(torch.round(qg / s_q) + z_q, qmin, qmax)
               - shift).to(torch.int8)
        return (q_q, s_q.reshape(1, 1, 1).expand(B, KV, G),
                (z_q - shift).reshape(1, 1, 1).expand(B, KV, G))
    qs = torch.clamp_min(_grid_step(qg.abs().amax(dim=-1), 127),
                         torch.finfo(torch.float32).tiny)
    q_q = torch.clamp(torch.round(qg / qs[..., None]), -127,
                      127).to(torch.int8)
    return q_q, qs, None


def _kv_zero_points(kvq, B, KV):
    if kvq is None:
        return None, None
    return (kvq.k_zp.float().expand(B, KV), kvq.v_zp.float().expand(B, KV))


def _merged_partials(fn, args, kw, out_kw, dist):
    """The decode output from ``fn`` in partial mode over this rank's cells,
    gathered over ``model`` along the split dim and merged in (rank,
    split) order: one pass, or with a softmax_out site the statistics
    launch, their merge into the global (m, l), the second launch on it
    and the sum of its accumulators. ``out_kw``: the int8 emit's grid."""
    if kw["smo_quant"] is None:
        part = coll.all_gather(fn(*args, mode="one_pass", **kw), dist, dim=2)
        return kops.merge_partials(part, mode="one_pass", **out_kw)
    ml = coll.all_gather(fn(*args, mode="stats", **kw), dist, dim=2)
    stats = kops.merge_partials(ml, mode="stats")
    part = coll.all_gather(fn(*args, mode="emit", stats=stats, **kw), dist,
                           dim=2)
    return kops.merge_partials(part, mode="sum", **out_kw)


def _kernel_decode_attend(q, cache, block_table, q_pos, cfg: AttnConfig,
                          ctx, prefix, kvq=None, wo_aq=None, seq_dist=None):
    """Decode step through the attention kernel of the cache's type: K5
    (int8), K6 (paged int8) or K7 (paged f32/bf16). Int8 kernels take the
    queries on the ``{prefix}/q`` grid (or dynamic per head) with the
    attention scale folded into their scales; K7 takes it folded into q.
    Returns (B, 1, H, hd) in q.dtype, or None when a site is not
    per-tensor (the caller then reads the cache back and attends). Given
    ``wo_aq``, the deploy quantizer of the output projection's input, a
    kernel whose queries are f32 and whose grid is per-tensor with no
    permutation emits that input itself from its merge (the ``wo_in``
    quantize folded in): the result is then the (B, 1, H*hd) int8
    ``QTensor``, the bytes ``quantize_act`` would make of the f32
    output. ``seq_dist``: the cache holds this rank's cells of a cache cut
    on its sequence dim; the kernel runs in partial mode and the merge
    (which then emits) combines every rank's partials."""
    if not cfg.causal:
        return None
    site = _decode_site_params(ctx, prefix)
    if site is None:
        return None
    sm_kwargs, q_site = site
    B, _, H, hd = q.shape
    KV, G = cfg.num_kv_heads, cfg.q_groups
    qg = q.reshape(B, KV, G, hd).float()
    kw = dict(window=cfg.window, logit_softcap=cfg.logit_softcap,
              **sm_kwargs)
    paged = isinstance(cache, (PagedKVCache, PagedQuantKVCache))
    n, r = coll.tp_size(seq_dist), coll.tp_index(seq_dist)
    if paged:
        bs = cache.pos.shape[1]
        kw["s_cap"] = paged_capacity(block_table, bs * n, cfg.window)
        if seq_dist is not None:
            kw.update(block_size=bs * n, cell_lo=r * bs)
    emit = (wo_aq is not None and wo_aq.per_tensor
            and q.dtype == torch.float32)
    out_kw = (dict(out_scale=wo_aq.scales[0], out_zp=wo_aq.zps[0],
                   qmin=wo_aq.qmin, qmax=wo_aq.qmax) if emit else {})
    if isinstance(cache, PagedKVCache):
        fns = (kops.paged_attend_decode, kops.paged_attend_decode_partials)
        args = (qg * cfg.scale, cache.k, cache.v, block_table, q_pos[:, 0])
    else:
        q_q, qs, qz = _quantize_decode_q(qg, q_site)
        kz, vz = _kv_zero_points(kvq, B, KV)
        args = (q_q, qs * cfg.scale, cache.k_q, cache.k_s, cache.v_q,
                cache.v_s)
        kw.update(q_zp=qz, k_zp=kz, v_zp=vz,
                  kv_bits=4 if isinstance(cache, _INT4_CACHES) else 8)
        if paged:
            fns = (kops.paged_int8_attend_decode,
                   kops.paged_int8_attend_decode_partials)
            args = (*args, block_table, q_pos[:, 0])
        else:
            fns = (kops.int8_attend_decode, kops.int8_attend_decode_partials)
            args = (*args, cache.pos, q_pos[:, 0])
    if seq_dist is None:
        out = fns[0](*args, **kw, **out_kw)
    else:
        out = _merged_partials(fns[1], args, kw, out_kw, seq_dist)
    if emit:
        from repro_torch.core.deploy import QTensor
        return QTensor(q=out.reshape(B, 1, H * hd), scales=wo_aq.scales,
                       zps=wo_aq.zps)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _prev_positions(positions):
    """Per-lane position of the last token before this chunk: one less than
    the lane's first live position, -1 for lanes with no live row."""
    live = positions >= 0
    big = torch.where(live, positions,
                      torch.full_like(positions, torch.iinfo(torch.int32).max))
    start = big.amin(dim=1)
    return torch.where(live.any(dim=1), start - 1, torch.full_like(start, -1))


def _rank_heads(t, B, T, n_heads, n_local, hd, r):
    """(B, T, n_local, hd): ``t`` if it holds this rank's heads already
    (a column-sharded projection), else heads [r*n_local, (r+1)*n_local)
    of the whole projection (a replicated packed payload)."""
    t = t.reshape(B, T, -1, hd)
    if t.shape[2] == n_local:
        return t
    return t.narrow(2, r * n_local, n_local)


def attention_block(p, x, positions, cfg: AttnConfig, *, ctx=None,
                    prefix="attn", cache=None, chunked: Optional[bool] = None,
                    block_table=None, append: bool = False,
                    write_plans=None, dist=None):
    """x: (B, T, D) — or, in DEPLOY, a QTensor int8 norm output with packed
    projection weights (QKV and Wo then run on the int8 matmul kernel).
    p: wq (D,H*hd), wk/wv (D,KV*hd), wo (H*hd,D).

    Prefill (T > 1) attends over the fresh K/V and writes the last
    min(T, S) tokens into the cache; decode (T == 1) writes the new token
    and attends over the cache, through K5 (int8), K6 (paged int8) or K7
    (paged f32/bf16) where the cache has that type. Paged caches need the
    ``block_table`` (B, nb) of the whole-model cache.

    ``append=True`` is chunked prefill: the T tokens are one chunk appended
    at each lane's position, so the queries attend over the cache as it was
    before the write (the lane's earlier chunks, read back as decode would
    read them) plus the fresh chunk. ``write_plans``: a dict the layers
    of one forward share, so the cache writes' scatter plan is made once
    per capacity. Returns (out, cache), the cache written in place.

    ``dist`` (tensor-parallel, ``cfg`` the whole layer's), caches on KV
    heads (``kv_seq_shard=False``): this rank owns query heads
    [r*H/N, (r+1)*H/N) and KV heads [r*KV/N, (r+1)*KV/N), and ``cache``
    holds those KV heads. Float projections are column shards; packed
    payloads are whole on every rank, so their q/k/v are cut to the rank's
    heads. The output projection is a row shard summed over ``model`` in
    f32, or, on a whole (packed) ``wo``, the whole input gathered over
    ``model`` first (int8 bytes at decode rows, where the kernel emits
    them). Caches on the sequence dim (the default): every rank computes
    q, k and v of all heads (float column shards gathered whole) and
    ``cache`` holds its cells of every head (``_write_kv`` /
    ``_write_paged_kv`` ``shard``); a decode step merges every rank's
    partials (:func:`_kernel_decode_attend`), so the attention output is
    whole: an emit feeds the whole packed ``wo``, a float row shard takes
    its heads' slice. ``out`` is whole on every rank."""
    from repro_torch.core import deploy as deploy_lib
    x_int8 = isinstance(x, deploy_lib.QTensor)
    B, T, _ = x.shape
    n_tp, r = coll.tp_size(dist), coll.tp_index(dist)
    # the cache-free forward (training) runs on the rank's heads whatever
    # the cache layout: no activation crosses ranks before wo's row sum
    seq = n_tp > 1 and dist.kv_seq_shard and cache is not None
    # the rank attends on its part of the heads (the sites of q, k, v, the
    # softmax and a float wo's input see cut tensors)
    part = n_tp > 1 and not seq
    H_all, KV_all = cfg.num_heads, cfg.num_kv_heads
    if n_tp > 1 and not seq:
        cfg = dataclasses.replace(cfg, num_heads=H_all // n_tp,
                                  num_kv_heads=KV_all // n_tp)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo_aq = ctx.deploy_act(f"{prefix}/wo_in") if x_int8 else None
    # the decode kernels emit wo's int8 input from their merge, except with
    # quant telemetry armed: the wo_in site then needs the f32 output, so
    # the kernel returns it and K4 quantizes it (the same bytes)
    emit_aq = wo_aq if ctx is None or ctx.telemetry is None else None

    def w(name, a):
        wmat = resolve_weight(p[name], matmul_dtype(a))
        return ctx.weight(f"{prefix}/{name}", wmat) if ctx is not None \
            else wmat

    if x_int8:
        q = deploy_lib.matmul(x, p["wq"])
        k = deploy_lib.matmul(x, p["wk"])
        v = deploy_lib.matmul(x, p["wv"])
    else:
        x = coll.copy_to(x, dist)       # column-parallel products
        q = dot(x, w("wq", x))
        k = dot(x, w("wk", x))
        v = dot(x, w("wv", x))
    if seq:     # every head on every rank: column shards gathered whole
        q, k, v = (t if t.shape[-1] == n * hd else coll.gather_from(t, dist)
                   for t, n in ((q, H_all), (k, KV_all), (v, KV_all)))
    q = _rank_heads(q, B, T, H_all, H, hd, r)
    k = _rank_heads(k, B, T, KV_all, KV, hd, r)
    v = _rank_heads(v, B, T, KV_all, KV, hd, r)
    if "q_norm" in p:   # qwen3-style per-head QK norm
        from repro_torch.models.common import rms_norm
        # whole gains on the rank's heads: their gradient sums over model
        q = rms_norm(q, coll.copy_to(p["q_norm"], dist))
        k = rms_norm(k, coll.copy_to(p["k_norm"], dist))
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if ctx is not None:
        q = ctx.act(f"{prefix}/q", q)
        k = ctx.act(f"{prefix}/k", k)
        v = ctx.act(f"{prefix}/v", v)
        if part:
            ctx.mark_cut(f"{prefix}/q", f"{prefix}/k", f"{prefix}/v")

    positions = positions.expand(B, T)
    new_cache = None
    out = None
    k_att, v_att, kpos_att = k, v, positions
    if cache is not None:
        paged = isinstance(cache, (PagedKVCache, PagedQuantKVCache))
        quantized = isinstance(cache, (QuantKVCache, PagedQuantKVCache))
        if not (paged or quantized or isinstance(cache, KVCache)):
            raise NotImplementedError(
                f"{type(cache).__name__}: this KV cache type is not yet "
                "ported")
        # int4 caches read their grids from the separate kv4 site (present
        # only when k/v were calibrated at 4 bits; else dynamic int4 grids)
        kv_site = f"{prefix}/kv4" if isinstance(cache, _INT4_CACHES) \
            else f"{prefix}/kv"
        kvq = ctx.deploy_act(kv_site) \
            if (quantized and ctx is not None) else None
        if kvq is not None and n_tp > 1 and not seq:
            # the per-head grids of this rank's KV heads
            kvq = type(kvq)(*(g.narrow(0, r * KV, KV) for g in kvq))
        # the cells this rank holds: all of them, or its slice of N
        shard = (r, n_tp) if seq else (0, 1)

        def whole(c):
            """The cache as the unsharded layer holds it."""
            return _whole_cells(c, dist) if seq else c
        if paged:
            if block_table is None:
                raise ValueError("paged KV cache needs the block_table of "
                                 "the whole-model cache")
            bs = cache.pos.shape[1] * shard[1]
            S = paged_capacity(block_table, bs, cfg.window)
        else:
            S = cache.pos.shape[1] * shard[1]
        if T > 1:
            if append:
                # the cache before this chunk's write: ring cells the chunk
                # overwrites still show their old occupant to its earlier
                # queries
                past = whole(cache)
                if paged:
                    k_past, v_past = paged_gather_kv(past, block_table,
                                                     cfg.window, kvq)
                    kpos_past = paged_key_positions(
                        block_table, _prev_positions(positions), S, bs)
                elif quantized:
                    k_past, v_past = dequantize_kv(past, kvq)
                    kpos_past = past.pos
                else:
                    k_past, v_past, kpos_past = past.k, past.v, past.pos
                # copied before the write below changes the cache in place
                k_att = torch.cat([k_past.to(k.dtype), k], dim=1)
                v_att = torch.cat([v_past.to(v.dtype), v], dim=1)
                kpos_att = torch.cat([kpos_past.to(positions.dtype),
                                      positions], dim=1)
            keep = min(T, S)
            kw, vw, pw = k[:, -keep:], v[:, -keep:], positions[:, -keep:]
            if paged:
                new_cache = _write_paged_kv(cache, kw, vw, pw, block_table,
                                            cfg.window, kvq,
                                            plans=write_plans, shard=shard)
            else:
                new_cache = _write_kv(cache, kw, vw, pw, cfg.window, kvq,
                                      plans=write_plans, shard=shard)
        elif paged:
            new_cache = _write_paged_kv(cache, k, v, positions, block_table,
                                        cfg.window, kvq, plans=write_plans,
                                        shard=shard)
            out = _kernel_decode_attend(q, new_cache, block_table, positions,
                                        cfg, ctx, prefix, kvq, emit_aq,
                                        dist if seq else None)
            if out is None:
                k_att, v_att = paged_gather_kv(whole(new_cache), block_table,
                                               cfg.window, kvq)
                kpos_att = paged_key_positions(block_table, positions[:, 0],
                                               S, bs)
        else:
            new_cache = _write_kv(cache, k, v, positions, cfg.window, kvq,
                                  plans=write_plans, shard=shard)
            if quantized:
                out = _kernel_decode_attend(q, new_cache, None, positions,
                                            cfg, ctx, prefix, kvq, emit_aq,
                                            dist if seq else None)
                if out is None:
                    read = whole(new_cache)
                    k_att, v_att = dequantize_kv(read, kvq)
                    kpos_att = read.pos
            else:
                read = whole(new_cache)
                k_att, v_att, kpos_att = read.k, read.v, read.pos

    if out is None:
        out = attend(q, k_att.to(q.dtype), v_att.to(q.dtype), positions,
                     kpos_att, cfg, ctx=ctx, prefix=prefix, chunked=chunked,
                     part=part)
    # the attention output of every head (sequence layout) or of this
    # rank's heads, which the other ranks' complete
    gather = (lambda t: t) if seq else (lambda t: coll.gather_from(t, dist))
    if isinstance(out, deploy_lib.QTensor):
        # the decode kernel's (or the merge's) emit of wo's int8 input, for
        # the whole packed wo
        out = deploy_lib.matmul(out._replace(q=gather(out.q)), p["wo"])
    elif x_int8:
        out2d = gather(out.reshape(B, T, H * hd))
        if ctx.telemetry is not None:
            ctx.telem_site(f"{prefix}/wo_in",
                           deploy_lib.site_stats(out2d, wo_aq))
        out = deploy_lib.matmul(deploy_lib.quantize_act(out2d, wo_aq),
                                p["wo"])
    else:
        out2d = out.reshape(B, T, H * hd)
        if ctx is not None:
            out2d = ctx.act_in(f"{prefix}/wo_in", out2d)
            if part:
                ctx.mark_cut(f"{prefix}/wo_in")
        wo = w("wo", out2d)
        rows = wo.shape[0]
        if seq and rows != out2d.shape[-1]:     # a row shard: its heads
            out = dot_row_parallel(out2d.narrow(-1, r * rows, rows), wo,
                                   dist)
        elif seq:                               # a whole wo (stored int8)
            out = dot(out2d, wo)
        elif rows == out2d.shape[-1]:
            out = dot_row_parallel(out2d, wo, dist)
        else:       # a whole wo (stored int8): the whole input first
            out = dot(coll.gather_from(out2d, dist), wo)
    if ctx is not None:
        out = ctx.act(f"{prefix}/ctx_out", out)
    return out, new_cache


def init_attention_params(gen, d_model: int, cfg: AttnConfig, dtype,
                          device=None, qk_norm: bool = False):
    """wq, wk, wv, wo; with ``qk_norm`` (qwen3) the per-head RMSNorm gains
    ``q_norm`` and ``k_norm`` of shape (hd,), zeros (the ``(1 + g)``
    affine)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d_model, H * hd, dtype, device=device),
         "wk": dense_init(gen, d_model, KV * hd, dtype, device=device),
         "wv": dense_init(gen, d_model, KV * hd, dtype, device=device),
         "wo": dense_init(gen, H * hd, d_model, dtype, device=device)}
    if qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p
