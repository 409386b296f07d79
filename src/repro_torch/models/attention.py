"""Multi-head attention with KV caches (port of the parts of
``repro.models.attention`` the serving path uses): GQA, sliding window,
logit soft-capping, RoPE, the dense and the chunked (online-softmax)
attend; dense, int8, nibble-packed int4, block-paged and paged int8 / int4
caches; decode through the attention kernels (K5-K7) and chunked (append)
prefill.

Absolute positions drive masking and cache writes; position -1 marks a DEAD
cell (a prompt pad or an idle lane): it is masked out of attention and its
cache write is dropped, so packing and idle lanes never perturb other lanes.

Cache writes are functional, like the reference's scatter: they return new
cache tensors (a gather + select for the dense caches, a scatter into a
copy of the arena for the paged ones), so no data-dependent host sync is
needed to drop dead writes. Every write rebuilds the cache as its own type,
so the int4 subclasses (the bit-width marker) survive it.

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
                                       resolve_weight, softcap)

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
                  prefix=""):
    """q: (B,T,H,hd), k/v: (B,S,KV,hd). Returns (B,T,H,hd)."""
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


def attend(q, k, v, q_pos, k_pos, cfg: AttnConfig, *, ctx=None, prefix="",
           chunked: Optional[bool] = None, kv_chunk: int = 1024):
    """Dense (supports the quantization sites) or chunked (long contexts)."""
    T, S = q.shape[1], k.shape[1]
    if chunked is None:
        chunked = T * S > 4096 * 4096
    if chunked:
        return _chunked_attend(q, k, v, q_pos, k_pos, cfg, kv_chunk)
    return _dense_attend(q, k, v, q_pos, k_pos, cfg, ctx, prefix)


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


def _write_kv(cache, k_new, v_new, pw, slots, kvq=None):
    """New cache with the (B, T) new tokens written at ``slots``; slots
    equal to S (dead cells) write nothing. Live slots of one lane are
    distinct (positions are), so each cell has at most one source. A
    quantized cache quantizes the tokens first (per-head, per-slot scales;
    int4 caches nibble-pack) and comes back as its own type."""
    B, S = cache.pos.shape
    hit = slots[:, :, None] == torch.arange(S, device=slots.device)
    has = hit.any(dim=1)                                 # (B, S)
    src = hit.int().argmax(dim=1)                        # (B, S) token index

    def put(old, new):
        tail = (1,) * (old.dim() - 2)
        idx = src.reshape(B, S, *tail).expand(B, S, *old.shape[2:])
        gathered = torch.gather(new.to(old.dtype), 1, idx)
        return torch.where(has.reshape(B, S, *tail), gathered, old)

    if isinstance(cache, QuantKVCache):
        kq, ks, vq, vs = _quantize_kv_writes(cache, k_new, v_new, kvq)
        return type(cache)(k_q=put(cache.k_q, kq), v_q=put(cache.v_q, vq),
                           k_s=put(cache.k_s, ks), v_s=put(cache.v_s, vs),
                           pos=put(cache.pos, pw.to(cache.pos.dtype)))
    return KVCache(k=put(cache.k, k_new), v=put(cache.v, v_new),
                   pos=put(cache.pos, pw.to(cache.pos.dtype)))


def _write_paged_kv(cache, k_new, v_new, pw, block_table, window, kvq=None):
    """New arena with the (B, T) tokens written through the lanes' block
    table: logical cell ``pw % s_cap``, physical block from the table. Dead
    cells (pw < 0) and unmapped blocks are dropped. Functional: each field
    is copied once with a spare row at its end, the tokens are scattered
    into the copy (dropped writes all land on the spare row) and the spare
    row is cut off again."""
    num_blocks, bs = cache.pos.shape
    s_cap = paged_capacity(block_table, bs, window)
    L = torch.remainder(torch.clamp_min(pw, 0), s_cap)
    phys = torch.gather(block_table, 1, (L // bs).long())
    dead = (pw < 0) | (phys < 0)
    flat = torch.where(dead, num_blocks * bs, phys * bs + L % bs)
    flat = flat.reshape(-1).long()

    def put(arena, new):
        rows = arena.reshape(num_blocks * bs, *arena.shape[2:])
        rows = torch.cat([rows, rows[:1]]).index_copy(
            0, flat, new.reshape(flat.shape[0], *arena.shape[2:]).to(
                arena.dtype))
        return rows[:-1].reshape(arena.shape)

    pos = put(cache.pos, pw)
    if isinstance(cache, PagedQuantKVCache):
        kq, ks, vq, vs = _quantize_kv_writes(cache, k_new, v_new, kvq)
        return type(cache)(k_q=put(cache.k_q, kq), v_q=put(cache.v_q, vq),
                           k_s=put(cache.k_s, ks), v_s=put(cache.v_s, vs),
                           pos=pos)
    return PagedKVCache(k=put(cache.k, k_new), v=put(cache.v, v_new),
                        pos=pos)


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
    """Empty every block the masked lanes map (``pos`` -> -1; payloads
    stay, masked by position). Takes (N, bs) and stacked (n, N, bs)
    arenas; the block table itself is host-owned and not touched."""
    num_blocks = cache.pos.shape[-2]
    ids = torch.where(lane_mask.bool()[:, None] & (block_table >= 0),
                      block_table, num_blocks).reshape(-1).long()
    hit = torch.zeros(num_blocks + 1, dtype=torch.bool,
                      device=cache.pos.device)
    hit[ids] = True
    return cache._replace(pos=torch.where(hit[:num_blocks, None], -1,
                                          cache.pos))


def reset_kv_lanes(cache, lane_mask, batch_axis: int = 0):
    """Empty the masked batch lanes of a dense (int8) cache for slot reuse:
    ``pos`` -> -1 on those lanes; payloads and scales stay, masked by
    position. ``batch_axis`` is 1 for stacked leaves."""
    shape = [1] * cache.pos.dim()
    shape[batch_axis] = lane_mask.shape[0]
    return cache._replace(pos=torch.where(lane_mask.bool().reshape(shape),
                                          -1, cache.pos))


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


def _kernel_decode_attend(q, cache, block_table, q_pos, cfg: AttnConfig,
                          ctx, prefix, kvq=None, wo_aq=None):
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
    output."""
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
    if isinstance(cache, (PagedKVCache, PagedQuantKVCache)):
        kw["s_cap"] = paged_capacity(block_table, cache.pos.shape[1],
                                     cfg.window)
    emit = (wo_aq is not None and wo_aq.per_tensor
            and q.dtype == torch.float32)
    if emit:
        kw.update(out_scale=wo_aq.scales[0], out_zp=wo_aq.zps[0],
                  qmin=wo_aq.qmin, qmax=wo_aq.qmax)
    if isinstance(cache, PagedKVCache):
        out = kops.paged_attend_decode(qg * cfg.scale, cache.k, cache.v,
                                       block_table, q_pos[:, 0], **kw)
    else:
        q_q, qs, qz = _quantize_decode_q(qg, q_site)
        kz, vz = _kv_zero_points(kvq, B, KV)
        args = (q_q, qs * cfg.scale, cache.k_q, cache.k_s, cache.v_q,
                cache.v_s)
        kw.update(q_zp=qz, k_zp=kz, v_zp=vz,
                  kv_bits=4 if isinstance(cache, _INT4_CACHES) else 8)
        if isinstance(cache, PagedQuantKVCache):
            out = kops.paged_int8_attend_decode(*args, block_table,
                                                q_pos[:, 0], **kw)
        else:
            out = kops.int8_attend_decode(*args, cache.pos, q_pos[:, 0],
                                          **kw)
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


def attention_block(p, x, positions, cfg: AttnConfig, *, ctx=None,
                    prefix="attn", cache=None, chunked: Optional[bool] = None,
                    block_table=None, append: bool = False):
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
    read them) plus the fresh chunk. Returns (out, new_cache)."""
    from repro_torch.core import deploy as deploy_lib
    x_int8 = isinstance(x, deploy_lib.QTensor)
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo_aq = ctx.deploy_act(f"{prefix}/wo_in") if x_int8 else None

    def w(name):
        wmat = resolve_weight(p[name])
        return ctx.weight(f"{prefix}/{name}", wmat) if ctx is not None \
            else wmat

    if x_int8:
        q = deploy_lib.matmul(x, p["wq"]).reshape(B, T, H, hd)
        k = deploy_lib.matmul(x, p["wk"]).reshape(B, T, KV, hd)
        v = deploy_lib.matmul(x, p["wv"]).reshape(B, T, KV, hd)
    else:
        q = dot(x, w("wq")).reshape(B, T, H, hd)
        k = dot(x, w("wk")).reshape(B, T, KV, hd)
        v = dot(x, w("wv")).reshape(B, T, KV, hd)
    if "q_norm" in p:   # qwen3-style per-head QK norm
        from repro_torch.models.common import rms_norm
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if ctx is not None:
        q = ctx.act(f"{prefix}/q", q)
        k = ctx.act(f"{prefix}/k", k)
        v = ctx.act(f"{prefix}/v", v)

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
        if paged:
            if block_table is None:
                raise ValueError("paged KV cache needs the block_table of "
                                 "the whole-model cache")
            bs = cache.pos.shape[1]
            S = paged_capacity(block_table, bs, cfg.window)
        else:
            S = cache.pos.shape[1]
        if T > 1:
            if append:
                # the cache before this chunk's write: ring cells the chunk
                # overwrites still show their old occupant to its earlier
                # queries
                if paged:
                    k_past, v_past = paged_gather_kv(cache, block_table,
                                                     cfg.window, kvq)
                    kpos_past = paged_key_positions(
                        block_table, _prev_positions(positions), S, bs)
                elif quantized:
                    k_past, v_past = dequantize_kv(cache, kvq)
                    kpos_past = cache.pos
                else:
                    k_past, v_past, kpos_past = cache.k, cache.v, cache.pos
            keep = min(T, S)
            kw, vw, pw = k[:, -keep:], v[:, -keep:], positions[:, -keep:]
            if paged:
                new_cache = _write_paged_kv(cache, kw, vw, pw, block_table,
                                            cfg.window, kvq)
            else:
                new_cache = _write_kv(cache, kw, vw, pw,
                                      _write_slots(pw, S, cfg.window), kvq)
            if append:
                k_att = torch.cat([k_past.to(k.dtype), k], dim=1)
                v_att = torch.cat([v_past.to(v.dtype), v], dim=1)
                kpos_att = torch.cat([kpos_past.to(positions.dtype),
                                      positions], dim=1)
        elif paged:
            new_cache = _write_paged_kv(cache, k, v, positions, block_table,
                                        cfg.window, kvq)
            out = _kernel_decode_attend(q, new_cache, block_table, positions,
                                        cfg, ctx, prefix, kvq, wo_aq)
            if out is None:
                k_att, v_att = paged_gather_kv(new_cache, block_table,
                                               cfg.window, kvq)
                kpos_att = paged_key_positions(block_table, positions[:, 0],
                                               S, bs)
        else:
            new_cache = _write_kv(cache, k, v, positions,
                                  _write_slots(positions, S, cfg.window),
                                  kvq)
            if quantized:
                out = _kernel_decode_attend(q, new_cache, None, positions,
                                            cfg, ctx, prefix, kvq, wo_aq)
                if out is None:
                    k_att, v_att = dequantize_kv(new_cache, kvq)
                    kpos_att = new_cache.pos
            else:
                k_att, v_att, kpos_att = (new_cache.k, new_cache.v,
                                          new_cache.pos)

    if out is None:
        out = attend(q, k_att.to(q.dtype), v_att.to(q.dtype), positions,
                     kpos_att, cfg, ctx=ctx, prefix=prefix, chunked=chunked)
    if isinstance(out, deploy_lib.QTensor):
        # the decode kernel's merge emitted wo's int8 input
        out = deploy_lib.matmul(out, p["wo"])
    elif x_int8:
        out = deploy_lib.matmul(deploy_lib.quantize_act(
            out.reshape(B, T, H * hd), wo_aq), p["wo"])
    else:
        out2d = out.reshape(B, T, H * hd)
        if ctx is not None:
            out2d = ctx.act_in(f"{prefix}/wo_in", out2d)
        out = dot(out2d, w("wo"))
    if ctx is not None:
        out = ctx.act(f"{prefix}/ctx_out", out)
    return out, new_cache


def init_attention_params(gen, d_model: int, cfg: AttnConfig, dtype,
                          device=None):
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init(gen, d_model, H * hd, dtype, device=device),
            "wk": dense_init(gen, d_model, KV * hd, dtype, device=device),
            "wv": dense_init(gen, d_model, KV * hd, dtype, device=device),
            "wo": dense_init(gen, H * hd, d_model, dtype, device=device)}
