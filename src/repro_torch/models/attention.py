"""Multi-head attention over a dense KV cache (port of the parts of
``repro.models.attention`` the bf16-cache serving path uses): GQA,
sliding window, logit soft-capping, RoPE, the dense and the chunked
(online-softmax) attend, and the cache write with the dead-cell rule.

Absolute positions drive masking and cache writes; position -1 marks a DEAD
cell (a prompt pad or an idle lane): it is masked out of attention and its
cache write is dropped, so packing and idle lanes never perturb other lanes.

The cache write is functional, like the reference's scatter: it returns new
cache tensors built with a gather + select, so no data-dependent host sync
is needed to drop dead writes. Quantized (int8/int4) and paged caches and
chunked (append) prefill come with the next slice.

Quantization sites (paper Fig. 1 naming), threaded via QuantCtx:
  {prefix}/q, {prefix}/k, {prefix}/v, {prefix}/softmax_in,
  {prefix}/softmax_out, {prefix}/ctx_out; matmul inputs {prefix}/wo_in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

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


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    size = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.full((batch, size), -1, dtype=torch.int32,
                                  device=device))


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


def _write_kv(cache: KVCache, k_new, v_new, pw, slots) -> KVCache:
    """New cache with the (B, T) new tokens written at ``slots``; slots
    equal to S (dead cells) write nothing. Live slots of one lane are
    distinct (positions are), so each cell has at most one source."""
    B, S = cache.pos.shape
    hit = slots[:, :, None] == torch.arange(S, device=slots.device)
    has = hit.any(dim=1)                                 # (B, S)
    src = hit.int().argmax(dim=1)                        # (B, S) token index

    def put(old, new):
        tail = (1,) * (old.dim() - 2)
        idx = src.reshape(B, S, *tail).expand(B, S, *old.shape[2:])
        gathered = torch.gather(new.to(old.dtype), 1, idx)
        return torch.where(has.reshape(B, S, *tail), gathered, old)

    return KVCache(k=put(cache.k, k_new), v=put(cache.v, v_new),
                   pos=put(cache.pos, pw.to(cache.pos.dtype)))


def attention_block(p, x, positions, cfg: AttnConfig, *, ctx=None,
                    prefix="attn", cache: Optional[KVCache] = None,
                    chunked: Optional[bool] = None):
    """x: (B, T, D) — or, in DEPLOY, a QTensor int8 norm output with packed
    projection weights (QKV and Wo then run on the int8 matmul kernel).
    p: wq (D,H*hd), wk/wv (D,KV*hd), wo (H*hd,D).

    Prefill (T > 1) attends over the fresh K/V and writes the last
    min(T, S) tokens into the cache; decode (T == 1) writes the new token
    and attends over the cache. Returns (out, new_cache)."""
    from repro_torch.core import deploy as deploy_lib
    x_int8 = isinstance(x, deploy_lib.QTensor)
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

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
    if cache is not None:
        if not isinstance(cache, KVCache):
            raise NotImplementedError(
                f"{type(cache).__name__}: quantized and paged KV caches are "
                "not yet ported")
        S = cache.pos.shape[1]
        if T > 1:
            keep = min(T, S)
            pw = positions[:, -keep:]
            new_cache = _write_kv(cache, k[:, -keep:], v[:, -keep:], pw,
                                  _write_slots(pw, S, cfg.window))
            k_att, v_att, kpos_att = k, v, positions
        else:
            new_cache = _write_kv(cache, k, v, positions,
                                  _write_slots(positions, S, cfg.window))
            k_att, v_att, kpos_att = new_cache.k, new_cache.v, new_cache.pos
    else:
        k_att, v_att, kpos_att = k, v, positions

    out = attend(q, k_att.to(q.dtype), v_att.to(q.dtype), positions,
                 kpos_att, cfg, ctx=ctx, prefix=prefix, chunked=chunked)
    out2d = out.reshape(B, T, H * hd)
    if x_int8:
        wo_aq = ctx.deploy_act(f"{prefix}/wo_in")
        out = deploy_lib.matmul(deploy_lib.quantize_act(out2d, wo_aq),
                                p["wo"])
    else:
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
