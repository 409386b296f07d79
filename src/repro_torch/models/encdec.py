"""Encoder-decoder transformer, the seamless-m4t backbone (port of
``repro.models.encdec``).

The encoder consumes precomputed frame embeddings (the audio front end is a
stub, ``models.frontends``); the decoder is a causal transformer with
cross-attention into the encoder memory. Learned absolute positions,
LayerNorm, pre-norm blocks, the MLP FFN. Layers are stacked (``enc_scan``,
``dec_scan``: every leaf carries a leading layer axis, the reference's
``lax.scan`` layout); here a Python loop walks views of the stacked layers.

Serving writes the decoder's self-attention cache in place, as the
decoder-only steps do, and returns the cache object it was given; the
projected cross-attention K/V are written into the cache once, by
:func:`prefill_from_encoder`. There is no integer path, as in the
reference; a ``QuantCtx`` fake-quantizes every site the reference names.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.attention import (AttnConfig, KVCache, attend,
                                          attention_block,
                                          init_attention_params)
from repro_torch.models.common import (cross_entropy, dot, embed_init,
                                       layer_norm)
from repro_torch.models.transformer import _layer, _map, _unstack


def _acfg(cfg: ModelConfig, causal: bool) -> AttnConfig:
    return AttnConfig(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.hd, causal=causal, rope_theta=None)


def _ln(p, x):
    return layer_norm(x, p["g"], p["b"])


def _init_ln(d, dtype, device):
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def _init_layer(cfg: ModelConfig, gen, dtype, device, cross: bool):
    p = {"ln1": _init_ln(cfg.d_model, dtype, device),
         "attn": init_attention_params(gen, cfg.d_model, _acfg(cfg, True),
                                       dtype, device),
         "ln2": _init_ln(cfg.d_model, dtype, device),
         "ffn": ffn_lib.init_mlp_params(gen, cfg.d_model, cfg.d_ff, dtype,
                                        device)}
    if cross:
        p["ln_x"] = _init_ln(cfg.d_model, dtype, device)
        p["xattn"] = init_attention_params(gen, cfg.d_model,
                                           _acfg(cfg, False), dtype, device)
    return p


def _stacked_layers(cfg: ModelConfig, n: int, gen, dtype, device, cross):
    """``n`` layers drawn in order, each copied into its slot of the stack
    as it is drawn (the stack never holds a second copy)."""
    stack = None
    for i in range(n):
        p = _init_layer(cfg, gen, dtype, device, cross)
        if stack is None:
            stack = _map(lambda x: x.new_empty((n, *x.shape)), p)
        _map(lambda dst, x: dst[i].copy_(x), stack, p)
    return stack


def init_params(cfg: ModelConfig, seed: int = 0, *, dtype=torch.bfloat16,
                device=None):
    """Random weights from ``seed`` (the reference's distributions and
    tree), on ``device`` (None: the GPU): encoder layers, decoder layers,
    then the embedding and the two position tables, from one generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    enc = _stacked_layers(cfg, cfg.encoder_layers, gen, dtype, device, False)
    dec = _stacked_layers(cfg, cfg.num_layers, gen, dtype, device, True)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "enc_pos": embed_init(gen, cfg.max_seq_len, cfg.d_model, dtype,
                              device),
        "dec_pos": embed_init(gen, cfg.max_seq_len, cfg.d_model, dtype,
                              device),
        "enc_scan": enc,
        "dec_scan": dec,
        "enc_norm": _init_ln(cfg.d_model, dtype, device),
        "final_norm": _init_ln(cfg.d_model, dtype, device),
    }


def _cross_attention(p, x, memory, mem_pos, cfg: ModelConfig, ctx=None,
                     prefix="xattn", cached_kv: Optional[Tuple] = None):
    """x: (B, T, D) queries; memory: (B, S, D) encoder output, or None with
    ``cached_kv`` (the projected (k, v)). Non-causal: the queries'
    positions are unused (zeros). Returns (out, (k, v))."""
    B, T, _ = x.shape
    acfg = _acfg(cfg, causal=False)
    H, KV, hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim

    def w(name):
        return ctx.weight(f"{prefix}/{name}", p[name]) if ctx is not None \
            else p[name]

    q = dot(x, w("wq")).reshape(B, T, H, hd)
    if cached_kv is not None:
        k, v = cached_kv
    else:
        k = dot(memory, w("wk")).reshape(B, -1, KV, hd)
        v = dot(memory, w("wv")).reshape(B, -1, KV, hd)
    q_pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    out = attend(q, k.to(q.dtype), v.to(q.dtype), q_pos, mem_pos, acfg,
                 ctx=ctx, prefix=prefix)
    return dot(out.reshape(B, T, H * hd), w("wo")), (k, v)


def _positions(n: int, batch: int, device):
    return torch.arange(n, dtype=torch.int32, device=device).expand(batch, n)


def encode(cfg: ModelConfig, params, frames, *, ctx=None):
    """frames: (B, S, D) front-end embeddings -> the encoder memory."""
    B, S, _ = frames.shape
    positions = _positions(S, B, frames.device)
    x = frames.to(params["enc_pos"].dtype) + params["enc_pos"][:S][None]
    if ctx is not None:
        x = ctx.act("embed/sum", x)
    acfg = _acfg(cfg, causal=False)
    for p in _unstack(params["enc_scan"], cfg.encoder_layers):
        h = _ln(p["ln1"], x)
        a, _ = attention_block(p["attn"], h, positions, acfg, ctx=ctx,
                               prefix="enc/attn")
        x = x + a
        h = _ln(p["ln2"], x)
        if ctx is not None:
            h = ctx.act("enc/ffn_in", h)
        f = ffn_lib.mlp(p["ffn"], h, activation=cfg.act, ctx=ctx,
                        prefix="enc/ffn")
        if ctx is not None:
            f = ctx.act("enc/ffn_out", f)
        x = x + f
        if ctx is not None:
            x = ctx.act("enc/residual_ffn", x)
    return _ln(params["enc_norm"], x)


class DecoderCache(NamedTuple):
    """self_kv: a stacked :class:`KVCache` (leaves (L, B, ...)); cross_k /
    cross_v (L, B, S, KV, hd): the projected encoder memory; mem_pos (B, S)
    the memory's positions."""
    self_kv: Any
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    mem_pos: torch.Tensor


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       mem_len: int, dtype=torch.bfloat16,
                       device=None) -> DecoderCache:
    dev = resolve_device(device)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    kv_shape = (L, batch, max_len, KV, hd)
    x_shape = (L, batch, mem_len, KV, hd)
    return DecoderCache(
        self_kv=KVCache(k=torch.zeros(kv_shape, dtype=dtype, device=dev),
                        v=torch.zeros(kv_shape, dtype=dtype, device=dev),
                        pos=torch.full((L, batch, max_len), -1,
                                       dtype=torch.int32, device=dev)),
        cross_k=torch.zeros(x_shape, dtype=dtype, device=dev),
        cross_v=torch.zeros(x_shape, dtype=dtype, device=dev),
        mem_pos=torch.zeros((batch, mem_len), dtype=torch.int32, device=dev))


def decode(cfg: ModelConfig, params, tokens, memory=None, *, positions=None,
           cache: Optional[DecoderCache] = None, ctx=None):
    """The decoder. Training: ``memory`` given, no cache, teacher forcing
    over every token. Serving: the cache carries the self-attention K/V and
    the projected cross K/V; with ``memory`` too (the first step) the cross
    K/V are projected from it and written into the cache. Returns (logits,
    cache): the cache given, written in place, or None."""
    B, T = tokens.shape
    if positions is None:
        positions = _positions(T, B, tokens.device)
    x = params["embed"][tokens.long()] + params["dec_pos"][positions.long()]
    if ctx is not None:
        x = ctx.act("dec/embed_sum", x)
    acfg = _acfg(cfg, causal=True)
    if memory is not None:
        mem_pos = _positions(memory.shape[1], B, memory.device)
    else:
        mem_pos = cache.mem_pos
    L = cfg.num_layers
    if cache is None:
        layers = _unstack(params["dec_scan"], L)
    for i in range(L):
        if cache is None:
            p, self_c = layers[i], None
        else:
            p, self_c = _layer(params["dec_scan"], i), _layer(cache.self_kv, i)
        h = _ln(p["ln1"], x)
        a, _ = attention_block(p["attn"], h, positions, acfg, ctx=ctx,
                               prefix="dec/attn", cache=self_c)
        x = x + a
        if ctx is not None:
            x = ctx.act("dec/residual_attn", x)
        h = _ln(p["ln_x"], x)
        if memory is not None:
            a, (xk, xv) = _cross_attention(p["xattn"], h, memory, mem_pos,
                                           cfg, ctx=ctx)
            if cache is not None:
                cache.cross_k[i].copy_(xk)
                cache.cross_v[i].copy_(xv)
                if i == 0:
                    cache.mem_pos.copy_(mem_pos)
        else:
            a, _ = _cross_attention(p["xattn"], h, None, mem_pos, cfg,
                                    ctx=ctx, cached_kv=(cache.cross_k[i],
                                                        cache.cross_v[i]))
        x = x + a
        h = _ln(p["ln2"], x)
        if ctx is not None:
            h = ctx.act("dec/ffn_in", h)
        f = ffn_lib.mlp(p["ffn"], h, activation=cfg.act, ctx=ctx,
                        prefix="dec/ffn")
        if ctx is not None:
            f = ctx.act("dec/ffn_out", f)
        x = x + f
        if ctx is not None:
            x = ctx.act("dec/residual_ffn", x)
    logits = _ln(params["final_norm"], x) @ params["embed"].T.to(x.dtype)
    if ctx is not None:
        logits = ctx.act("head/logits", logits)
    return logits, cache


def train_loss(cfg: ModelConfig, params, batch, *, ctx=None,
               remat: bool = True):
    """Next-token CE. batch: {frames (B, S, D), tokens (B, T), labels
    (B, T)}. ``remat`` is taken and unused: the reference's encoder-decoder
    loss does not rematerialize either."""
    memory = encode(cfg, params, batch["frames"], ctx=ctx)
    logits, _ = decode(cfg, params, batch["tokens"], memory, ctx=ctx)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


def prefill_from_encoder(cfg: ModelConfig, params, frames, bos_tokens,
                         max_decode_len: int, *, ctx=None):
    """Encode, project the cross K/V into a fresh decoder cache of
    ``max_decode_len`` self-attention cells and run the first decoder step
    on ``bos_tokens`` (B, 1) at position 0. Returns (logits, cache)."""
    memory = encode(cfg, params, frames, ctx=ctx)
    B, S, _ = memory.shape
    cache = init_decoder_cache(cfg, B, max_decode_len, S, memory.dtype,
                               memory.device)
    pos0 = torch.zeros((B, 1), dtype=torch.int32, device=memory.device)
    return decode(cfg, params, bos_tokens, memory=memory, positions=pos0,
                  cache=cache, ctx=ctx)


def decode_step(cfg: ModelConfig, params, tokens, pos,
                cache: DecoderCache, *, ctx=None):
    """One decoder step. tokens / pos: (B, 1). Returns (logits, cache)."""
    return decode(cfg, params, tokens, positions=pos, cache=cache, ctx=ctx)
