"""Decoder-only transformer for the ported attention families (port of the
dense parts of ``repro.models.transformer``), with the paper's quantization
sites threaded through.

Two parameter layouts share the same block function:
  * stacked — ``params["scan"]``: one dict per position of
    ``cfg.block_pattern`` whose leaves carry a leading axis over the
    pattern's repeats (the reference's ``lax.scan`` layout; here a Python
    loop slices layer after layer). Sites use the shared ``layer/...``
    names, so one calibration serves every layer.
  * unrolled — ``params["layers"]``: a flat per-layer list with per-layer
    site names ``layer{i}/...`` (calibration, per-layer experiments).

Quantization sites per block (paper Fig. 1 / Table 2 naming):
  {L}/attn_in, {L}/residual_attn, {L}/ffn_in, {L}/ffn_out,
  {L}/residual_ffn, plus the attention and FFN internal sites, and
  embed/sum, head/logits.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.attention import (AttnConfig, attention_block,
                                          init_attention_params,
                                          init_kv_cache)
from repro_torch.models.common import embed_init, rms_norm, resolve_weight, \
    softcap


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not yet ported")
    return rms_norm(x, p["g"])


def _init_norm(cfg: ModelConfig, dtype, device):
    return {"g": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def attn_cfg_for(cfg: ModelConfig, kind: str) -> AttnConfig:
    window = cfg.local_window if kind == "local_attn" else cfg.window
    return AttnConfig(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.hd, causal=True, window=window,
                      logit_softcap=cfg.attn_logit_softcap,
                      rope_theta=cfg.rope_theta)


def _ffn_apply(cfg: ModelConfig, p, x, *, ctx, prefix):
    if cfg.moe is not None or cfg.ffn_type != "glu":
        raise NotImplementedError("only GLU feed-forward blocks are ported")
    return ffn_lib.glu_mlp(p, x, activation=cfg.act, ctx=ctx, prefix=prefix)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn_packed(p) -> bool:
    from repro_torch.core import deploy
    ffn = p.get("ffn")
    return isinstance(ffn, dict) and deploy.is_packed(ffn.get("w_gate"))


def _attn_packed(p) -> bool:
    from repro_torch.core import deploy
    attn = p.get("attn")
    return isinstance(attn, dict) and deploy.is_packed(attn.get("wq"))


def _ffn_input(cfg: ModelConfig, p, x, ctx, prefix):
    """LN2 + the ffn_in quantizer; in DEPLOY with packed FFN weights they
    fuse into one norm + int8 emit kernel returning a QTensor."""
    if ctx is not None:
        aq = ctx.deploy_act(f"{prefix}/ffn_in")
        if aq is not None and _ffn_packed(p):
            from repro_torch.core import deploy
            return deploy.norm_quantize(cfg.norm, p["ln2"], x, aq)
    h = _norm(cfg, p["ln2"], x)
    if ctx is not None:
        h = ctx.act(f"{prefix}/ffn_in", h)
    return h


def _attn_input(cfg: ModelConfig, p, x, ctx, prefix):
    """LN1 + the attn_in input quantizer (fused in DEPLOY, see _ffn_input)."""
    if ctx is not None:
        aq = ctx.deploy_act(f"{prefix}/attn_in")
        if aq is not None and _attn_packed(p):
            from repro_torch.core import deploy
            return deploy.norm_quantize(cfg.norm, p["ln1"], x, aq)
    h = _norm(cfg, p["ln1"], x)
    if ctx is not None:
        h = ctx.act_in(f"{prefix}/attn_in", h)
    return h


def block_apply(cfg: ModelConfig, kind: str, p, x, positions, *, ctx=None,
                prefix="layer", cache=None, chunked=None):
    """One transformer block. Returns (x, new_cache)."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    h = _attn_input(cfg, p, x, ctx, prefix)
    attn_out, new_cache = attention_block(
        p["attn"], h, positions, attn_cfg_for(cfg, kind), ctx=ctx,
        prefix=f"{prefix}/attn", cache=cache, chunked=chunked)
    if cfg.post_norm:
        attn_out = _norm(cfg, p["post_ln1"], attn_out)
    x = x + attn_out
    if ctx is not None:
        x = ctx.act(f"{prefix}/residual_attn", x)
    h = _ffn_input(cfg, p, x, ctx, prefix)
    ffn_out = _ffn_apply(cfg, p["ffn"], h, ctx=ctx, prefix=f"{prefix}/ffn")
    if cfg.post_norm:
        ffn_out = _norm(cfg, p["post_ln2"], ffn_out)
    if ctx is not None:
        ffn_out = ctx.act(f"{prefix}/ffn_out", ffn_out)
    x = x + ffn_out
    if ctx is not None:
        x = ctx.act(f"{prefix}/residual_ffn", x)
    return x, new_cache


def init_block_params(cfg: ModelConfig, kind: str, gen, dtype, device):
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    if cfg.moe is not None or cfg.ffn_type != "glu":
        raise NotImplementedError("only GLU feed-forward blocks are ported")
    p: Dict[str, Any] = {"ln1": _init_norm(cfg, dtype, device),
                         "ln2": _init_norm(cfg, dtype, device)}
    p["attn"] = init_attention_params(gen, cfg.d_model,
                                      attn_cfg_for(cfg, kind), dtype, device)
    p["ffn"] = ffn_lib.init_glu_params(gen, cfg.d_model, cfg.d_ff, dtype,
                                       device)
    if cfg.post_norm:
        p["post_ln1"] = _init_norm(cfg, dtype, device)
        p["post_ln2"] = _init_norm(cfg, dtype, device)
    return p


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    """Apply ``fn`` to matching tensor leaves of nested dicts / lists /
    NamedTuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack(items):
    return _map(lambda *xs: torch.stack(xs), *items)


def _layer(tree, s: int):
    return _map(lambda x: x[s], tree)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, stacked: bool = True,
                dtype=torch.bfloat16, device=None):
    """Random weights from ``seed`` (the reference's distributions). Layers
    are drawn in layer order from one generator, so both layouts of one
    seed hold the same weights."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    plan = cfg.layer_plan
    layers = [init_block_params(cfg, kind, gen, dtype, device)
              for kind in plan]
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": _init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings are not yet ported")
    if not stacked:
        params["layers"] = layers
        return params
    n_pat = len(cfg.block_pattern)
    n_tail = len(cfg.tail_pattern)
    body = layers[:len(layers) - n_tail]
    params["scan"] = [_stack(body[j::n_pat]) for j in range(n_pat)]
    params["tail"] = layers[len(layers) - n_tail:]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               stacked: bool = True, dtype=torch.bfloat16, kv_bits: int = 16,
               paged: bool = False, device=None):
    """Dense bf16/f32 KV caches for every attention layer, in the params'
    layout. Quantized (kv_bits 8/4) and paged caches are not yet ported."""
    if kv_bits != 16 or paged:
        raise NotImplementedError("quantized and paged KV caches are not yet "
                                  "ported")

    def blk(kind):
        if kind not in ("attn", "local_attn"):
            raise NotImplementedError(f"{kind!r} caches are not yet ported")
        return init_kv_cache(batch, max_len, attn_cfg_for(cfg, kind), dtype,
                             device)

    if not stacked:
        return {"layers": [blk(kind) for kind in cfg.layer_plan]}
    return {"scan": [_stack([blk(kind)] * cfg.n_super)
                     for kind in cfg.block_pattern],
            "tail": [blk(kind) for kind in cfg.tail_pattern]}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens, ctx):
    x = resolve_weight(params["embed"])[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if ctx is not None:
        x = ctx.act("embed/sum", x)
    return x


def _head(cfg: ModelConfig, params, x, ctx):
    h = _norm(cfg, params["final_norm"], x)
    w = resolve_weight(params["embed"]).T
    if ctx is not None:
        w = ctx.weight("head/w", w)
    logits = softcap(h @ w.to(h.dtype), cfg.final_logit_softcap)
    if ctx is not None:
        logits = ctx.act("head/logits", logits)
    return logits


def forward(cfg: ModelConfig, params, tokens, *, ctx=None, cache=None,
            positions=None, chunked=None):
    """Returns (logits, new_cache). tokens: (B, T) int. ``positions``
    (B, T) are absolute positions (default arange; -1 marks dead cells);
    ``cache`` must be in the params' layout."""
    B, T = tokens.shape
    x = _embed(cfg, params, tokens, ctx)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)

    def run(kind, p, x, c, prefix):
        return block_apply(cfg, kind, p, x, positions, ctx=ctx, prefix=prefix,
                           cache=c, chunked=chunked)

    if "layers" in params:
        new_layers = []
        for i, kind in enumerate(cfg.layer_plan):
            c = cache["layers"][i] if cache is not None else None
            x, nc = run(kind, params["layers"][i], x, c, f"layer{i}")
            new_layers.append(nc)
        new_cache = {"layers": new_layers} if cache is not None else None
        return _head(cfg, params, x, ctx), new_cache

    per_pattern = [[] for _ in cfg.block_pattern]
    for s in range(cfg.n_super):
        for j, kind in enumerate(cfg.block_pattern):
            c = _layer(cache["scan"][j], s) if cache is not None else None
            x, nc = run(kind, _layer(params["scan"][j], s), x, c, "layer")
            per_pattern[j].append(nc)
    new_tail = []
    for i, kind in enumerate(cfg.tail_pattern):
        c = cache["tail"][i] if cache is not None else None
        x, nc = run(kind, params["tail"][i], x, c, "tail")
        new_tail.append(nc)
    new_cache = None
    if cache is not None:
        new_cache = {"scan": [_stack(ncs) for ncs in per_pattern],
                     "tail": new_tail}
    return _head(cfg, params, x, ctx), new_cache


def prefill(cfg: ModelConfig, params, tokens, cache, *, positions=None,
            ctx=None, chunked=None):
    """Fill the cache from a prompt; returns (last_logits, cache). Pads of
    a left-packed ragged prompt carry position -1 (masked, never written),
    so a packed request gets the same logits and cache lane as alone."""
    logits, cache = forward(cfg, params, tokens, ctx=ctx, cache=cache,
                            positions=positions, chunked=chunked)
    return logits[:, -1:], cache


def decode_step(cfg: ModelConfig, params, tokens, pos, cache, *, ctx=None):
    """One decode step. tokens/pos: (B, 1). Returns (logits, cache)."""
    return forward(cfg, params, tokens, positions=pos, cache=cache, ctx=ctx)

