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

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.attention import (
    AttnConfig, KVCache, PagedKVCache, PagedQuantKVCache, QuantKVCache,
    attention_block, init_attention_params, init_kv_cache,
    init_paged_kv_cache, init_paged_quant4_kv_cache,
    init_paged_quant_kv_cache, init_quant4_kv_cache, init_quant_kv_cache,
    reset_kv_lanes, reset_paged_lanes)
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
                prefix="layer", cache=None, chunked=None, block_table=None,
                append: bool = False):
    """One transformer block. Returns (x, new_cache)."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    h = _attn_input(cfg, p, x, ctx, prefix)
    attn_out, new_cache = attention_block(
        p["attn"], h, positions, attn_cfg_for(cfg, kind), ctx=ctx,
        prefix=f"{prefix}/attn", cache=cache, chunked=chunked,
        block_table=block_table, append=append)
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
    """Random weights from ``seed`` (the reference's distributions), on
    ``device`` (None: the GPU). Layers are drawn in layer order from one
    generator, so both layouts of one seed hold the same weights."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
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


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, kv_bits: int = 16,
                     paged_blocks: Optional[Tuple[int, int]] = None,
                     device=None):
    """One attention layer's cache: dense or paged (``paged_blocks`` =
    (num_blocks, block_size)), f32/bf16 (kv_bits 16), int8 (kv_bits 8) or
    nibble-packed int4 (kv_bits 4)."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(f"{kind!r} caches are not yet ported")
    if kv_bits not in (4, 8, 16):
        raise ValueError(f"kv_bits must be 4, 8 or 16, got {kv_bits}")
    acfg = attn_cfg_for(cfg, kind)
    if paged_blocks is not None:
        num_blocks, block_size = paged_blocks
        init = {4: init_paged_quant4_kv_cache,
                8: init_paged_quant_kv_cache}.get(kv_bits)
        if init is not None:
            return init(num_blocks, block_size, acfg, device)
        return init_paged_kv_cache(num_blocks, block_size, acfg, dtype,
                                   device)
    init = {4: init_quant4_kv_cache, 8: init_quant_kv_cache}.get(kv_bits)
    if init is not None:
        return init(batch, max_len, acfg, device)
    return init_kv_cache(batch, max_len, acfg, dtype, device)


def attn_write_spans(cfg: ModelConfig, max_len: int) -> List[int]:
    """Per attention layer, the distinct cache cells a lane can occupy:
    ``min(max_len, window)`` for ring layers, ``max_len`` for global."""
    spans = []
    for kind in cfg.layer_plan:
        if kind in ("attn", "local_attn"):
            w = attn_cfg_for(cfg, kind).window
            spans.append(min(max_len, w) if w else max_len)
    return spans


def paged_lane_blocks(cfg: ModelConfig, max_len: int,
                      block_size: int) -> int:
    """Block-table width per lane: ceil(max(write spans) / block_size)."""
    spans = attn_write_spans(cfg, max_len)
    if not spans:
        raise ValueError(f"{cfg.name}: no attention layers to page")
    return -(-max(spans) // block_size)


def attn_write_caps(cfg: ModelConfig, max_len: int,
                    block_size: int) -> List[int]:
    """The distinct paged write capacities (tokens) of the attention layers:
    ``min(table width * block_size, window)`` per layer (see
    attention.paged_capacity), sorted."""
    width = paged_lane_blocks(cfg, max_len, block_size)
    caps = set()
    for kind in cfg.layer_plan:
        if kind in ("attn", "local_attn"):
            w = attn_cfg_for(cfg, kind).window
            caps.add(min(width * block_size, w) if w else width * block_size)
    return sorted(caps)


def paged_ring_tokens(cfg: ModelConfig, max_len: int,
                      block_size: int) -> Optional[int]:
    """When every attention layer is a ring smaller than ``max_len``, the
    largest window: a lane never needs more cells however long it decodes.
    None for models with a global layer."""
    windows = []
    for kind in cfg.layer_plan:
        if kind in ("attn", "local_attn"):
            w = attn_cfg_for(cfg, kind).window
            if not w or w >= max_len:
                return None
            windows.append(w)
    return max(windows) if windows else None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               stacked: bool = True, dtype=torch.bfloat16, kv_bits: int = 16,
               paged: bool = False, block_size: int = 16,
               num_blocks: Optional[int] = None,
               mapped: Optional[bool] = None, device=None):
    """KV caches for every attention layer, in the params' layout, on
    ``device`` (None: the GPU). kv_bits 8 stores int8 caches, 4 nibble-packed
    int4 caches, 16 keeps ``dtype``.

    ``paged=True`` gives every layer one arena of ``num_blocks`` blocks of
    ``block_size`` cells (default: the worst case ``batch *
    paged_lane_blocks``) and puts one (batch, nb) ``"block_table"`` at the
    top of the dict, shared by every layer. ``mapped`` (default: True iff
    ``num_blocks`` was left at the worst case) maps the identity table —
    lane i owns blocks [i*nb, (i+1)*nb) — which makes the paged cache a
    drop-in for the dense one; pool-managed serving starts unmapped (-1)
    and lets ``runtime.block_pool.BlockPool`` own the table."""
    device = resolve_device(device)
    paged_blocks = None
    table = None
    if paged:
        nb_lane = paged_lane_blocks(cfg, max_len, block_size)
        if mapped is None:
            mapped = num_blocks is None
        if num_blocks is None:
            num_blocks = batch * nb_lane
        paged_blocks = (num_blocks, block_size)
        if mapped:
            if num_blocks < batch * nb_lane:
                raise ValueError(
                    f"mapped paged cache needs num_blocks >= "
                    f"batch*{nb_lane} = {batch * nb_lane}, got {num_blocks}")
            table = torch.arange(batch * nb_lane, dtype=torch.int32,
                                 device=device).reshape(batch, nb_lane)
        else:
            table = torch.full((batch, nb_lane), -1, dtype=torch.int32,
                               device=device)

    def blk(kind):
        return init_block_cache(cfg, kind, batch, max_len, dtype, kv_bits,
                                paged_blocks, device)

    if stacked:
        cache = {"scan": [_stack([blk(kind)] * cfg.n_super)
                          for kind in cfg.block_pattern],
                 "tail": [blk(kind) for kind in cfg.tail_pattern]}
    else:
        cache = {"layers": [blk(kind) for kind in cfg.layer_plan]}
    if paged:
        cache["block_table"] = table
    return cache


def _cache_nodes(cache):
    return (cache.get("layers") or
            list(cache.get("scan", [])) + list(cache.get("tail", [])))


def paged_block_bytes(cache) -> int:
    """Device bytes per physical block, summed over every paged arena of
    the cache (stacked leaves count all their layers)."""
    total = 0
    for node in _cache_nodes(cache):
        if isinstance(node, (PagedKVCache, PagedQuantKVCache)):
            n = node.pos.shape[-2]
            total += sum(t.numel() * t.element_size() for t in node) // n
    return total


def cache_reset_slots(cache, lane_mask):
    """Empty the masked lanes of a whole-model cache for slot reuse: every
    dense cache's ``pos`` becomes -1 on those lanes (stacked leaves carry
    the batch on axis 1), every paged arena empties the blocks those lanes
    map through the cache's block table. Other lanes are untouched."""
    table = cache.get("block_table")

    def reset(c, axis):
        if isinstance(c, (PagedKVCache, PagedQuantKVCache)):
            return reset_paged_lanes(c, lane_mask, table)
        if isinstance(c, (KVCache, QuantKVCache)):
            return reset_kv_lanes(c, lane_mask, batch_axis=axis)
        raise ValueError("cache_reset_slots: continuous batching supports "
                         f"attention caches only, got {type(c).__name__}")

    if "layers" in cache:
        out = {"layers": [reset(c, 0) for c in cache["layers"]]}
    else:
        out = {"scan": [reset(c, 1) for c in cache["scan"]],
               "tail": [reset(c, 0) for c in cache["tail"]]}
    if table is not None:
        out["block_table"] = table
    return out


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
            positions=None, chunked=None, append: bool = False):
    """Returns (logits, new_cache). tokens: (B, T) int. ``positions``
    (B, T) are absolute positions (default arange; -1 marks dead cells);
    ``cache`` must be in the params' layout; its ``"block_table"`` (paged
    caches) goes to every layer and comes back unchanged. ``append``:
    chunked prefill (see models.attention.attention_block)."""
    B, T = tokens.shape
    x = _embed(cfg, params, tokens, ctx)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)

    block_table = cache.get("block_table") if cache is not None else None

    def run(kind, p, x, c, prefix):
        return block_apply(cfg, kind, p, x, positions, ctx=ctx, prefix=prefix,
                           cache=c, chunked=chunked, block_table=block_table,
                           append=append)

    def with_table(new_cache):
        if block_table is not None:
            new_cache["block_table"] = block_table
        return new_cache

    if "layers" in params:
        new_layers = []
        for i, kind in enumerate(cfg.layer_plan):
            c = cache["layers"][i] if cache is not None else None
            x, nc = run(kind, params["layers"][i], x, c, f"layer{i}")
            new_layers.append(nc)
        new_cache = (with_table({"layers": new_layers})
                     if cache is not None else None)
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
        new_cache = with_table({"scan": [_stack(ncs)
                                         for ncs in per_pattern],
                                "tail": new_tail})
    return _head(cfg, params, x, ctx), new_cache


def prefill(cfg: ModelConfig, params, tokens, cache, *, positions=None,
            ctx=None, chunked=None, append: bool = False):
    """Fill the cache from a prompt; returns (last_logits, cache). Pads of
    a left-packed ragged prompt carry position -1 (masked, never written),
    so a packed request gets the same logits and cache lane as alone.
    ``append=True`` appends the tokens as one chunk at each lane's position
    (chunked prefill): a prompt split into chunks fills the cache and emits
    its last-token logits as a monolithic prefill does."""
    logits, cache = forward(cfg, params, tokens, ctx=ctx, cache=cache,
                            positions=positions, chunked=chunked,
                            append=append)
    return logits[:, -1:], cache


def decode_step(cfg: ModelConfig, params, tokens, pos, cache, *, ctx=None):
    """One decode step. tokens/pos: (B, 1). Returns (logits, cache)."""
    return forward(cfg, params, tokens, positions=pos, cache=cache, ctx=ctx)

