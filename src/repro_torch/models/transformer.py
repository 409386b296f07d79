"""Decoder-only transformer for the ported families (port of
``repro.models.transformer``): the attention decoders (dense, GQA / MQA,
sliding-window, soft-capping, QK-norm, GLU or MLP FFN, MoE), the hybrid
RG-LRU (Griffin) and the attention-free RWKV-6, with the paper's
quantization sites threaded through. A modality front end's embeddings
(``forward(embeds=)``) are prepended to the token embeddings.

Two parameter layouts share the same block function:
  * stacked — ``params["scan"]``: one dict per position of
    ``cfg.block_pattern`` whose leaves carry a leading axis over the
    pattern's repeats (the reference's ``lax.scan`` layout; here a Python
    loop slices layer after layer). Sites use the shared ``layer/...``
    names, so one calibration serves every layer.
  * unrolled — ``params["layers"]``: a flat per-layer list with per-layer
    site names ``layer{i}/...`` (calibration, per-layer experiments).

Training (``train_loss``, ``forward(remat=True)``): the cache-free
forward unbinds every stacked leaf once (``_unstack``), so autograd adds
the layers' gradients back with one ``stack`` instead of a zeroed
stack-sized buffer per layer; ``remat`` recomputes each block (unrolled) or
superblock (stacked) in the backward pass, the reference's
``jax.checkpoint`` granularity. Under a rank mesh (``train_loss(dist=)``)
a rank runs its data-parallel rows of the batch on its placed params:
each layer gathers the dims ``parallel.sharding`` puts on the FSDP axis
inside the remat region (the backward gathers again, and the gathers'
gradients are reduce-scattered over the FSDP axis), the embedding table
once for the lookup and the tied head; attention runs on the rank's heads
and the FFN on its hidden slice (``model`` axis, Megatron's f / g pairs of
``parallel.collectives``), and the logits stay vocab-sharded through the
cross-entropy (a logsumexp and the gold logit summed over ``model``).

Quantization sites per block (paper Fig. 1 / Table 2 naming):
  {L}/attn_in, {L}/residual_attn, {L}/ffn_in, {L}/ffn_out,
  {L}/residual_ffn, plus the attention and FFN internal sites, and
  embed/sum, head/logits. A ``rec`` block has no attn_in (its ln1 is a
  plain norm) and adds ``{L}/rec/lru_out``; an ``rwkv`` block keeps only the
  two residual sites of its own and adds the time-mix (``{L}/tmix/r``,
  ``k``, ``v``, ``out``) and channel-mix (``{L}/cmix/ffn_in``, ``ffn_out``)
  sites.

Recurrent state (``RGLRUState``, ``RWKVState``) is a cache like the KV
caches: the steps write it in place. It has no per-lane validity, no block
layout and cannot replay earlier chunks, so the continuous scheduler, the
paged caches and chunked (append) prefill refuse it, as the reference
does; these families serve through the static scheduler on dense caches.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.attention import (
    AttnConfig, KVCache, PagedKVCache, PagedQuantKVCache, QuantKVCache,
    attention_block, init_attention_params, init_kv_cache,
    init_paged_kv_cache, init_paged_quant4_kv_cache,
    init_paged_quant_kv_cache, init_quant4_kv_cache, init_quant_kv_cache,
    reset_kv_lanes, reset_paged_lanes)
from repro_torch.models.common import cross_entropy, embed_init, \
    layer_norm, matmul_dtype, resolve_weight, rms_norm, softcap
from repro_torch.parallel import collectives as coll

ATTN_KINDS = ("attn", "local_attn")


# ---------------------------------------------------------------------------
# Distribution context (the rules live in repro_torch.parallel)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where a sharded forward runs: ``mesh`` (a ``launch.mesh`` mesh; a
    ``RankMesh`` to execute), the tensor-parallel, FSDP and data-parallel
    axes, and the reference's perf switches. ``kv_seq_shard`` picks the
    cache placement: the reference's default, every KV cache's sequence
    dim on ``model`` (True), or the KV heads (False); the port executes
    both."""
    mesh: Any
    tp_axis: str = "model"
    fsdp_axis: Any = "data"                  # str or tuple (pod FSDP)
    dp_axes: Tuple[str, ...] = ("data",)     # ("pod","data") multi-pod
    onehot_embed: bool = False               # vocab-sharded one-hot lookup
    quantized_gathers: bool = False          # int8 FSDP weight gathers
    kv_seq_shard: bool = True

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]


def check_tp(cfg: ModelConfig, dist: Optional[DistContext],
             training: bool = False) -> None:
    """Raise "... is not yet ported under --tp / dist" for a config the
    sharded forward cannot run on ``dist``'s mesh: recurrent and
    encoder-decoder configs, FFN width or vocabulary that the ``model``
    axis does not divide, MoE experts whose count and d_ff it both does
    not divide or with int8 FSDP gathers (``quantized_gathers``), and,
    with the caches on their KV heads (``kv_seq_shard=False``), KV heads
    it does not divide. With the caches on the sequence dim (the default)
    every rank attends over its cells for all heads, so any KV head count
    serves (MQA: granite-20b). MoE blocks serve expert-parallel (E/N
    experts a rank) or, where N does not divide E, in the hybrid mode
    (every expert on a d_ff slice). Serving refuses a data axis over more
    than one rank; ``training`` (the cache-free forward of
    ``train_loss``) takes one (FSDP and data parallelism) but attends on
    the rank's heads, so it refuses KV heads the ``model`` axis does not
    divide, and MoE routed over the whole batch (the reference's
    unsharded MoE under a mesh with one ``model`` rank)."""
    if dist is None:
        return
    n = dist.tp_size
    moe = cfg.moe
    why = None
    if moe is not None and moe.num_experts % n and moe.d_ff % n:
        why = (f"{cfg.name}'s {moe.num_experts} experts of d_ff "
               f"{moe.d_ff} on {n} ranks")
    elif moe is not None and dist.quantized_gathers:
        why = "int8 FSDP weight gathers (quantized_gathers) of MoE experts"
    elif cfg.encoder_layers:
        why = f"{cfg.name}'s encoder-decoder"
    elif any(k not in ATTN_KINDS for k in cfg.layer_plan):
        why = f"{cfg.name}'s recurrent blocks"
    elif not dist.kv_seq_shard and cfg.num_kv_heads % n:
        why = (f"{cfg.name}'s {cfg.num_kv_heads} KV heads on {n} ranks "
               "(caches on KV heads, kv_seq_shard=False)")
    elif cfg.d_ff % n or cfg.vocab_size % n:
        why = (f"{cfg.name}'s d_ff {cfg.d_ff} / vocab {cfg.vocab_size} on "
               f"{n} ranks")
    elif dist.mesh.size != n and not training:
        why = (f"a data axis over more than one rank in serving (a mesh "
               f"with more than the model axis: {dist.mesh!r})")
    elif training and cfg.num_kv_heads % n:
        why = (f"{cfg.name}'s {cfg.num_kv_heads} KV heads on {n} ranks in "
               "training (attention on the rank's heads)")
    elif training and moe is not None and n == 1 and dist.mesh.size > 1:
        why = (f"{cfg.name}'s MoE routed over the whole batch on a mesh "
               f"with one model rank ({dist.mesh!r})")
    if why is not None:
        raise NotImplementedError(f"{why} is not yet ported under --tp / "
                                  "dist")


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["g"], p["b"])
    return rms_norm(x, p["g"])


def _check_kind(kind: str):
    if kind not in ATTN_KINDS + ("rec", "rwkv"):
        raise ValueError(f"unknown block kind {kind!r}")


def _init_norm(cfg: ModelConfig, dtype, device):
    if cfg.norm == "layernorm":
        return {"g": torch.ones((cfg.d_model,), dtype=dtype, device=device),
                "b": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    return {"g": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def attn_cfg_for(cfg: ModelConfig, kind: str) -> AttnConfig:
    window = cfg.local_window if kind == "local_attn" else cfg.window
    return AttnConfig(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.hd, causal=True, window=window,
                      logit_softcap=cfg.attn_logit_softcap,
                      rope_theta=cfg.rope_theta)


def _ffn_apply(cfg: ModelConfig, p, x, *, ctx, prefix, dist=None):
    """The block's FFN: MoE over the flattened (B*T, D) tokens (which
    route together, so the experts' capacity counts every token of the
    call; with ``dist`` expert-parallel, :func:`_moe_sharded`, without the
    ctx as in the reference), else the GLU or the MLP (``dist``:
    tensor-parallel, see models.ffn)."""
    if cfg.moe is not None:
        if coll.tp_size(dist) > 1:
            return _moe_sharded(cfg, p, x, dist)
        B, T, D = x.shape
        out = moe_lib.moe_apply(p, x.reshape(B * T, D), cfg.moe, ctx=ctx,
                                prefix=prefix)
        return out.reshape(B, T, D)
    if cfg.ffn_type == "glu":
        return ffn_lib.glu_mlp(p, x, activation=cfg.act, ctx=ctx,
                               prefix=prefix, dist=dist)
    return ffn_lib.mlp(p, x, activation=cfg.act, ctx=ctx, prefix=prefix,
                       dist=dist)


def _moe_sharded(cfg: ModelConfig, p, x, dist: DistContext):
    """The reference's expert-parallel MoE (its ``shard_map``) on this
    rank: the flattened (B*T, D) tokens of the rank (its data-parallel
    rows: each dp shard routes, and is cut to capacity, on its own
    tokens, as in the reference), through
    :func:`moe_lib.moe_apply_sharded`. ``p`` is the rank's slice as
    ``param_spec_for`` places it, its FSDP dims gathered (the forward
    gathers every layer's): E/N experts where N divides E (expert
    parallelism), else every expert on a d_ff slice (hybrid)."""
    if dist.quantized_gathers:
        raise NotImplementedError("int8 FSDP weight gathers "
                                  "(quantized_gathers) of MoE experts are "
                                  "not yet ported under --tp / dist")
    mcfg, n = cfg.moe, coll.tp_size(dist)
    expert_parallel = mcfg.num_experts % n == 0
    want = ((mcfg.num_experts // n, mcfg.d_ff) if expert_parallel
            else (mcfg.num_experts, mcfg.d_ff // n))
    wg = p["w_gate"]["q"] if isinstance(p["w_gate"], dict) else p["w_gate"]
    got = (wg.shape[-3], wg.shape[-1])
    if got != want:
        raise ValueError(f"the rank's experts are {got} (experts, d_ff), "
                         f"not its slice {want}: place the params with "
                         "parallel.sharding.make_param_shardings")
    B, T, D = x.shape
    out = moe_lib.moe_apply_sharded(p, x.reshape(B * T, D), mcfg, dist=dist,
                                    expert_parallel=expert_parallel)
    return out.reshape(B, T, D)


def _init_ffn(cfg: ModelConfig, gen, dtype, device):
    init = (ffn_lib.init_glu_params if cfg.ffn_type == "glu"
            else ffn_lib.init_mlp_params)
    return init(gen, cfg.d_model, cfg.d_ff, dtype, device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn_packed(p) -> bool:
    ffn = p.get("ffn")
    return isinstance(ffn, dict) and ffn_lib.is_packed(ffn)


def _attn_packed(p) -> bool:
    from repro_torch.core import deploy
    attn = p.get("attn")
    return isinstance(attn, dict) and deploy.is_packed(attn.get("wq"))


def _ffn_input(cfg: ModelConfig, p, x, ctx, prefix):
    """LN2 + the ffn_in quantizer; in DEPLOY with packed FFN weights they
    fuse into one norm + int8 emit kernel returning a QTensor (with quant
    telemetry armed, the site's vector is taken on a PyTorch norm first:
    ``deploy.site_stats``)."""
    if ctx is not None:
        aq = ctx.deploy_act(f"{prefix}/ffn_in")
        if aq is not None and _ffn_packed(p):
            from repro_torch.core import deploy
            if ctx.telemetry is not None:
                ctx.telem_site(f"{prefix}/ffn_in",
                               deploy.site_stats(_norm(cfg, p["ln2"], x), aq))
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
            if ctx.telemetry is not None:
                ctx.telem_site(f"{prefix}/attn_in",
                               deploy.site_stats(_norm(cfg, p["ln1"], x), aq))
            return deploy.norm_quantize(cfg.norm, p["ln1"], x, aq)
    h = _norm(cfg, p["ln1"], x)
    if ctx is not None:
        h = ctx.act_in(f"{prefix}/attn_in", h)
    return h


def _write_state(cache, new):
    """Write a block's new recurrent state into its cache in place (the
    cache's leaves may be views of a stacked layer slice)."""
    for dst, src in zip(cache, new):
        if dst is not src:
            dst.copy_(src)
    return cache


def _residual_ffn(cfg, p, x, ctx, prefix, post_norm, dist=None):
    """The FFN half of an attention or ``rec`` block: ln2 (+ ffn_in, fused
    in DEPLOY), the FFN, ``post_ln2`` with ``post_norm`` (attention blocks
    only, as in the reference), ffn_out and the residual sum."""
    h = _ffn_input(cfg, p, x, ctx, prefix)
    ffn_out = _ffn_apply(cfg, p.get("moe", p.get("ffn")), h, ctx=ctx,
                         prefix=f"{prefix}/ffn", dist=dist)
    if post_norm:
        ffn_out = _norm(cfg, p["post_ln2"], ffn_out)
    if ctx is not None:
        ffn_out = ctx.act(f"{prefix}/ffn_out", ffn_out)
    x = x + ffn_out
    if ctx is not None:
        x = ctx.act(f"{prefix}/residual_ffn", x)
    return x


def _recurrent_block_apply(cfg, kind, p, x, *, ctx, prefix, cache):
    """A ``rec`` (RG-LRU + FFN) or ``rwkv`` (time-mix + channel-mix)
    block; the state, if any, is written back in place."""
    h = _norm(cfg, p["ln1"], x)
    if kind == "rec":
        out, st = rglru_lib.recurrent_block(p["rec"], h, state=cache,
                                            ctx=ctx, prefix=f"{prefix}/rec")
    else:
        out, st = rwkv_lib.time_mix(p["tmix"], h, cfg.rwkv_head_size,
                                    state=cache, ctx=ctx,
                                    prefix=f"{prefix}/tmix")
    x = x + out
    if ctx is not None:
        x = ctx.act(f"{prefix}/residual_attn", x)
    if kind == "rec":
        x = _residual_ffn(cfg, p, x, ctx, prefix, post_norm=False)
    else:
        h = _norm(cfg, p["ln2"], x)
        out, st = rwkv_lib.channel_mix(p["cmix"], h, state=st, ctx=ctx,
                                       prefix=f"{prefix}/cmix")
        x = x + out
        if ctx is not None:
            x = ctx.act(f"{prefix}/residual_ffn", x)
    if cache is not None:
        _write_state(cache, st)
    return x, cache


def block_apply(cfg: ModelConfig, kind: str, p, x, positions, *, ctx=None,
                prefix="layer", cache=None, chunked=None, block_table=None,
                append: bool = False, write_plans=None, dist=None):
    """One transformer block. Returns (x, cache), the cache written in
    place (``write_plans``: see models.attention.attention_block). With
    ``dist`` the block runs tensor-parallel on this rank's slice of the
    params and of the cache (models.attention, models.ffn); its output is
    whole on every rank."""
    _check_kind(kind)
    if append and kind not in ATTN_KINDS:
        raise ValueError(
            f"chunked (append) prefill supports attention blocks only, got "
            f"{kind!r} (recurrent state cannot replay earlier chunks)")
    if kind not in ATTN_KINDS:
        if coll.tp_size(dist) > 1:
            raise NotImplementedError("recurrent blocks are not yet ported "
                                      "under --tp / dist")
        return _recurrent_block_apply(cfg, kind, p, x, ctx=ctx,
                                      prefix=prefix, cache=cache)
    h = _attn_input(cfg, p, x, ctx, prefix)
    attn_out, new_cache = attention_block(
        p["attn"], h, positions, attn_cfg_for(cfg, kind), ctx=ctx,
        prefix=f"{prefix}/attn", cache=cache, chunked=chunked,
        block_table=block_table, append=append, write_plans=write_plans,
        dist=dist)
    if cfg.post_norm:
        attn_out = _norm(cfg, p["post_ln1"], attn_out)
    x = x + attn_out
    if ctx is not None:
        x = ctx.act(f"{prefix}/residual_attn", x)
    return (_residual_ffn(cfg, p, x, ctx, prefix, cfg.post_norm, dist),
            new_cache)


def init_block_params(cfg: ModelConfig, kind: str, gen, dtype, device):
    _check_kind(kind)
    p: Dict[str, Any] = {"ln1": _init_norm(cfg, dtype, device),
                         "ln2": _init_norm(cfg, dtype, device)}
    if kind == "rwkv":
        tm = rwkv_lib.init_rwkv_params(gen, cfg.d_model, cfg.d_ff,
                                       cfg.rwkv_head_size, dtype, device)
        p["tmix"] = {k: v for k, v in tm.items()
                     if not k.startswith(("w_c", "mu_c"))}
        p["cmix"] = {k: v for k, v in tm.items()
                     if k.startswith(("w_c", "mu_c"))}
        return p
    if kind == "rec":
        p["rec"] = rglru_lib.init_recurrent_params(
            gen, cfg.d_model, cfg.d_rnn or cfg.d_model, dtype, device)
        p["ffn"] = _init_ffn(cfg, gen, dtype, device)
        return p
    p["attn"] = init_attention_params(gen, cfg.d_model,
                                      attn_cfg_for(cfg, kind), dtype, device,
                                      qk_norm=cfg.qk_norm)
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe_params(gen, cfg.d_model, cfg.moe, dtype,
                                           device)
    else:
        p["ffn"] = _init_ffn(cfg, gen, dtype, device)
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


def _unstack(tree, n: int) -> list:
    """The ``n`` layer slices of a stacked tree, every leaf unbound once
    (one ``stack`` in the backward pass, where ``n`` selects would each add
    into a zeroed buffer the size of the whole stack)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        if hasattr(tree, "_fields"):
            return [type(tree)(*(p[s] for p in parts)) for s in range(n)]
        return [type(tree)(p[s] for p in parts) for s in range(n)]
    return list(torch.unbind(tree))


def clone_cache(cache):
    """A copy of a whole-model cache (every leaf cloned, the block table
    too): the steps write their cache in place, so a caller that runs a
    step and still needs the cache as it was runs the step on a clone."""
    return _map(torch.clone, cache)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, stacked: bool = True,
                dtype=torch.bfloat16, device=None):
    """Random weights from ``seed`` (the reference's distributions), on
    ``device`` (None: the GPU; ``"meta"``: shapes and dtypes only). Layers
    are drawn in layer order from one generator, so both layouts of one
    seed hold the same weights."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta"
                          else device).manual_seed(seed)
    plan = cfg.layer_plan
    n_pat = len(cfg.block_pattern)
    n_body = len(plan) - len(cfg.tail_pattern)
    layers, scan = [], [None] * n_pat
    for i, kind in enumerate(plan):
        p = init_block_params(cfg, kind, gen, dtype, device)
        if not stacked or i >= n_body:
            layers.append(p)
            continue
        # stacked: each layer is copied into its slot as it is drawn, so
        # the stack never holds a second copy of the whole body
        j, s = i % n_pat, i // n_pat
        if scan[j] is None:
            scan[j] = _map(lambda x: x.new_empty((cfg.n_super, *x.shape)), p)
        _map(lambda dst, x: dst[s].copy_(x), scan[j], p)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": _init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        # (d, V), contiguous: the reference's embed_init(...).T
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device).T.contiguous()
    if not stacked:
        params["layers"] = layers
        return params
    params["scan"] = scan
    params["tail"] = layers
    return params


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, kv_bits: int = 16,
                     paged_blocks: Optional[Tuple[int, int]] = None,
                     device=None):
    """One layer's cache. Attention: dense or paged (``paged_blocks`` =
    (num_blocks, block_size)), f32/bf16 (kv_bits 16), int8 (kv_bits 8) or
    nibble-packed int4 (kv_bits 4). ``rec`` / ``rwkv``: the f32 recurrent
    state, whatever ``kv_bits`` (paged raises, as in the reference)."""
    _check_kind(kind)
    if kv_bits not in (4, 8, 16):
        raise ValueError(f"kv_bits must be 4, 8 or 16, got {kv_bits}")
    if kind not in ATTN_KINDS:
        if paged_blocks is not None:
            raise ValueError(
                f"paged KV cache supports attention layers only, got "
                f"{kind!r} (recurrent state has no block layout)")
        dev = resolve_device(device)
        if kind == "rec":
            return rglru_lib.init_rglru_state(batch, cfg.d_rnn or cfg.d_model,
                                              device=dev)
        return rwkv_lib.init_rwkv_state(batch, cfg.d_model,
                                        cfg.rwkv_head_size, device=dev)
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
        if kind in ATTN_KINDS:
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
        if kind in ATTN_KINDS:
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
        if kind in ATTN_KINDS:
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
    """KV caches for every attention layer (and the recurrent state of every
    ``rec`` / ``rwkv`` layer), in the params' layout, on ``device`` (None:
    the GPU). kv_bits 8 stores int8 caches, 4 nibble-packed
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
    """Empty the masked lanes of a whole-model cache for slot reuse, in
    place: every dense cache's ``pos`` becomes -1 on those lanes (stacked
    leaves carry the batch on axis 1), every paged arena empties the blocks
    those lanes map through the cache's block table. Other lanes are
    untouched. Returns ``cache``."""
    table = cache.get("block_table")

    def reset(c, axis):
        if isinstance(c, (PagedKVCache, PagedQuantKVCache)):
            return reset_paged_lanes(c, lane_mask, table)
        if isinstance(c, (KVCache, QuantKVCache)):
            return reset_kv_lanes(c, lane_mask, batch_axis=axis)
        raise ValueError("cache_reset_slots: continuous batching supports "
                         f"attention caches only, got {type(c).__name__} "
                         "(recurrent state has no per-slot validity to "
                         "reset)")

    for c in cache.get("layers", []) + cache.get("tail", []):
        reset(c, 0)
    for c in cache.get("scan", []):
        reset(c, 1)
    return cache


def cache_copy_block(cache, src, dst):
    """Copy physical block ``src``'s payload (K/V, scales, positions) into
    block ``dst`` in every paged arena of a whole-model cache, in place:
    the device half of the scheduler's copy-on-write (the pool swaps a
    shared table entry for a fresh private block, this clones the shared
    payload so the lane's next writes land in its own copy). Stacked
    leaves carry the block axis at position 1, tail and unrolled leaves at
    position 0. ``src`` / ``dst`` are Python ints or 0-d device tensors,
    one code path for both (device ids cost no host sync). Counts its
    calls in ``cache_copy_block.calls``. Returns ``cache``."""
    cache_copy_block.calls += 1
    nodes = [(c, 0) for c in cache.get("layers", []) + cache.get("tail", [])]
    nodes += [(c, 1) for c in cache.get("scan", [])]
    ids = {}
    for c, axis in nodes:
        if not isinstance(c, (PagedKVCache, PagedQuantKVCache)):
            raise ValueError("cache_copy_block: paged caches only, got "
                             f"{type(c).__name__}")
        dev = c.pos.device
        if dev not in ids:
            ids[dev] = tuple(torch.as_tensor(b, dtype=torch.long,
                                             device=dev).reshape(1)
                             for b in (src, dst))
        s, d = ids[dev]
        for x in c:
            x.index_copy_(axis, d, x.index_select(axis, s))
    return cache


cache_copy_block.calls = 0


def _paged_nodes(cache, what):
    """(key, index, arena, block axis) of every paged arena of a
    whole-model cache: stacked scan leaves carry the block axis at
    position 1, tail and unrolled leaves at 0. Raises on any other cache
    type, as the reference does."""
    out = []
    for key, axis in (("layers", 0), ("scan", 1), ("tail", 0)):
        for i, c in enumerate(cache.get(key, [])):
            if not isinstance(c, (PagedKVCache, PagedQuantKVCache)):
                raise ValueError(f"{what}: paged caches only, got "
                                 f"{type(c).__name__}")
            out.append((key, i, c, axis))
    return out


def cache_gather_blocks(cache, ids):
    """The payload of physical blocks ``ids`` in every paged arena of a
    whole-model cache (the device half of a swap-out): the cache's layout
    and arena types (an int4 arena stays a ``PagedQuant4KVCache``) with the
    block axis cut to ``len(ids)`` rows, on the cache's device, and no
    ``block_table``. ``ids`` (a 1-D tensor or sequence) are the lane's live
    blocks; a repeated id gathers the same row twice, so ids padded by
    repeating the first one round-trip through
    :func:`cache_scatter_blocks` unchanged."""
    out = {key: [] for key in ("layers", "scan", "tail") if key in cache}
    for key, i, c, axis in _paged_nodes(cache, "cache_gather_blocks"):
        idx = torch.as_tensor(ids, device=c.pos.device).long()
        out[key].append(type(c)(*(x.index_select(axis, idx) for x in c)))
    return out


def cache_scatter_blocks(cache, ids, payload):
    """Write a :func:`cache_gather_blocks` ``payload`` into physical blocks
    ``ids`` of every paged arena, in place (the device half of a swap-in;
    ``ids`` are the lane's newly allocated blocks, in the gather's order).
    The payload must lie on the cache's device; with ``ids`` there too
    nothing waits for the device. Duplicate ids must carry equal rows (as
    a padded gather gives them): ``index_copy_`` writes duplicates in no
    defined order. Returns ``cache``."""
    for key, i, c, axis in _paged_nodes(cache, "cache_scatter_blocks"):
        idx = torch.as_tensor(ids, device=c.pos.device).long()
        for x, v in zip(c, payload[key][i]):
            x.index_copy_(axis, idx, v)
    return cache


def _dense_nodes(cache, what):
    """(key, index, cache, batch axis) of every attention cache of a dense
    whole-model cache: stacked scan leaves carry the batch at position 1,
    tail and unrolled leaves at 0. Raises on paged caches and on any other
    cache type with the reference's messages."""
    if "block_table" in cache:
        use = ("cache_gather_blocks" if what == "cache_extract_lane"
               else "cache_scatter_blocks")
        raise ValueError(f"{what}: paged caches carry no batch axis — use "
                         f"{use} on the lane's mapped block ids")
    out = []
    for key, axis in (("layers", 0), ("scan", 1), ("tail", 0)):
        for i, c in enumerate(cache.get(key, [])):
            if not isinstance(c, (KVCache, QuantKVCache)):
                raise ValueError(f"{what}: dense attention caches only, got "
                                 f"{type(c).__name__}")
            out.append((key, i, c, axis))
    return out


def cache_extract_lane(cache, lane: int):
    """A copy of batch lane ``lane`` of a dense whole-model cache (the
    device half of the engine's decomposed ``prefill``): the cache's layout
    and types (an int4 cache stays a ``Quant4KVCache``) with the batch axis
    cut to 1, every leaf (positions and scales too) a fresh tensor. A copy,
    not a view: the engine prefills the next request into the same scratch
    cache in place. Paged caches have no per-lane batch axis: their lane
    payloads are :func:`cache_gather_blocks` over the lane's block ids."""
    out = {key: [] for key in ("layers", "scan", "tail") if key in cache}
    for key, i, c, axis in _dense_nodes(cache, "cache_extract_lane"):
        out[key].append(type(c)(*(x.narrow(axis, lane, 1).clone()
                                  for x in c)))
    return out


def cache_insert_lane(cache, lane: int, payload):
    """Write a :func:`cache_extract_lane` payload into batch lane ``lane``
    of a dense whole-model cache, in place (the device half of the
    engine's ``insert``). The payload covers every cell of the lane (the
    prompt's K/V and the -1 dead cells), so the write overwrites the whole
    lane: the slot's previous occupant needs no reset, every other lane's
    bytes stay as they were, and the cache keeps its addresses. Returns
    ``cache``."""
    for key, i, c, axis in _dense_nodes(cache, "cache_insert_lane"):
        for x, v in zip(c, payload[key][i]):
            x.narrow(axis, lane, 1).copy_(v)
    return cache


def weight_reads(cfg: ModelConfig, params):
    """(site, weight) of every float weight the forward hands to
    ``ctx.weight``, in its order and as it reads them: the attention and
    FFN projections of each layer (views of a stacked leaf's slice) and
    the head (``embed.T`` when tied). Packed and stored-int8 leaves are
    not float weights and are left out."""
    def block(kind, p, prefix):
        groups = [("attn", ("wq", "wk", "wv", "wo"))] \
            if kind in ATTN_KINDS else []
        groups.append(("ffn", ("w_gate", "w_up", "w_in", "w_out")))
        for key, names in groups:
            sub = p.get(key)
            if not isinstance(sub, dict):
                continue
            for name in names:
                w = sub.get(name)
                if isinstance(w, torch.Tensor):
                    yield f"{prefix}/{key}/{name}", w

    if "layers" in params:
        for i, kind in enumerate(cfg.layer_plan):
            yield from block(kind, params["layers"][i], f"layer{i}")
    else:
        for s in range(cfg.n_super):
            for j, kind in enumerate(cfg.block_pattern):
                yield from block(kind, _layer(params["scan"][j], s), "layer")
        for i, kind in enumerate(cfg.tail_pattern):
            yield from block(kind, params["tail"][i], "tail")
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, torch.Tensor):
        yield "head/w", head.T if cfg.tie_embeddings else head


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens, embeds, ctx, dist=None):
    """Token embeddings (+ front-end embeddings). With ``dist`` the table
    holds this rank's vocab rows: a masked local lookup (or, with
    ``onehot_embed``, a one-hot product over the local rows) and a sum
    over ``model``, which equals the whole lookup bit for bit (one rank
    holds each row)."""
    table = resolve_weight(params["embed"])
    if coll.tp_size(dist) > 1:
        n_local = table.shape[0]
        local = tokens.long() - coll.tp_index(dist) * n_local
        mine = (local >= 0) & (local < n_local)
        local = torch.where(mine, local, torch.zeros_like(local))
        if dist.onehot_embed and tokens.numel() <= 4096:
            oh = torch.nn.functional.one_hot(local, n_local).to(table.dtype)
            x = torch.einsum("btv,vd->btd", oh * mine[..., None], table)
        else:
            x = torch.where(mine[..., None], table[local],
                            torch.zeros((), dtype=table.dtype,
                                        device=table.device))
        x = coll.sum_over(x, dist)
    else:
        x = table[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if embeds is not None:
        # the modality front end's precomputed patch / frame embeddings
        # are prepended to the token embeddings
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    if ctx is not None:
        x = ctx.act("embed/sum", x)
    return x


def _head(cfg: ModelConfig, params, x, ctx, dist=None,
          gather: bool = True):
    """Final norm and logits. With ``dist`` the head weight holds this
    rank's vocab slice: its logits, soft-capped and through the
    ``head/logits`` site, are gathered over ``model`` (bit for bit), so
    every rank returns the whole logits and greedy decoding picks the same
    lowest-index argmax on each; ``gather=False`` returns the rank's vocab
    slice (the training loss reduces over it)."""
    h = coll.copy_to(_norm(cfg, params["final_norm"], x), dist)
    dt = matmul_dtype(h)
    w = resolve_weight(params["embed"], dt).T if cfg.tie_embeddings \
        else resolve_weight(params["lm_head"], dt)
    if ctx is not None:
        w = ctx.weight("head/w", w)
    logits = softcap(h @ w.to(h.dtype), cfg.final_logit_softcap)
    if ctx is not None:
        logits = ctx.act("head/logits", logits)
        if coll.tp_size(dist) > 1:
            ctx.mark_cut("head/logits")
    return coll.gather_from(logits, dist, dim=-1) if gather else logits


@contextlib.contextmanager
def _quiet(ctx):
    """The ctx with its records switched off: quant telemetry, range
    statistics and calibration tensors go to throwaway containers. A
    rematerialized block runs its forward again in the backward pass, and
    must not record its sites a second time (the reference traces the
    block once)."""
    saved = (ctx.telemetry, ctx.range_states, ctx.calib_tensors)
    ctx.telemetry = None
    ctx.range_states = dict(ctx.range_states)
    ctx.calib_tensors = {}
    try:
        yield
    finally:
        ctx.telemetry, ctx.range_states, ctx.calib_tensors = saved


def _remat(fn, ctx, *args):
    """``fn(*args)`` under activation checkpointing (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``): only its inputs are
    kept, and its forward runs again, without recording (:func:`_quiet`),
    when the backward pass reaches it."""
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or ctx is None:
            return fn(*a)
        with _quiet(ctx):
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False)


def _fsdp_dims(cfg: ModelConfig, params, dist: Optional[DistContext]):
    """A tree like ``params`` holding, for each leaf, the dims its spec
    puts on the FSDP axis (``parallel.sharding.param_shardings``); None
    where the FSDP axis has one rank."""
    if dist is None or coll.size(dist, dist.fsdp_axis) == 1:
        return None
    from repro_torch.parallel.sharding import param_shardings
    fsdp = dist.fsdp_axis
    return _map(lambda sh: tuple(d for d, e in enumerate(sh.spec)
                                 if e == fsdp),
                param_shardings(cfg, params, dist))


def _fsdp_gathered(tree, dims, dist, lead: int = 0):
    """``tree`` with every leaf's FSDP dims gathered whole
    (``collectives.fsdp_gather``; ``lead``: the stacked dims the leaves
    of ``tree`` lost against ``dims``'s)."""
    if dims is None:
        return tree

    def whole(x, ds):
        for d in ds:
            x = coll.fsdp_gather(x, dist, d - lead)
        return x
    return _map(whole, tree, dims)


def forward(cfg: ModelConfig, params, tokens, *, embeds=None, ctx=None,
            cache=None, positions=None, chunked=None, append: bool = False,
            remat: bool = False, dist: Optional[DistContext] = None,
            vocab_parallel: bool = False):
    """Returns (logits, cache). tokens: (B, T) int; ``embeds`` (B, N, D)
    front-end embeddings are prepended to them (logits then cover N + T
    positions). ``positions`` (B, N + T) are absolute positions (default
    arange; -1 marks dead cells);
    ``cache`` must be in the params' layout and is written in place (each
    layer gets a view of its slice of the stacked leaves) and returned:
    a caller that needs the cache as it was clones it first. Its
    ``"block_table"`` (paged caches) goes to every layer unchanged.
    ``append``: chunked prefill (see models.attention.attention_block).
    ``remat`` (with autograd on, no cache): recompute each block (unrolled)
    or superblock (stacked) in the backward pass. ``dist``: the
    tensor-parallel forward of one rank over its placed params and cache
    (``parallel.sharding``); the logits are whole on every rank, or the
    rank's vocab slice with ``vocab_parallel``. Without a cache (training)
    ``tokens`` are the rank's data-parallel rows and the leaves' FSDP dims
    are gathered layer by layer."""
    check_tp(cfg, dist, training=cache is None)
    B = tokens.shape[0]
    dims = _fsdp_dims(cfg, params, dist) if cache is None else None
    if dims is not None:
        top = {k: v for k, v in params.items()
               if k not in ("scan", "tail", "layers")}
        params = dict(params, **_fsdp_gathered(
            top, {k: dims[k] for k in top}, dist))
    x = _embed(cfg, params, tokens, embeds, ctx, dist)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
    remat = remat and cache is None and torch.is_grad_enabled()

    block_table = cache.get("block_table") if cache is not None else None
    write_plans = {}        # the cache writes' scatter plans, per capacity

    def run(kind, p, x, c, prefix):
        return block_apply(cfg, kind, p, x, positions, ctx=ctx, prefix=prefix,
                           cache=c, chunked=chunked, block_table=block_table,
                           append=append, write_plans=write_plans,
                           dist=dist)

    def layer_params(p, d, lead=0):
        return _fsdp_gathered(p, d, dist, lead) if dims is not None else p

    gather = not vocab_parallel
    if "layers" in params:
        for i, kind in enumerate(cfg.layer_plan):
            c = cache["layers"][i] if cache is not None else None
            d = dims["layers"][i] if dims is not None else None
            if remat:
                x = _remat(lambda p, x, kind=kind, i=i, d=d:
                           run(kind, layer_params(p, d), x, None,
                               f"layer{i}")[0], ctx,
                           params["layers"][i], x)
            else:
                x, _ = run(kind, layer_params(params["layers"][i], d), x, c,
                           f"layer{i}")
        return _head(cfg, params, x, ctx, dist, gather), cache

    def superblock(p_slices, x, s=None):
        for j, kind in enumerate(cfg.block_pattern):
            if s is None:
                p, c = p_slices[j], None
                if dims is not None:
                    p = layer_params(p, dims["scan"][j], lead=1)
            else:
                # views of layer s of the stacked cache and params
                c = _layer(cache["scan"][j], s)
                p = _layer(params["scan"][j], s)
            x, _ = run(kind, p, x, c, "layer")
        return x

    # the cache-free forward unbinds each stacked leaf once; with a cache
    # every layer gets views of its slice (the cache is written in place)
    unstacked = None
    if cache is None:
        unstacked = [_unstack(blk, cfg.n_super) for blk in params["scan"]]
    # quant telemetry: every superblock records under the shared "layer/"
    # names, so its new entries are taken out after it and stacked into
    # (n_super, 4) vectors, the reference's scan outputs
    telem = ctx.telemetry if ctx is not None else None
    per_super = []
    for s in range(cfg.n_super):
        before = set(telem) if telem is not None else None
        if remat:
            x = _remat(superblock, ctx, [u[s] for u in unstacked], x)
        elif cache is None:
            x = superblock([u[s] for u in unstacked], x)
        else:
            x = superblock(None, x, s)
        if telem is not None:
            per_super.append({k: telem.pop(k)
                              for k in sorted(set(telem) - before)})
    if per_super:
        telem.update({k: torch.stack([d[k] for d in per_super])
                      for k in per_super[0]})
    for i, kind in enumerate(cfg.tail_pattern):
        c = cache["tail"][i] if cache is not None else None
        p = params["tail"][i]
        if dims is None:
            x, _ = run(kind, p, x, c, "tail")
        elif remat:
            x = _remat(lambda p, x, kind=kind, i=i:
                       run(kind, layer_params(p, dims["tail"][i]), x, None,
                           "tail")[0], ctx, p, x)
        else:
            x, _ = run(kind, layer_params(p, dims["tail"][i]), x, c, "tail")
    return _head(cfg, params, x, ctx, dist, gather), cache


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def _vocab_parallel_ce(logits, labels, dist: DistContext):
    """``common.cross_entropy`` of logits whose vocab dim is cut over the
    ``model`` axis (this rank's slice of it): the logsumexp's max and sum
    and the gold logit reduced over ``model`` (the max without a
    gradient), so no rank gathers the (B, T, V) logits."""
    lf = logits.float()
    n_local = lf.shape[-1]
    m = coll.all_reduce_max(lf.detach().amax(dim=-1), dist)
    sum_exp = coll.sum_over(torch.exp(lf - m[..., None]).sum(dim=-1), dist)
    logz = m + torch.log(sum_exp)
    local = labels.long() - coll.tp_index(dist) * n_local
    mine = (local >= 0) & (local < n_local)
    gold = torch.gather(lf, -1, local.clamp(0, n_local - 1)[..., None])
    gold = torch.where(mine, gold[..., 0], torch.zeros_like(logz))
    return torch.mean(logz - coll.sum_over(gold, dist))


def train_loss(cfg: ModelConfig, params, batch, *, ctx=None,
               remat: bool = True, chunked=None,
               dist: Optional[DistContext] = None):
    """Next-token CE. batch: {tokens (B, T), labels (B, T) [, embeds]}; the
    front-end positions carry no loss. ``dist``: ``batch`` holds this
    rank's data-parallel rows and ``params`` its slices
    (``parallel.sharding``); the logits stay vocab-sharded through the CE,
    and the value returned on every rank is the global mean over the
    whole batch (the ranks' means summed over the data-parallel axes, so
    each rank's gradient is its rows' share)."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        embeds=batch.get("embeds"), ctx=ctx, remat=remat,
                        chunked=chunked, dist=dist,
                        vocab_parallel=dist is not None)
    n_front = logits.shape[1] - batch["labels"].shape[1]
    if n_front > 0:
        logits = logits[:, n_front:]
    if dist is None:
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    if coll.tp_size(dist) == 1:
        loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    else:
        loss = _vocab_parallel_ce(logits[:, :-1], batch["labels"][:, 1:],
                                  dist)
    dp = coll.size(dist, dist.dp_axes)
    return coll.sum_over(loss / dp, dist, dist.dp_axes)


def prefill(cfg: ModelConfig, params, tokens, cache, *, positions=None,
            ctx=None, embeds=None, chunked=None, append: bool = False,
            dist: Optional[DistContext] = None):
    """Fill the cache from a prompt; returns (last_logits, cache). Pads of
    a left-packed ragged prompt carry position -1 (masked, never written),
    so a packed request gets the same logits and cache lane as alone.
    ``append=True`` appends the tokens as one chunk at each lane's position
    (chunked prefill): a prompt split into chunks fills the cache and emits
    its last-token logits as a monolithic prefill does. ``embeds``: front-end
    embeddings prepended to the prompt (see :func:`forward`)."""
    logits, cache = forward(cfg, params, tokens, embeds=embeds, ctx=ctx,
                            cache=cache, positions=positions,
                            chunked=chunked, append=append, dist=dist)
    return logits[:, -1:], cache


def decode_step(cfg: ModelConfig, params, tokens, pos, cache, *, ctx=None,
                dist: Optional[DistContext] = None):
    """One decode step. tokens/pos: (B, 1). Returns (logits, cache)."""
    return forward(cfg, params, tokens, positions=pos, cache=cache, ctx=ctx,
                   dist=dist)

