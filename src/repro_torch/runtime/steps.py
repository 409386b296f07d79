"""Train and serve step factories (port of ``repro.runtime.steps``).

``make_train_step`` accumulates microbatch gradients, clips by global norm
inside the optimizer update and steps Adam or 8-bit Adam, with gradients
from ``torch.autograd.grad`` over the parameter leaves; with ``dist`` on
one rank of a mesh, over its slices of the params and optimizer state and
its data-parallel rows of the batch (the reference's GSPMD step). The serve steps
(prefill, admit, chunk-prefill, decode, block swap) build a fresh ctx from
``ctx_factory`` and run without autograd. Paged caches need no extra
plumbing: the block table rides inside the cache dict. Encoder-decoder
configs train through ``encdec.train_loss``, prefill through
``make_encoder_forward`` and decode over an ``encdec.DecoderCache``.

``quant_telemetry=True`` returns a second closure (``prefill_t``,
``admit_t``, ``chunk_t``, ``decode_t``) whose ctx is armed for quant-health
telemetry and which returns ``(logits, cache, telemetry)``, the extra
output being the ``{site: [clipped, total, amax, range]}`` dict of device
tensors (``runtime.engine.Engine`` folds it); ``quant_telemetry=False``
returns the plain closure itself. ``dist`` runs the serve steps
tensor-parallel on one rank (``models.transformer.forward``); the params
and cache they are given must be placed (``runtime.engine.make_engine``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import SiteTelemetry
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import (adam_update, apply_updates, qadam_update,
                               tree_leaves, tree_map, value_and_grad)
from repro_torch.parallel import collectives as coll


def _loss_fn_for(cfg: ModelConfig):
    if cfg.encoder_layers:
        return encdec_lib.train_loss
    return tfm.train_loss


def make_train_step(cfg: ModelConfig, *, lr_schedule, microbatches: int = 1,
                    dist=None, clip_norm: float = 1.0,
                    ctx_factory: Optional[Callable] = None,
                    remat: bool = True, chunked=None,
                    optimizer: str = "adam", accum_dtype=torch.float32):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``metrics`` {"loss", "grad_norm", "lr"} as device tensors.

    The loss is ``encdec.train_loss`` for encoder-decoder configs (batch
    {frames, tokens, labels}; ``chunked`` does not apply), else
    ``transformer.train_loss``.
    ctx_factory: () -> QuantCtx for QAT (fake-quant in the train graph).
    optimizer: "adam" (f32 moments) or "adam8bit" (int8 moments with
    row-wise scales, ``optim.quantized_adam``). Params and optimizer state
    are updated in place with the functional update's values, the port's
    counterpart of the reference's callers jitting the step with
    ``donate_argnums=(0, 1)``: a step holds one copy of each, and the
    trees passed in are the trees returned.

    ``dist``: this rank of a mesh (``launch.mesh.run_ranks``) steps its
    slices (``parallel.sharding.make_param_shardings``; the optimizer
    state made on them, ``qadam_init(logical=)`` for 8-bit Adam) on its
    data-parallel rows of the batch (``data.pipeline.shard_batch`` with
    the same ``microbatches``). Microbatch i of the rank is then the dp
    shard of the global batch's microbatch i, as in the reference's scan
    (its MoE routes per shard).
    The gradients are the whole batch's: FSDP leaves come back
    reduce-scattered from the forward's gathers, every other leaf is
    summed over the data-parallel axes; the global norm adds each leaf's
    squares over the mesh once per logical element; 8-bit Adam's row
    scales reduce a sharded last dim. ``step.loss_and_grads(params,
    batch)`` gives (loss, grads) without updating (the step calls it
    through the attribute), ``step.grad_norm(grads, shardings)`` their
    global norm.

    QAT under ``dist`` (``ctx_factory``): every weight's grid is fitted on
    the whole weight each step, as the reference's GSPMD graph fits it on
    the logical array (``QuantCtx.weight_split``: min-max ranges reduced
    over the ranks that cut the weight, the MSE search on the weight
    gathered for it) and applied to the rank's slice, whose
    straight-through gradients stay local; activation sites keep their
    calibrated grids."""
    if dist is not None:
        tfm.check_tp(cfg, dist, training=True)
    if dist is not None and ctx_factory is not None:
        from repro_torch.parallel.sharding import weight_cut_dims
        split, make_ctx = (dist, weight_cut_dims(cfg, dist)), ctx_factory

        def ctx_factory():
            ctx = make_ctx()
            if ctx is not None:
                ctx.weight_split = split
            return ctx
    if optimizer == "adam8bit":
        opt_update = qadam_update
    elif optimizer == "adam":
        opt_update = adam_update
    else:
        raise ValueError(f"optimizer must be 'adam' or 'adam8bit', got "
                         f"{optimizer!r}")

    loss_fn = _loss_fn_for(cfg)

    def loss_for(params, mb):
        ctx = ctx_factory() if ctx_factory is not None else None
        kw = {} if cfg.encoder_layers else {"chunked": chunked}
        if dist is not None:
            kw["dist"] = dist
        return loss_fn(cfg, params, mb, ctx=ctx, remat=remat, **kw)

    def loss_and_grads(params, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(lambda p: loss_for(p, batch),
                                         params)
        else:
            mbs = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                *v.shape[1:]) for k, v in batch.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            for i in range(microbatches):
                mb = {k: v[i] for k, v in mbs.items()}
                l, g = value_and_grad(lambda p: loss_for(p, mb), params)
                tree_map(lambda a, b: a.add_(b.to(accum_dtype)), grads, g)
                lsum = lsum + l
                del g
            loss = lsum / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        if dist is not None:
            # leaves no FSDP axis shards: each rank holds its rows' part
            fsdp = dist.fsdp_axis
            grads = tree_map(
                lambda g, sh: g if fsdp in sh.spec else
                coll.all_reduce_sum(g, dist, dist.dp_axes),
                grads, _shardings(params))
        return loss, grads

    def _shardings(params):
        from repro_torch.parallel.sharding import param_shardings
        return param_shardings(cfg, params, dist)

    def grad_norm(grads, shardings=None):
        """The global L2 norm: each leaf's squares, over the mesh once per
        logical element (a leaf's replicas divide its share)."""
        if dist is None:
            return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for g in tree_leaves(grads)))
        from repro_torch.parallel.sharding import replication
        sq = torch.stack([torch.sum(torch.square(g.float())) /
                          replication(sh) for g, sh in
                          zip(tree_leaves(grads), tree_leaves(shardings))])
        return torch.sqrt(sum(coll.mesh_sum(sq, dist).unbind()))

    def step(params, opt_state, batch):
        # looked up at each call: a check may wrap it to see the gradients
        loss, grads = step.loss_and_grads(params, batch)
        shardings = _shardings(params) if dist is not None else None
        # the global-norm clip is fused into the moment update as a scale
        gnorm = grad_norm(grads, shardings)
        scale = torch.clamp_max(clip_norm / (gnorm + 1e-12), 1.0)
        kw = {"shardings": shardings} if optimizer == "adam8bit" else {}
        updates, opt_state = opt_update(grads, opt_state, params,
                                        lr=lr_schedule, grad_scale=scale,
                                        inplace=True, **kw)
        del grads
        params = apply_updates(params, updates, inplace=True)
        lr = lr_schedule(opt_state.step) if callable(lr_schedule) else \
            torch.tensor(float(lr_schedule), device=gnorm.device)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    step.loss_and_grads = loss_and_grads
    step.grad_norm = grad_norm
    return step


def _telem_ctx(ctx_factory):
    """A fresh ctx with quant telemetry armed: every fake-quant and deploy
    site it passes adds its vector to ``ctx.telemetry`` (a
    ``SiteTelemetry``). Returns (ctx, the dict)."""
    ctx = ctx_factory() if ctx_factory is not None else None
    if ctx is not None:
        ctx.telemetry = SiteTelemetry()
        return ctx, ctx.telemetry
    return None, SiteTelemetry()


def make_prefill_step(cfg: ModelConfig, *, dist=None,
                      ctx_factory: Optional[Callable] = None, chunked=None,
                      quant_telemetry: bool = False):
    """prefill(params, tokens, cache[, positions, embeds]) -> (last_logits,
    cache). ``positions`` (B, T) carries the -1 dead-cell sentinel on pads;
    ``embeds`` (B, N, D) front-end embeddings are prepended to the tokens
    (positions then cover N + T cells)."""
    @torch.no_grad()
    def prefill(params, tokens, cache, positions=None, embeds=None):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           embeds=embeds, ctx=ctx, chunked=chunked, dist=dist)

    if not quant_telemetry:
        return prefill

    @torch.no_grad()
    def prefill_t(params, tokens, cache, positions=None, embeds=None):
        ctx, tel = _telem_ctx(ctx_factory)
        logits, cache = tfm.prefill(cfg, params, tokens, cache,
                                    positions=positions, embeds=embeds,
                                    ctx=ctx, chunked=chunked, dist=dist)
        return logits, cache, tel
    return prefill_t


def make_admit_step(cfg: ModelConfig, *, dist=None,
                    ctx_factory: Optional[Callable] = None, chunked=None,
                    quant_telemetry: bool = False):
    """Slot-insert prefill for continuous batching:
    admit(params, tokens (B, P), positions (B, P), admit_mask (B,), cache)
    -> (last_logits (B, 1, V), cache). Admitted lanes are reset first
    (``transformer.cache_reset_slots``) and prefilled with their left-padded
    prompt; the other lanes carry all -1 positions and pass through."""
    @torch.no_grad()
    def admit(params, tokens, positions, admit_mask, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        cache = tfm.cache_reset_slots(cache, admit_mask)
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           ctx=ctx, chunked=chunked, dist=dist)

    if not quant_telemetry:
        return admit

    @torch.no_grad()
    def admit_t(params, tokens, positions, admit_mask, cache):
        ctx, tel = _telem_ctx(ctx_factory)
        cache = tfm.cache_reset_slots(cache, admit_mask)
        logits, cache = tfm.prefill(cfg, params, tokens, cache,
                                    positions=positions, ctx=ctx,
                                    chunked=chunked, dist=dist)
        return logits, cache, tel
    return admit_t


def make_chunk_prefill_step(cfg: ModelConfig, *, dist=None,
                            ctx_factory: Optional[Callable] = None,
                            chunked=None, quant_telemetry: bool = False):
    """Chunked prefill: chunk(params, tokens (B, C), positions (B, C),
    reset_mask (B,), cache) -> (last_logits (B, 1, V), cache). Appends one
    chunk at each prefilling lane's position (append-mode attention);
    lanes starting their first chunk are reset first, lanes not prefilling
    carry all -1 positions and pass through."""
    @torch.no_grad()
    def chunk(params, tokens, positions, reset_mask, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        cache = tfm.cache_reset_slots(cache, reset_mask)
        return tfm.prefill(cfg, params, tokens, cache, positions=positions,
                           ctx=ctx, chunked=chunked, append=True,
                           dist=dist)

    if not quant_telemetry:
        return chunk

    @torch.no_grad()
    def chunk_t(params, tokens, positions, reset_mask, cache):
        ctx, tel = _telem_ctx(ctx_factory)
        cache = tfm.cache_reset_slots(cache, reset_mask)
        logits, cache = tfm.prefill(cfg, params, tokens, cache,
                                    positions=positions, ctx=ctx,
                                    chunked=chunked, append=True, dist=dist)
        return logits, cache, tel
    return chunk_t


def make_decode_step(cfg: ModelConfig, *, dist=None,
                     ctx_factory: Optional[Callable] = None,
                     quant_telemetry: bool = False):
    """decode(params, tokens (B,1), pos (B,1), cache) -> (logits, cache).
    Encoder-decoder configs step the decoder over an
    ``encdec.DecoderCache`` (without quant telemetry, as in the
    reference)."""
    if cfg.encoder_layers:
        if dist is not None:
            raise NotImplementedError("the encoder-decoder is not yet "
                                      "ported under --tp / dist")

        @torch.no_grad()
        def decode(params, tokens, pos, cache):
            ctx = ctx_factory() if ctx_factory is not None else None
            return encdec_lib.decode_step(cfg, params, tokens, pos, cache,
                                          ctx=ctx)
        return decode

    @torch.no_grad()
    def decode(params, tokens, pos, cache):
        ctx = ctx_factory() if ctx_factory is not None else None
        return tfm.decode_step(cfg, params, tokens, pos, cache, ctx=ctx,
                               dist=dist)

    if not quant_telemetry:
        return decode

    @torch.no_grad()
    def decode_t(params, tokens, pos, cache):
        ctx, tel = _telem_ctx(ctx_factory)
        logits, cache = tfm.decode_step(cfg, params, tokens, pos, cache,
                                        ctx=ctx, dist=dist)
        return logits, cache, tel
    return decode_t


def make_swap_steps():
    """Block swap-out / swap-in for over-commit preemption (paged caches
    only; thin wrappers over ``models.transformer``'s gather and scatter):

      swap_out(cache, ids (n,)) -> payload on the cache's device
      swap_in(cache, ids (n,), payload) -> cache, written in place

    ``ids`` are a lane's live physical blocks; swap-in writes the payload
    into the lane's new blocks in the same order, bit for bit, so the
    resumed lane emits the same greedy tokens. The engine moves the
    payload to host memory and back (``Engine.swap_out`` /
    ``Engine.swap_in``)."""
    def swap_out(cache, ids):
        return tfm.cache_gather_blocks(cache, ids)

    def swap_in(cache, ids, payload):
        return tfm.cache_scatter_blocks(cache, ids, payload)
    return swap_out, swap_in


def make_encoder_forward(cfg: ModelConfig):
    """The encoder-decoder's serving prefill: fwd(params, frames (B, S, D),
    bos_tokens (B, 1)) -> (logits, DecoderCache) encodes the frames,
    projects the decoder's cross-attention K/V and runs the first decoder
    step, into a cache of 1024 self-attention cells (the reference's)."""
    @torch.no_grad()
    def fwd(params, frames, bos_tokens):
        return encdec_lib.prefill_from_encoder(cfg, params, frames,
                                               bos_tokens,
                                               max_decode_len=1024)
    return fwd
