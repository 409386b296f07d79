"""BERT encoder — the paper's model (port of ``repro.models.bert``), with
every quantization site of the paper's Fig. 1 threaded through QuantCtx
(post-LN blocks, learned positions, token-type embeddings, pooler +
classification/regression head).

Sites (per layer i):
  layer{i}/attn/{q,k,v,softmax_in,softmax_out,ctx_out}
  layer{i}/residual_attn           — sum x + attn_out (input of LN_attn)
  layer{i}/ln_attn                 — LN output (= FFN input path)
  layer{i}/ffn_in                  — FFN input (paper "FFN's input")
  layer{i}/ffn/hidden              — GELU hidden
  layer{i}/ffn_out                 — FFN output (paper "FFN's output")
  layer{i}/residual_ffn            — THE bottleneck: sum after FFN
  layer{i}/ln_ffn                  — LN output feeding the next layer
Global: embed/sum, embed/ln, head/pooled, head/logits.
Weight sites: layer{i}/attn/{wq,wk,wv,wo}, layer{i}/ffn/{w_in,w_out},
embed/tokens, head/w_pool, head/w_cls.

LayerNorm and every fake-quant site run as PyTorch operators, as the
reference runs them in plain jnp (no kernel of the serving path is on this
model's path); attention is the port's ``_dense_attend``, with padding as
key position -1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import AttnConfig, _dense_attend
from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       gelu, layer_norm)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 30522
    type_vocab: int = 2
    max_positions: int = 512
    num_labels: int = 2
    regression: bool = False      # STS-B-style

    @property
    def hd(self):
        return self.d_model // self.num_heads


def tiny(num_labels=2, regression=False, **kw) -> BertConfig:
    """The reduced BERT used by the reproduction benchmarks."""
    defaults = dict(num_layers=4, d_model=128, num_heads=4, d_ff=512,
                    vocab_size=1024, max_positions=128,
                    num_labels=num_labels, regression=regression)
    defaults.update(kw)
    return BertConfig(**defaults)


def init_params(cfg: BertConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random weights from ``seed`` (the reference's distributions, drawn
    from one ``torch.Generator`` on ``device``; None: the GPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, device=dev)

    def embed(vocab):
        return embed_init(gen, vocab, d, dtype, device=dev)

    def const(n, v):
        return torch.full((n,), v, dtype=dtype, device=dev)

    params: Dict[str, Any] = {
        "tok_embed": embed(cfg.vocab_size),
        "pos_embed": embed(cfg.max_positions),
        "type_embed": embed(cfg.type_vocab),
        "embed_ln_g": const(d, 1.0), "embed_ln_b": const(d, 0.0),
        "w_pool": dense(d, d), "b_pool": const(d, 0.0),
        "w_cls": dense(d, cfg.num_labels), "b_cls": const(cfg.num_labels, 0.0),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
            "wo": dense(d, d),
            "bq": const(d, 0.0), "bk": const(d, 0.0), "bv": const(d, 0.0),
            "bo": const(d, 0.0),
            "ln_attn_g": const(d, 1.0), "ln_attn_b": const(d, 0.0),
            "w_in": dense(d, f), "b_in": const(f, 0.0),
            "w_out": dense(f, d), "b_out": const(d, 0.0),
            "ln_ffn_g": const(d, 1.0), "ln_ffn_b": const(d, 0.0),
        })
    return params


def _w(ctx, site, w):
    return ctx.weight(site, w) if ctx is not None else w


def _a(ctx, site, x):
    return ctx.act(site, x) if ctx is not None else x


def _self_attention(cfg: BertConfig, p, x, pad_mask, ctx, prefix):
    B, T, D = x.shape
    H, hd = cfg.num_heads, cfg.hd
    q = (x @ _w(ctx, f"{prefix}/wq", p["wq"]) + p["bq"]).reshape(B, T, H, hd)
    k = (x @ _w(ctx, f"{prefix}/wk", p["wk"]) + p["bk"]).reshape(B, T, H, hd)
    v = (x @ _w(ctx, f"{prefix}/wv", p["wv"]) + p["bv"]).reshape(B, T, H, hd)
    q = _a(ctx, f"{prefix}/q", q)
    k = _a(ctx, f"{prefix}/k", k)
    v = _a(ctx, f"{prefix}/v", v)
    acfg = AttnConfig(num_heads=H, num_kv_heads=H, head_dim=hd, causal=False,
                      rope_theta=None)
    # positions encode padding: valid tokens >= 0, padded -> -1 (masked out)
    ar = torch.arange(T, dtype=torch.int32, device=x.device)[None]
    pos = torch.where(pad_mask, ar, -1)
    q_pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    out = _dense_attend(q, k, v, q_pos, pos, acfg, ctx=ctx, prefix=prefix)
    out = out.reshape(B, T, D) @ _w(ctx, f"{prefix}/wo", p["wo"]) + p["bo"]
    return _a(ctx, f"{prefix}/ctx_out", out)


def encode(cfg: BertConfig, params, tokens, *, type_ids=None, pad_mask=None,
           ctx=None):
    """tokens: (B, T) -> hidden states (B, T, D)."""
    B, T = tokens.shape
    dev = tokens.device
    if pad_mask is None:
        pad_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if type_ids is None:
        type_ids = torch.zeros((B, T), dtype=torch.int32, device=dev)

    x = _w(ctx, "embed/tokens", params["tok_embed"])[tokens.long()]
    x = x + params["pos_embed"][None, :T]
    x = x + params["type_embed"][type_ids.long()]
    x = _a(ctx, "embed/sum", x)           # paper: "sum of embeddings"
    x = layer_norm(x, params["embed_ln_g"], params["embed_ln_b"])
    x = _a(ctx, "embed/ln", x)

    for i, p in enumerate(params["layers"]):
        pre = f"layer{i}"
        attn_out = _self_attention(cfg, p, x, pad_mask, ctx, f"{pre}/attn")
        s = _a(ctx, f"{pre}/residual_attn", x + attn_out)
        x = layer_norm(s, p["ln_attn_g"], p["ln_attn_b"])
        x = _a(ctx, f"{pre}/ln_attn", x)

        f_in = _a(ctx, f"{pre}/ffn_in", x)
        h = f_in @ _w(ctx, f"{pre}/ffn/w_in", p["w_in"]) + p["b_in"]
        h = _a(ctx, f"{pre}/ffn/hidden", gelu(h))
        f_out = h @ _w(ctx, f"{pre}/ffn/w_out", p["w_out"]) + p["b_out"]
        f_out = _a(ctx, f"{pre}/ffn_out", f_out)
        s = _a(ctx, f"{pre}/residual_ffn", x + f_out)  # THE paper bottleneck
        x = layer_norm(s, p["ln_ffn_g"], p["ln_ffn_b"])
        x = _a(ctx, f"{pre}/ln_ffn", x)
    return x


def classify(cfg: BertConfig, params, tokens, *, type_ids=None,
             pad_mask=None, ctx=None):
    """Sequence classification/regression head on [CLS] (position 0)."""
    h = encode(cfg, params, tokens, type_ids=type_ids, pad_mask=pad_mask,
               ctx=ctx)
    cls = h[:, 0]
    pooled = torch.tanh(cls @ _w(ctx, "head/w_pool", params["w_pool"])
                        + params["b_pool"])
    pooled = _a(ctx, "head/pooled", pooled)
    logits = pooled @ _w(ctx, "head/w_cls", params["w_cls"]) + \
        params["b_cls"]
    return _a(ctx, "head/logits", logits)


def loss_fn(cfg: BertConfig, params, batch, ctx=None):
    logits = classify(cfg, params, batch["tokens"],
                      type_ids=batch.get("type_ids"),
                      pad_mask=batch.get("pad_mask"), ctx=ctx)
    if cfg.regression:
        return torch.mean(torch.square(logits[:, 0] - batch["labels"]))
    return cross_entropy(logits, batch["labels"])


def predict(cfg: BertConfig, params, batch, ctx=None):
    logits = classify(cfg, params, batch["tokens"],
                      type_ids=batch.get("type_ids"),
                      pad_mask=batch.get("pad_mask"), ctx=ctx)
    if cfg.regression:
        return logits[:, 0]
    return torch.argmax(logits, dim=-1)


def named_weight_sites(cfg: BertConfig, params) -> Dict[str, torch.Tensor]:
    """site -> weight tensor, for PTQ weight-state building / AdaRound."""
    out = {"embed/tokens": params["tok_embed"],
           "head/w_pool": params["w_pool"], "head/w_cls": params["w_cls"]}
    for i, p in enumerate(params["layers"]):
        for nm in ("wq", "wk", "wv", "wo"):
            out[f"layer{i}/attn/{nm}"] = p[nm]
        out[f"layer{i}/ffn/w_in"] = p["w_in"]
        out[f"layer{i}/ffn/w_out"] = p["w_out"]
    return out


def activation_sites(cfg: BertConfig) -> list:
    """All activation site names (the paper's '161 quantizers' census)."""
    sites = ["embed/sum", "embed/ln", "head/pooled", "head/logits"]
    for i in range(cfg.num_layers):
        pre = f"layer{i}"
        sites += [f"{pre}/attn/q", f"{pre}/attn/k", f"{pre}/attn/v",
                  f"{pre}/attn/softmax_in", f"{pre}/attn/softmax_out",
                  f"{pre}/attn/ctx_out", f"{pre}/residual_attn",
                  f"{pre}/ln_attn", f"{pre}/ffn_in", f"{pre}/ffn/hidden",
                  f"{pre}/ffn_out", f"{pre}/residual_ffn", f"{pre}/ln_ffn"]
    return sites
