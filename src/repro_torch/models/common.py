"""Shared model building blocks (port of ``repro.models.common``): norms,
soft-capping, activations, rotary embeddings, initializers, the
cross-entropy loss, int8 weight storage and the packed-weight guard. Float
operations follow the reference's order."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.int8_matmul import EPILOGUE_ACTS

# One definition shared with the deploy epilogue (GELU in tanh form).
ACTIVATIONS = {k: v for k, v in EPILOGUE_ACTS.items() if k != "none"}
gelu = ACTIVATIONS["gelu"]
silu = ACTIVATIONS["silu"]


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm in f32: the mean, then the variance as the mean square of
    the centred values (``jnp.var``'s order), cast back to ``x``'s dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma + beta).to(x.dtype)


def rms_norm(x, gamma, eps: float = 1e-6):
    """RMSNorm with the ``(1 + gamma)`` affine, computed in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def softcap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def dot(x, w):
    """``x @ w`` with JAX's dtype promotion (bf16 @ f32 computes in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dot_row_parallel(x, w, dist):
    """``x @ w`` of a row-parallel product: ``x`` holds this rank's slice
    of the contraction dim and ``w`` the matching rows. Each rank's partial
    product is taken in f32 and summed over ``model`` in f32, then cast to
    :func:`dot`'s type (a bf16 product accumulates in f32 too); the
    gradient of the sum reaches every rank's partial whole. Without
    ``dist`` (or on one rank) it is :func:`dot`."""
    from repro_torch.parallel import collectives as coll
    if coll.tp_size(dist) == 1:
        return dot(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    part = x.to(torch.float32) @ w.to(torch.float32)
    return coll.sum_over(part, dist).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., T, hd/2)
    angles = angles[..., None, :]                          # (..., T, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initialization (same distributions as the reference; the generator
# differs, so parity tests carry the reference's weights across instead)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale=None, device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None):
    w = torch.randn((vocab, d), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None):
    """Token-level CE. logits (..., V), labels (...) int. mask optional."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Weight storage
# ---------------------------------------------------------------------------

def resolve_weight(w, dtype=torch.bfloat16):
    """Weights may be stored as {"q": int8, "s": f32 per-out-channel}
    (:func:`quantize_weight_int8`), dequantized here in ``dtype``: the
    int8 value times the bf16-rounded scale, a product exact in f32 (8 + 8
    significant bits). The reference writes it in bf16, and its compiled
    forward keeps it unrounded where the matmul promotes it to f32, so a
    site passes its matmul's type (``matmul_dtype``). Deploy-packed
    payloads (with "colsum") must never be dequantized here: their rows
    may be PEG-permuted."""
    if isinstance(w, dict) and "q" in w:
        if "colsum" in w:
            raise TypeError(
                "deploy-packed weight reached a non-deploy path; packed "
                "payloads must be consumed via repro_torch.core.deploy")
        return (w["q"].float() * w["s"].to(torch.bfloat16).float()).to(dtype)
    return w


def matmul_dtype(x):
    """The type a stored-int8 weight joins ``x``'s matmul in: JAX's
    promotion of ``x`` with the bf16 dequantized weight."""
    return torch.promote_types(x.dtype, torch.bfloat16)


def quantize_weight_int8(w):
    """Symmetric per-out-channel int8 storage of a weight matrix (in, out):
    {"q": int8, "s": f32 (1, out)}, which :func:`resolve_weight`
    dequantizes at the use site."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=0, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127)
    return {"q": q.to(torch.int8), "s": s}


def quantize_stacked_int8(w):
    """:func:`quantize_weight_int8` of each layer of a stacked (L, in, out)
    weight: {"q": (L, in, out) int8, "s": (L, 1, out) f32}."""
    parts = [quantize_weight_int8(x) for x in w]
    return {k: torch.stack([p[k] for p in parts]) for k in ("q", "s")}
