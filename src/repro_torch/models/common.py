"""Shared model building blocks (port of ``repro.models.common``): norms,
soft-capping, activations, rotary embeddings, initializers, and the
packed-weight guard. Float operations follow the reference's order."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.int8_matmul import EPILOGUE_ACTS

# One definition shared with the deploy epilogue (GELU in tanh form).
ACTIVATIONS = {k: v for k, v in EPILOGUE_ACTS.items() if k != "none"}
gelu = ACTIVATIONS["gelu"]
silu = ACTIVATIONS["silu"]


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
# Weight storage
# ---------------------------------------------------------------------------

def resolve_weight(w):
    """Weights may be stored as {"q": int8, "s": f32 per-out-channel};
    deploy-packed payloads (with "colsum") must never be dequantized here:
    their rows may be PEG-permuted."""
    if isinstance(w, dict) and "q" in w:
        if "colsum" in w:
            raise TypeError(
                "deploy-packed weight reached a non-deploy path; packed "
                "payloads must be consumed via repro_torch.core.deploy")
        return w["q"].to(torch.bfloat16) * w["s"].to(torch.bfloat16)
    return w
