"""Feed-forward blocks with the paper's quantization sites (port of
``repro.models.ffn``): the classic two-layer MLP with biases (BERT-style)
and the gated GLU.

Deployment (``Mode.DEPLOY``): with packed weights and a :class:`QTensor`
input (from the fused norm + quantize kernel) the MLP runs on the integer
kernels — for the MLP, ``w_in`` on ``int8_matmul_peg`` (``int8_matmul``
with a per-tensor input) with bias, activation and requant fused in its
epilogue, then ``w_out`` with its bias; for GLU, ``w_up`` with f32 output,
then ``w_gate`` with the fused ``act(gate) * up`` + requant epilogue, then
``w_out`` — so the hidden activation crosses memory as int8.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (ACTIVATIONS, dot, matmul_dtype,
                                       resolve_weight)


def _mlp_int8(p, x, *, activation: str, ctx, prefix: str):
    """Integer MLP: W_in matmul + bias + act + requant fused, then W_out."""
    from repro_torch.core import deploy
    hid = ctx.deploy_act(f"{prefix}/hidden")
    h_q = deploy.matmul(x, p["w_in"], bias=p.get("b_in"),
                        activation=activation, out_aq=hid)
    if ctx.telemetry is not None:
        ctx.telem_site(f"{prefix}/hidden", deploy.qtensor_stats(h_q, hid))
    return deploy.matmul(h_q, p["w_out"], bias=p.get("b_out"))


def _glu_mlp_int8(p, x, *, activation: str, ctx, prefix: str):
    from repro_torch.core import deploy
    hid = ctx.deploy_act(f"{prefix}/hidden")
    up = deploy.matmul(x, p["w_up"])
    h_q = deploy.matmul(x, p["w_gate"], activation=activation, mul=up,
                        out_aq=hid)
    if ctx.telemetry is not None:
        ctx.telem_site(f"{prefix}/hidden", deploy.qtensor_stats(h_q, hid))
    return deploy.matmul(h_q, p["w_out"])


def is_packed(p) -> bool:
    """Whether the FFN params ``p`` (MLP ``w_in`` or GLU ``w_gate``) hold
    int8 packs."""
    from repro_torch.core import deploy
    return deploy.is_packed(p.get("w_in", p.get("w_gate")))


def _deployed(p, x) -> bool:
    from repro_torch.core import deploy
    return isinstance(x, deploy.QTensor) and is_packed(p)


def _weight(p, name, ctx, prefix, x):
    wm = resolve_weight(p[name], matmul_dtype(x))
    return ctx.weight(f"{prefix}/{name}", wm) if ctx is not None else wm


def mlp(p, x, *, activation: str = "gelu", ctx=None, prefix: str = "ffn"):
    """Classic two-layer MLP. p: w_in (D,F), b_in (F,), w_out (F,D),
    b_out (D,); the biases are optional."""
    if _deployed(p, x):
        return _mlp_int8(p, x, activation=activation, ctx=ctx, prefix=prefix)
    h = dot(x, _weight(p, "w_in", ctx, prefix, x))
    if "b_in" in p:
        h = h + p["b_in"]
    h = ACTIVATIONS[activation](h)
    if ctx is not None:
        h = ctx.act(f"{prefix}/hidden", h)
    out = dot(h, _weight(p, "w_out", ctx, prefix, h))
    if "b_out" in p:
        out = out + p["b_out"]
    return out


def glu_mlp(p, x, *, activation: str = "silu", ctx=None,
            prefix: str = "ffn"):
    """Gated MLP (GeGLU / SwiGLU). p: w_gate (D,F), w_up (D,F), w_out (F,D)."""
    if _deployed(p, x):
        return _glu_mlp_int8(p, x, activation=activation, ctx=ctx,
                             prefix=prefix)
    act = ACTIVATIONS[activation]
    g = act(dot(x, _weight(p, "w_gate", ctx, prefix, x))) * \
        dot(x, _weight(p, "w_up", ctx, prefix, x))
    if ctx is not None:
        g = ctx.act(f"{prefix}/hidden", g)
    return dot(g, _weight(p, "w_out", ctx, prefix, g))


def init_mlp_params(gen, d_model: int, d_ff: int, dtype, device=None,
                    bias: bool = True):
    from repro_torch.models.common import dense_init
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype, device=device),
         "w_out": dense_init(gen, d_ff, d_model, dtype, device=device)}
    if bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def init_glu_params(gen, d_model: int, d_ff: int, dtype, device=None):
    from repro_torch.models.common import dense_init
    return {name: dense_init(gen, a, b, dtype, device=device)
            for name, a, b in (("w_gate", d_model, d_ff),
                               ("w_up", d_model, d_ff),
                               ("w_out", d_ff, d_model))}
