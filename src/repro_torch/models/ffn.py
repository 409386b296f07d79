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

Tensor-parallel (``dist``): float weights are placed column-parallel
(``w_gate`` / ``w_up`` / ``w_in`` and ``b_in`` on this rank's hidden
slice) and row-parallel (``w_out``), so the hidden activation stays local
and the output is summed over ``model`` in f32, ``b_out`` added once after
the sum; in training the input's gradient is summed over ``model``
(``collectives.copy_to``); the ``hidden`` site then sees the rank's
slice (``ctx.mark_cut``). Packed payloads are whole on every rank: the
integer FFN runs unsharded on each.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (ACTIVATIONS, dot, dot_row_parallel,
                                       matmul_dtype, resolve_weight)
from repro_torch.parallel import collectives as coll


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


def _weight(p, name, ctx, prefix, x, dist=None):
    if isinstance(p[name], dict) and coll.tp_size(dist) > 1:
        # stored int8 stays whole (no rule places its fields), and a whole
        # w_out would be summed over model once per rank
        raise NotImplementedError("int8 weight storage is not yet ported "
                                  "under --tp / dist")
    wm = resolve_weight(p[name], matmul_dtype(x))
    return ctx.weight(f"{prefix}/{name}", wm) if ctx is not None else wm


def _rank_bias(b, width, dist):
    """This rank's slice of a whole hidden bias for a ``width``-wide
    column shard (its gradient summed over ``model``: each rank's slice
    gives its part)."""
    if b.shape[-1] == width:
        return b
    return coll.copy_to(b, dist).narrow(-1, coll.tp_index(dist) * width,
                                        width)


def mlp(p, x, *, activation: str = "gelu", ctx=None, prefix: str = "ffn",
        dist=None):
    """Classic two-layer MLP. p: w_in (D,F), b_in (F,), w_out (F,D),
    b_out (D,); the biases are optional."""
    if _deployed(p, x):
        return _mlp_int8(p, x, activation=activation, ctx=ctx, prefix=prefix)
    x = coll.copy_to(x, dist)
    h = dot(x, _weight(p, "w_in", ctx, prefix, x, dist))
    if "b_in" in p:
        h = h + _rank_bias(p["b_in"], h.shape[-1], dist)
    h = ACTIVATIONS[activation](h)
    if ctx is not None:
        h = ctx.act(f"{prefix}/hidden", h)
        if coll.tp_size(dist) > 1:
            ctx.mark_cut(f"{prefix}/hidden")
    out = dot_row_parallel(h, _weight(p, "w_out", ctx, prefix, h, dist),
                           dist)
    if "b_out" in p:
        out = out + p["b_out"]
    return out


def glu_mlp(p, x, *, activation: str = "silu", ctx=None,
            prefix: str = "ffn", dist=None):
    """Gated MLP (GeGLU / SwiGLU). p: w_gate (D,F), w_up (D,F), w_out (F,D)."""
    if _deployed(p, x):
        return _glu_mlp_int8(p, x, activation=activation, ctx=ctx,
                             prefix=prefix)
    act = ACTIVATIONS[activation]
    x = coll.copy_to(x, dist)
    g = act(dot(x, _weight(p, "w_gate", ctx, prefix, x, dist))) * \
        dot(x, _weight(p, "w_up", ctx, prefix, x, dist))
    if ctx is not None:
        g = ctx.act(f"{prefix}/hidden", g)
        if coll.tp_size(dist) > 1:
            ctx.mark_cut(f"{prefix}/hidden")
    return dot_row_parallel(g, _weight(p, "w_out", ctx, prefix, g, dist),
                            dist)


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
