"""The gated feed-forward block with the paper's quantization sites (port
of the GLU half of ``repro.models.ffn``; the classic MLP comes with the
BERT slice).

Deployment (``Mode.DEPLOY``): with packed weights and a :class:`QTensor`
input (from the fused norm + quantize kernel) the MLP runs on the integer
kernels — for GLU, ``w_up`` on ``int8_matmul_peg`` with f32 output, then
``w_gate`` with the fused ``act(gate) * up`` + requant epilogue, then
``w_out`` on ``int8_matmul`` — so the hidden activation crosses memory as
int8.
"""
from __future__ import annotations

from repro_torch.models.common import ACTIVATIONS, dot, resolve_weight


def _glu_mlp_int8(p, x, *, activation: str, ctx, prefix: str):
    from repro_torch.core import deploy
    hid = ctx.deploy_act(f"{prefix}/hidden")
    up = deploy.matmul(x, p["w_up"])
    h_q = deploy.matmul(x, p["w_gate"], activation=activation, mul=up,
                        out_aq=hid)
    if ctx.telemetry is not None:
        ctx.telem_site(f"{prefix}/hidden", deploy.qtensor_stats(h_q, hid))
    return deploy.matmul(h_q, p["w_out"])


def _deployed(p, x) -> bool:
    from repro_torch.core import deploy
    return isinstance(x, deploy.QTensor) and deploy.is_packed(p["w_gate"])


def _weight(p, name, ctx, prefix):
    wm = resolve_weight(p[name])
    return ctx.weight(f"{prefix}/{name}", wm) if ctx is not None else wm


def glu_mlp(p, x, *, activation: str = "silu", ctx=None,
            prefix: str = "ffn"):
    """Gated MLP (GeGLU / SwiGLU). p: w_gate (D,F), w_up (D,F), w_out (F,D)."""
    if _deployed(p, x):
        return _glu_mlp_int8(p, x, activation=activation, ctx=ctx,
                             prefix=prefix)
    act = ACTIVATIONS[activation]
    g = act(dot(x, _weight(p, "w_gate", ctx, prefix))) * \
        dot(x, _weight(p, "w_up", ctx, prefix))
    if ctx is not None:
        g = ctx.act(f"{prefix}/hidden", g)
    return dot(g, _weight(p, "w_out", ctx, prefix))


def init_glu_params(gen, d_model: int, d_ff: int, dtype, device=None):
    from repro_torch.models.common import dense_init
    return {name: dense_init(gen, a, b, dtype, device=device)
            for name, a, b in (("w_gate", d_model, d_ff),
                               ("w_up", d_model, d_ff),
                               ("w_out", d_ff, d_model))}
