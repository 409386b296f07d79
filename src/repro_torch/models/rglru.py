"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; port
of ``repro.models.rglru``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)                  (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                  (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill and training run the recurrence as a log-depth doubling scan over T
(``_doubling_scan``: ceil(log2 T) rounds of whole-tensor operations, the
reference's ``associative_scan`` combine in another association, so f32
results agree to rounding, not bit for bit); decode is the O(1) step. The
Griffin block wraps the LRU with a linear in-projection, a width-4 causal
depthwise conv, a gated GeLU branch and a linear out-projection.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, dot, gelu

LRU_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor        # (B, D_rnn) f32 recurrent state
    conv: torch.Tensor     # (B, W-1, D_rnn) f32 last conv inputs


def _gates(p, x):
    r = torch.sigmoid(dot(x, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(dot(x, p["w_x"]) + p["b_x"])
    log_a = -LRU_C * F.softplus(p["lam"]) * r              # log decay <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * \
        (i * x)
    return a, gated


def _doubling_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1 with the
    combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``: after the round
    at offset d, element t holds the composition of steps (t - 2d, t]."""
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rg_lru_scan(p, x, h0: Optional[torch.Tensor] = None):
    """x: (B, T, D_rnn) -> (y (B, T, D_rnn), h_T f32)."""
    a, b = _gates(p, x.float())
    if h0 is not None:
        # fold the initial state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    _, acc_b = _doubling_scan(a, b)
    y = acc_b if h0 is None else acc_b[:, 1:]
    return y.to(x.dtype), acc_b[:, -1].float()


def rg_lru_step(p, x_t, h):
    """Single decode step. x_t: (B, D_rnn), h: (B, D_rnn) f32."""
    a, b = _gates(p, x_t.float()[:, None])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


def _causal_conv(p, x, conv_state=None):
    """Width-4 causal depthwise conv. x: (B, T, D). The taps are summed
    left to right (the reference's Python ``sum``); the new state is the
    last W-1 inputs in f32."""
    w = p["conv_w"]                    # (W, D)
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):].float()
    return out + p["conv_b"], new_state


def recurrent_block(p, x, *, state: Optional[RGLRUState] = None, ctx=None,
                    prefix: str = "rec"
                    ) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """Griffin recurrent block. x: (B, T, D_model). Returns (out, the new
    state or None); the caller writes the state back."""
    def w(name):
        return ctx.weight(f"{prefix}/{name}", p[name]) if ctx is not None \
            else p[name]

    rnn_in = dot(x, w("w_rnn_in"))                  # (B, T, D_rnn)
    gate = gelu(dot(x, w("w_gate_in")))             # (B, T, D_rnn)
    conv_state = state.conv if state is not None else None
    rnn_in, new_conv = _causal_conv(p, rnn_in, conv_state)
    if x.shape[1] == 1 and state is not None:
        y, h_new = rg_lru_step(p, rnn_in[:, 0], state.h)
        y = y[:, None]
    else:
        h0 = state.h if state is not None else None
        y, h_new = rg_lru_scan(p, rnn_in, h0)
    if ctx is not None:
        y = ctx.act(f"{prefix}/lru_out", y)
    out = dot(y * gate, w("w_out"))
    new_state = RGLRUState(h=h_new, conv=new_conv) if state is not None \
        else None
    return out, new_state


def init_rglru_state(batch: int, d_rnn: int, conv_width: int = 4,
                     device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_width - 1, d_rnn), dtype=torch.float32,
                         device=device))


def init_recurrent_params(gen, d_model: int, d_rnn: int, dtype=torch.float32,
                          device=None, conv_width: int = 4):
    """The reference's distributions (drawn from ``gen``)."""
    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)
    p = {"w_rnn_in": dense_init(gen, d_model, d_rnn, dtype, device=device),
         "w_gate_in": dense_init(gen, d_model, d_rnn, dtype, device=device),
         "w_out": dense_init(gen, d_rnn, d_model, dtype, device=device)}
    p["conv_w"] = (torch.randn((conv_width, d_rnn), generator=gen,
                               device=device) * 0.1).to(dtype)
    p["conv_b"] = zeros(d_rnn)
    p["w_a"] = dense_init(gen, d_rnn, d_rnn, dtype, device=device)
    p["b_a"] = zeros(d_rnn)
    p["w_x"] = dense_init(gen, d_rnn, d_rnn, dtype, device=device)
    p["b_x"] = zeros(d_rnn)
    p["lam"] = torch.linspace(0.5, 4.0, d_rnn, device=device).to(dtype)
    return p
