"""RWKV-6 "Finch" (arXiv:2404.05892; port of ``repro.models.rwkv6``) —
attention-free time-mix with data-dependent per-channel decay and a
squared-ReLU channel-mix.

Recurrence per head (dk = dv = head_size):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Prefill and training use the chunked gated-linear-attention form
(``wkv_chunked``): intra-chunk pairwise decays through a masked einsum
(the exponents are differences of a non-increasing cumulative log-decay,
always <= 0), inter-chunk through the state carried chunk after chunk.
``wkv_sequential`` is the step-by-step oracle (tests only); decode is the
O(1) ``wkv_step``.

As in the reference, the five token-shift interpolations use static learned
mu (the low-rank data-dependent delta applies to the decay only), and the
decay LoRA is one down/up pair.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, dot

MIN_LOG_W = -8.0     # clamp per-step log-decay for numerical safety


class RWKVState(NamedTuple):
    s: torch.Tensor          # (B, H, dk, dv) f32 wkv state
    x_tm: torch.Tensor       # (B, D) f32 last input of time-mix
    x_cm: torch.Tensor       # (B, D) f32 last input of channel-mix


def _token_shift(x, x_last, mu):
    """x: (B, T, D); the mu-interpolation of [x_{t-1}, x_t]."""
    prev = torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return (x + (prev - x) * mu.to(x.dtype)).to(x.dtype)


def _decay(p, xw):
    """Data-dependent per-channel log-decay, clamped to [MIN_LOG_W, 0]."""
    lora = dot(torch.tanh(dot(xw, p["w_lora_a"])), p["w_lora_b"])
    logw = -torch.exp(torch.clamp(p["w_base"] + lora, -20.0, 4.0))
    return torch.clamp(logw, MIN_LOG_W, 0.0)            # (B, T, D)


def wkv_sequential(r, k, v, logw, u, s0=None):
    """Oracle: the step-by-step recurrence. r/k: (B, H, T, dk), v: (B, H,
    T, dv), logw: (B, H, T, dk), u: (H, dk)."""
    B, H, T, dk = k.shape
    s = torch.zeros((B, H, dk, v.shape[-1]), dtype=torch.float32,
                    device=k.device) if s0 is None else s0
    outs = []
    for t in range(T):
        o, s = wkv_step(r[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t],
                        u, s)
        outs.append(o)
    return torch.stack(outs, dim=2), s


def wkv_chunked(r, k, v, logw, u, s0=None, chunk: int = 32):
    """Chunked GLA form; matches wkv_sequential. Shapes as there; T must be
    a multiple of ``chunk`` (callers pad)."""
    B, H, T, dk = k.shape
    dv = v.shape[-1]
    n = T // chunk
    rc = r.reshape(B, H, n, chunk, dk).float()
    kc = k.reshape(B, H, n, chunk, dk).float()
    vc = v.reshape(B, H, n, chunk, dv).float()
    lw = logw.reshape(B, H, n, chunk, dk).float()

    # cumulative log decay inclusive of step t: cl_t = sum_{s<=t} logw_s
    cl = torch.cumsum(lw, dim=3)                               # (B,H,n,C,dk)
    # intra-chunk pairwise decays: for t > s, exp(cl_{t-1} - cl_s) (the
    # state o_t reads, S_{t-1}, excludes step t's own decay)
    cl_tm1 = cl - lw
    diff = cl_tm1[..., :, None, :] - cl[..., None, :, :]       # (.., t, s, dk)
    tmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=k.device), diagonal=-1)[..., None]
    dec = torch.where(tmask, torch.exp(torch.where(tmask, diff, 0.0)), 0.0)
    scores = torch.einsum("bhntk,bhnsk,bhntsk->bhnts", rc, kc, dec)
    o_intra = torch.einsum("bhnts,bhnsv->bhntv", scores, vc)
    # bonus diagonal term: r_t (u * k_t) v_t
    bonus = torch.einsum("bhntk,hk,bhntk->bhnt", rc, u.float(), kc)
    o_intra = o_intra + bonus[..., None] * vc

    # inter-chunk: carry the state across chunks
    s = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=k.device) \
        if s0 is None else s0.float()
    # each chunk's contribution to the next state:
    # sum_s exp(cl_C - cl_s) k_s v_s^T
    end_dec = torch.exp(cl[..., -1:, :] - cl)                  # (B,H,n,C,dk)
    chunk_kv = torch.einsum("bhnsk,bhnsv->bhnkv", kc * end_dec, vc)
    chunk_decay = torch.exp(cl[..., -1, :])                    # (B,H,n,dk)
    r_dec = rc * torch.exp(cl_tm1)
    o_inter = []
    for i in range(n):
        # o_inter_t = (r_t * exp(cl_{t-1})) @ s
        o_inter.append(torch.einsum("bhtk,bhkv->bhtv", r_dec[:, :, i], s))
        s = chunk_decay[:, :, i, :, None] * s + chunk_kv[:, :, i]
    o = o_intra + torch.stack(o_inter, dim=2)
    return o.reshape(B, H, T, dv).to(r.dtype), s


def wkv_step(r_t, k_t, v_t, logw_t, u, s):
    """Decode: one token. r_t/k_t: (B, H, dk), v_t: (B, H, dv)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r_t, s + u[None, :, :, None] * kv)
    s_new = torch.exp(logw_t)[..., None] * s + kv
    return o, s_new


# ---------------------------------------------------------------------------
# Full blocks
# ---------------------------------------------------------------------------

def _group_norm(x, gamma, beta, eps: float = 1e-5):
    """Per-head layer norm of (B, H, T, dv): the mean and the population
    variance (``jnp.var``: no correction) reduced in f32, returned in
    ``x``'s dtype, as the reference's ``jnp.mean`` / ``jnp.var`` do."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True).to(x.dtype)
    var = xf.var(-1, correction=0, keepdim=True).to(x.dtype)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def time_mix(p, x, head_size: int, *, state: Optional[RWKVState] = None,
             ctx=None, prefix: str = "tmix", chunk: int = 32):
    """RWKV-6 time-mix. x: (B, T, D). Returns (out, the state with ``s``
    and ``x_tm`` replaced, or None); the caller writes the state back."""
    B, T, D = x.shape
    H = D // head_size

    def w(name):
        return ctx.weight(f"{prefix}/{name}", p[name]) if ctx is not None \
            else p[name]

    def heads(y):
        return y.reshape(B, T, H, head_size).transpose(1, 2)

    x_last = state.x_tm if state is not None else \
        torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xr = _token_shift(x, x_last, p["mu_r"])
    xk = _token_shift(x, x_last, p["mu_k"])
    xv = _token_shift(x, x_last, p["mu_v"])
    xw = _token_shift(x, x_last, p["mu_w"])
    xg = _token_shift(x, x_last, p["mu_g"])

    r = heads(dot(xr, w("w_r")))
    k = heads(dot(xk, w("w_k")))
    v = heads(dot(xv, w("w_v")))
    g = F.silu(dot(xg, w("w_g")))
    logw = heads(_decay(p, xw))
    if ctx is not None:
        r = ctx.act(f"{prefix}/r", r)
        k = ctx.act(f"{prefix}/k", k)
        v = ctx.act(f"{prefix}/v", v)

    s0 = state.s if state is not None else None
    if T == 1 and state is not None:
        o, s_new = wkv_step(r[:, :, 0].float(), k[:, :, 0].float(),
                            v[:, :, 0].float(), logw[:, :, 0].float(),
                            p["u"], s0)
        o = o[:, :, None].to(r.dtype)
        s_new = s_new.to(s0.dtype)
    else:
        pad = (-T) % chunk
        if pad:
            o, s_new = wkv_chunked(*(F.pad(y, (0, 0, 0, pad))
                                     for y in (r, k, v, logw)),
                                   p["u"], s0, chunk)
            o = o[:, :, :T]
        else:
            o, s_new = wkv_chunked(r, k, v, logw, p["u"], s0, chunk)
    o = _group_norm(o, p["gn_g"], p["gn_b"])
    o = o.transpose(1, 2).reshape(B, T, D)
    out = dot(o * g, w("w_o"))
    if ctx is not None:
        out = ctx.act(f"{prefix}/out", out)
    new_state = None
    if state is not None:
        new_state = state._replace(s=s_new, x_tm=x[:, -1].float())
    return out, new_state


def channel_mix(p, x, *, state: Optional[RWKVState] = None, ctx=None,
                prefix: str = "cmix"):
    """RWKV-6 channel-mix (the FFN analogue, where the paper's PEG
    applies)."""
    B, T, D = x.shape

    def w(name):
        return ctx.weight(f"{prefix}/{name}", p[name]) if ctx is not None \
            else p[name]

    x_last = state.x_cm if state is not None else \
        torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xk = _token_shift(x, x_last, p["mu_ck"])
    xr = _token_shift(x, x_last, p["mu_cr"])
    if ctx is not None:
        xk = ctx.act(f"{prefix}/ffn_in", xk)
    k = torch.square(torch.relu(dot(xk, w("w_ck"))))
    out = torch.sigmoid(dot(xr, w("w_cr"))) * dot(k, w("w_cv"))
    if ctx is not None:
        out = ctx.act(f"{prefix}/ffn_out", out)
    new_state = None
    if state is not None:
        new_state = state._replace(x_cm=x[:, -1].float())
    return out, new_state


def init_rwkv_state(batch: int, d_model: int, head_size: int,
                    device=None) -> RWKVState:
    H = d_model // head_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return RWKVState(s=zeros(batch, H, head_size, head_size),
                     x_tm=zeros(batch, d_model), x_cm=zeros(batch, d_model))


def init_rwkv_params(gen, d_model: int, d_ff: int, head_size: int,
                     dtype=torch.float32, device=None, lora_rank: int = 64):
    """The reference's distributions (drawn from ``gen``), time-mix and
    channel-mix leaves in one dict (``init_block_params`` splits them)."""
    H = d_model // head_size

    def dense(a, b):
        return dense_init(gen, a, b, dtype, device=device)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def full(value, n=d_model):
        return torch.full((n,), value, dtype=dtype, device=device)
    p = {"w_r": dense(d_model, d_model), "w_k": dense(d_model, d_model),
         "w_v": dense(d_model, d_model), "w_g": dense(d_model, d_model),
         "w_o": dense(d_model, d_model),
         "w_lora_a": dense(d_model, lora_rank)}
    p["w_lora_b"] = randn(lora_rank, d_model, scale=0.01)
    p["w_base"] = full(0.5)
    p["u"] = randn(H, head_size, scale=0.1)
    p["gn_g"] = full(1.0, head_size)
    p["gn_b"] = full(0.0, head_size)
    p["w_ck"] = dense(d_model, d_ff)
    p["w_cv"] = dense(d_ff, d_model)
    p["w_cr"] = dense(d_model, d_model)
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr"):
        p[name] = full(0.5)
    return p
