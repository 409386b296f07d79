"""AdaRound — adaptive rounding for post-training quantization (Nagel et
al. 2020; paper Table 7 "W4A32 AdaRound"; port of ``repro.core.adaround``).

Per linear layer, instead of rounding to nearest, learn a per-weight
rounding direction by minimizing the layer-wise reconstruction loss

    L(V) = || X W - X W_q(V) ||^2 / n + lam * sum(1 - |2 h(V) - 1|^beta)

where h(V) = clip(sigmoid(V) * (zeta - gamma) + gamma, 0, 1) is the
rectified sigmoid and beta is annealed high -> low, so the regularizer
first lets h move freely, then forces it to {0, 1}. Final weights use hard
rounding floor(W/s) + (h(V) > 0.5).

Batches are drawn with a ``torch.Generator`` on the weight's device seeded
from ``seed`` (the reference draws them with ``jax.random``, so the two
trajectories differ; single steps agree on the same batch indices).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quant_config import QuantizerConfig
from repro_torch.core.quantizer import QuantParams, _expand, clip
from repro_torch.optim.adam import adam_init, adam_update, apply_updates

ZETA, GAMMA = 1.1, -0.1


@dataclasses.dataclass(frozen=True)
class AdaRoundConfig:
    iterations: int = 10_000
    lr: float = 1e-2
    reg_lambda: float = 0.01
    beta_start: float = 20.0
    beta_end: float = 2.0
    warmup_frac: float = 0.2     # no regularization for the first 20%
    batch_size: int = 256


def _rectified_sigmoid(v):
    return clip(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def _soft_quant(w, v, qp: QuantParams, cfg: QuantizerConfig):
    s, z = _expand(qp, w.dim(), cfg.channel_axis)
    wq = torch.floor(w / s) + _rectified_sigmoid(v) + z
    return (clip(wq, cfg.qmin, cfg.qmax) - z) * s


def init_v(w, qp: QuantParams, cfg: QuantizerConfig):
    """V such that h(V) equals the rounding residual, i.e. the
    soft-quantized weight starts at the real-valued weight."""
    s, _ = _expand(qp, w.dim(), cfg.channel_axis)
    rest = w / s - torch.floor(w / s)
    rest = torch.clamp(rest, 1e-4, 1.0 - 1e-4)
    p = (rest - GAMMA) / (ZETA - GAMMA)
    return -torch.log(1.0 / p - 1.0)                 # logit


def beta_at(i: int, ar_cfg: AdaRoundConfig) -> float:
    """The annealed exponent at iteration ``i`` (cosine, after warmup)."""
    total = ar_cfg.iterations
    warm = int(total * ar_cfg.warmup_frac)
    t = min(max((i - warm) / max(total - warm, 1), 0.0), 1.0)
    return ar_cfg.beta_end + (ar_cfg.beta_start - ar_cfg.beta_end) * \
        0.5 * (1 + math.cos(math.pi * t))


def rounding_loss(v, w, xb, yb, i: int, qp: QuantParams,
                  cfg: QuantizerConfig, ar_cfg: AdaRoundConfig):
    """The reconstruction loss on one batch plus the annealed regularizer
    (zero during warmup)."""
    wq = _soft_quant(w, v, qp, cfg)
    rec = torch.mean(torch.square(xb @ wq - yb))
    if i < int(ar_cfg.iterations * ar_cfg.warmup_frac):
        return rec
    h = _rectified_sigmoid(v)
    reg = torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta_at(i, ar_cfg))
    return rec + ar_cfg.reg_lambda * reg


def optimize_rounding(w: torch.Tensor, x_calib: torch.Tensor,
                      qp: QuantParams, cfg: QuantizerConfig,
                      ar_cfg: AdaRoundConfig = AdaRoundConfig(),
                      seed: int = 0):
    """AdaRound for one linear layer ``y = x @ w`` (w: [d_in, d_out]).

    x_calib: (N, d_in) calibration inputs of this layer (FP32
    activations). Returns the hard-rounded (dequantized) weight and the
    learned soft rounding h(V) for inspection."""
    w = w.detach()
    x_calib = x_calib.detach()
    with torch.no_grad():
        v = init_v(w, qp, cfg)
        y_ref_full = x_calib @ w
    opt_state = adam_init(v)
    n = x_calib.shape[0]
    bs = min(ar_cfg.batch_size, n)
    gen = torch.Generator(device=w.device).manual_seed(seed)
    for i in range(ar_cfg.iterations):
        idx = torch.randint(0, n, (bs,), generator=gen, device=w.device)
        xb, yb = x_calib[idx], y_ref_full[idx]
        v.requires_grad_(True)
        with torch.enable_grad():
            loss = rounding_loss(v, w, xb, yb, i, qp, cfg, ar_cfg)
            g, = torch.autograd.grad(loss, v)
        upd, opt_state = adam_update(g, opt_state, v, lr=ar_cfg.lr)
        v = apply_updates(v.detach(), upd)

    with torch.no_grad():
        s, z = _expand(qp, w.dim(), cfg.channel_axis)
        h = _rectified_sigmoid(v)
        hard = torch.floor(w / s) + (h > 0.5).to(w.dtype) + z
        w_hard = (torch.clamp(hard, cfg.qmin, cfg.qmax) - z) * s
    return w_hard.to(w.dtype), h
