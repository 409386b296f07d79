"""Quantization-aware training with learnable ranges (paper §4 "QAT"; port
of ``repro.core.qat``).

Every quantizer's scale (and, for asymmetric activations, offset) is a
trainable tensor initialized from the PTQ estimate and optimized jointly
with the weights through the STE / LSQ gradients of
``core.quantizer.fake_quant``. The scale is stored as log(s) for
positivity; the asymmetric zero-point is a continuous offset (LSQ+-style)
rounded with STE where it is used.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.quant_config import QuantizerConfig, RangeEstimator
from repro_torch.core.quantizer import (QuantParams, clip, fake_quant,
                                        round_ste)
from repro_torch.core.range_estimation import estimate_weight_params


def init_qat_params(act_state: Dict[str, QuantParams],
                    weight_state: Dict[str, QuantParams]) -> dict:
    """Trainable tree ``{"act": {site: leaves}, "weight": {...}}``, each
    site ``{"log_scale", "offset"}``, initialized from PTQ parameters."""
    def to_learnable(qp: QuantParams):
        return {"log_scale": torch.log(torch.clamp_min(qp.scale, 1e-8)),
                "offset": qp.zero_point.float()}
    return {
        "act": {site: to_learnable(qp) for site, qp in act_state.items()},
        "weight": {site: to_learnable(qp)
                   for site, qp in weight_state.items()},
    }


def _materialize(learnable: dict, template: QuantParams,
                 cfg: QuantizerConfig, grad_scale) -> QuantParams:
    """QuantParams from the learnable leaves. LSQ gradient scaling (Esser
    et al. 2019, eq. 5): ``v * g + (v * (1 - g)).detach()`` has ``v``'s
    value (as the reference computes it) and ``g`` times its gradient."""
    def gscale(v):
        return v * grad_scale + (v * (1.0 - grad_scale)).detach()
    scale = torch.exp(gscale(learnable["log_scale"]))
    if cfg.symmetric:
        zp = torch.zeros_like(scale)
    else:
        zp = clip(round_ste(gscale(learnable["offset"])), cfg.qmin, cfg.qmax)
    return QuantParams(scale=scale, zero_point=zp,
                       group_index=template.group_index)


def _lsq_grad_scale(x: torch.Tensor, cfg: QuantizerConfig) -> torch.Tensor:
    n = torch.full((), float(x.numel() * max(cfg.qmax, 1)),
                   dtype=torch.float32, device=x.device)
    return torch.rsqrt(n)


def apply_act(ctx, site: str, x: torch.Tensor, cfg: QuantizerConfig):
    learnable = (ctx.qat_params or {}).get("act", {}).get(site)
    template = (ctx.act_state or {}).get(site)
    if learnable is None or template is None:
        return x
    qp = _materialize(learnable, template, cfg, _lsq_grad_scale(x, cfg))
    return fake_quant(x, qp, cfg)


def apply_weight(ctx, site: str, w: torch.Tensor, cfg: QuantizerConfig):
    learnable = (ctx.qat_params or {}).get("weight", {}).get(site)
    template = (ctx.weight_state or {}).get(site)
    if learnable is None or template is None:
        # weight sites absent from the PTQ state fall back to on-the-fly
        # min-max fake-quant, so QAT still sees quantization noise there
        cheap = dataclasses.replace(
            cfg, estimator=RangeEstimator.CURRENT_MINMAX)
        return fake_quant(w, estimate_weight_params(w, cheap), cheap)
    qp = _materialize(learnable, template, cfg, _lsq_grad_scale(w, cfg))
    return fake_quant(w, qp, cfg)
