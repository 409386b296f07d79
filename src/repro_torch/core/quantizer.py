"""Uniform affine quantization (paper eq. 1-2): the simulated-quantization
forward and the scale / zero-point derivation (port of
``repro.core.quantizer``; the straight-through gradient and the telemetry
statistics come with the training and telemetry slices)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.quant_config import Granularity, QuantizerConfig

TINY = torch.finfo(torch.float32).tiny


class QuantParams(NamedTuple):
    """Quantization parameters for one tensor site.

    scale / zero_point shapes by granularity:
      PER_TENSOR           -> ()
      PER_CHANNEL          -> (C,) along ``channel_axis``
      PER_EMBEDDING        -> (d,) along ``channel_axis``
      PER_EMBEDDING_GROUP  -> (K,), expanded through ``group_index`` (d,)
    """
    scale: torch.Tensor
    zero_point: torch.Tensor
    group_index: Optional[torch.Tensor] = None


def _expand(qp: QuantParams, ndim: int, channel_axis: int):
    """Broadcast scale / zero-point to the tensor rank along channel_axis."""
    s, z = qp.scale, qp.zero_point
    if qp.group_index is not None:        # PEG: (K,) -> (d,)
        s = s[qp.group_index]
        z = z[qp.group_index]
    if s.dim() == 0:
        return s, z
    shape = [1] * ndim
    shape[channel_axis % ndim] = s.shape[0]
    return s.reshape(shape), z.reshape(shape)


def fake_quant(x: torch.Tensor, qp: QuantParams,
               cfg: QuantizerConfig) -> torch.Tensor:
    """Simulated quantization: eq. (1) then eq. (2), in f32, cast back to
    the input dtype."""
    if not cfg.enabled:
        return x
    s, z = _expand(qp, x.dim(), cfg.channel_axis)
    s = torch.clamp_min(s.float(), TINY)
    q = torch.round(x.float() / s) + z
    q = torch.clamp(q, cfg.qmin, cfg.qmax)
    return ((q - z) * s).to(x.dtype)


def params_from_range(x_min: torch.Tensor, x_max: torch.Tensor,
                      cfg: QuantizerConfig,
                      group_index: Optional[torch.Tensor] = None
                      ) -> QuantParams:
    """Scale / zero-point from an estimated real-valued range: symmetric
    around 0 for weights, an affine grid with an integer zero-point for
    activations. The grid always contains 0."""
    x_min = torch.clamp_max(x_min.float(), 0.0)
    x_max = torch.clamp_min(x_max.float(), 0.0)
    if cfg.symmetric:
        amax = torch.maximum(x_min.abs(), x_max.abs())
        scale = torch.clamp_min(amax / cfg.qmax, TINY)
        zp = torch.zeros_like(scale)
    else:
        scale = torch.clamp_min((x_max - x_min) / cfg.num_levels, TINY)
        zp = torch.clamp(torch.round(-x_min / scale), cfg.qmin, cfg.qmax)
    return QuantParams(scale=scale, zero_point=zp, group_index=group_index)


def reduce_range(x: torch.Tensor, cfg: QuantizerConfig):
    """(min, max) over all axes except the channel axis (if any)."""
    if cfg.granularity == Granularity.PER_TENSOR:
        return x.min(), x.max()
    axis = cfg.channel_axis % x.dim()
    red = tuple(a for a in range(x.dim()) if a != axis)
    return torch.amin(x, dim=red), torch.amax(x, dim=red)
