"""Uniform affine quantization (paper eq. 1-2): the simulated-quantization
forward with straight-through gradients, the scale / zero-point derivation,
the integer grid and the quant-health statistics (port of
``repro.core.quantizer``).

Gradients: with grad mode on and an input that requires grad,
:func:`fake_quant` takes the STE gradient in ``x`` (identity through the
rounding, zero outside the clip range) and the LSQ gradients in ``scale`` /
``zero_point`` (Esser et al. 2019), with the reference's rules at ties:
``max(s, tiny)`` and the clip at exactly ``qmin`` / ``qmax`` pass half the
gradient to each side, as ``jnp.maximum`` and ``jnp.clip`` do (``torch.clamp``
would pass all of it). Otherwise it dispatches the plain operators only;
both branches compute the same values bit for bit."""
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


class _RoundSTE(torch.autograd.Function):
    """Round to nearest (ties to even) with an identity gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """``torch.round`` whose gradient is the identity (the reference's
    ``_round_ste``)."""
    return _RoundSTE.apply(x)


def _bound(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


class _ClipHalfTies(torch.autograd.Function):
    """``torch.clamp`` whose gradient is 1 strictly inside the bounds, 1/2
    exactly on a bound and 0 outside, as ``jnp.clip``'s (``torch.clamp``
    passes all of it on a bound)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        ties = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * ties), None, None


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` (``lo`` / ``hi`` numbers): the values of
    ``torch.clamp``, half the gradient exactly on a bound."""
    return _ClipHalfTies.apply(x, lo, hi)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


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
    the input dtype. Differentiable in ``x`` (STE) and in ``qp.scale`` /
    ``qp.zero_point`` (LSQ) when grad mode is on (module docstring)."""
    if not cfg.enabled:
        return x
    s, z = _expand(qp, x.dim(), cfg.channel_axis)
    if _needs_grad(x, s, z):
        s = torch.maximum(s.float(), _bound(TINY, s.float()))
        q = clip(round_ste(x.float() / s) + z, cfg.qmin, cfg.qmax)
        return ((q - z) * s).to(x.dtype)
    s = torch.clamp_min(s.float(), TINY)
    q = torch.round(x.float() / s) + z
    q = torch.clamp(q, cfg.qmin, cfg.qmax)
    return ((q - z) * s).to(x.dtype)


def quantize(x: torch.Tensor, qp: QuantParams,
             cfg: QuantizerConfig) -> torch.Tensor:
    """To the integer grid (eq. 1): int32 in [qmin, qmax]."""
    s, z = _expand(qp, x.dim(), cfg.channel_axis)
    s = torch.clamp_min(s, TINY)
    q = torch.round(x.float() / s) + z
    return torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QuantParams,
               cfg: QuantizerConfig) -> torch.Tensor:
    """eq. (2), in f32."""
    s, z = _expand(qp, q.dim(), cfg.channel_axis)
    return (q.float() - z) * s


def quant_error(x: torch.Tensor, qp: QuantParams,
                cfg: QuantizerConfig) -> torch.Tensor:
    """Mean squared quantization error (the MSE estimator's objective)."""
    return torch.mean(torch.square(x - fake_quant(x, qp, cfg)))


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


def telemetry_stats(x: torch.Tensor, qp: QuantParams,
                    cfg: QuantizerConfig) -> torch.Tensor:
    """Quant-health vector ``[n_clipped, n_total, amax, cal_range]`` (4,)
    f32 on ``x``'s device, on :func:`fake_quant`'s grid: a value counts as
    clipped when its integer image before the clamp lies outside [qmin,
    qmax]. ``cal_range`` is the largest magnitude the calibrated grid can
    represent (the max over channels / groups of ``max(|s*(qmin-z)|,
    |s*(qmax-z)|)``), so ``amax / cal_range > 1`` means traffic exceeded
    calibration."""
    s, z = _expand(qp, x.dim(), cfg.channel_axis)
    s = torch.clamp_min(s.float(), TINY)
    xf = x.float()
    t = torch.round(xf / s) + z
    clipped = ((t < cfg.qmin) | (t > cfg.qmax)).sum()
    cal_range = torch.maximum((s * (cfg.qmin - z)).abs(),
                              (s * (cfg.qmax - z)).abs()).max()
    return site_vector(clipped, xf.numel(), xf.abs().max(), cal_range)


def site_vector(clipped, n_total: int, amax, cal_range) -> torch.Tensor:
    """A site's (4,) f32 vector on ``amax``'s device; the element count is
    a device fill, not a copy from the host."""
    n = torch.full((), n_total, dtype=torch.float32, device=amax.device)
    return torch.stack([clipped.float(), n, amax.float(),
                        cal_range.float()])
