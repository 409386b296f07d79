"""Static range estimators (paper §2, App. B.2; port of
``repro.core.range_estimation``): current min-max, running min-max (EMA)
and the MSE grid search, all granularity-aware."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.quant_config import (Granularity, QuantizerConfig,
                                           RangeEstimator)
from repro_torch.core.quantizer import (QuantParams, fake_quant,
                                        params_from_range, reduce_range)


class RangeState(NamedTuple):
    """Accumulated range statistics across calibration batches."""
    x_min: Optional[torch.Tensor] = None
    x_max: Optional[torch.Tensor] = None
    initialized: bool = False


def init_range_state() -> RangeState:
    return RangeState()


def _group_reduce(mn, mx, group_index, num_groups: int):
    """Per-dim (d,) ranges -> per-group (K,) ranges (min of mins, max of
    maxs)."""
    gmin = torch.full((num_groups,), float("inf"), device=mn.device)
    gmax = torch.full((num_groups,), float("-inf"), device=mx.device)
    return (gmin.scatter_reduce(0, group_index, mn.float(), reduce="amin"),
            gmax.scatter_reduce(0, group_index, mx.float(), reduce="amax"))


def observe(state: RangeState, x: torch.Tensor,
            cfg: QuantizerConfig) -> RangeState:
    """Update range statistics with one calibration batch."""
    if cfg.granularity == Granularity.PER_EMBEDDING_GROUP:
        # per-dim stats; grouping happens in finalize (the permutation is
        # derived from these very ranges)
        per_dim = QuantizerConfig(bits=cfg.bits, symmetric=cfg.symmetric,
                                  granularity=Granularity.PER_EMBEDDING,
                                  channel_axis=cfg.channel_axis)
        mn, mx = reduce_range(x, per_dim)
    else:
        mn, mx = reduce_range(x, cfg)
    mn, mx = mn.float(), mx.float()
    if not state.initialized:
        return RangeState(mn, mx, True)
    if cfg.estimator == RangeEstimator.RUNNING_MINMAX:
        m = cfg.ema_momentum
        return RangeState(m * state.x_min + (1 - m) * mn,
                          m * state.x_max + (1 - m) * mx, True)
    # current min-max and MSE track the envelope; MSE shrinks it later
    return RangeState(torch.minimum(state.x_min, mn),
                      torch.maximum(state.x_max, mx), True)


def mse_ratios(points: int, device=None) -> torch.Tensor:
    """The candidate shrink ratios, bit-identical to the reference's
    ``jnp.linspace(1 / points, 1, points)`` as XLA evaluates it on the CPU:
    ``fma(i, stop * c, start * (1 - i * c))`` in f32 with
    ``c = f32(1 / (n - 1))`` (the fused multiply-add is emulated in f64,
    where the f32 product is exact)."""
    f32 = np.float32
    start, stop = f32(1.0 / points), f32(1.0)
    c = f32(1.0) / f32(points - 1)
    i = np.arange(points - 1, dtype=f32)
    head = start * (f32(1.0) - i * c)
    r = (i.astype(np.float64) * np.float64(stop * c) + head).astype(f32)
    return torch.from_numpy(np.append(r, stop)).to(device)


def mse_search(x: torch.Tensor, x_min: torch.Tensor, x_max: torch.Tensor,
               cfg: QuantizerConfig,
               group_index: Optional[torch.Tensor] = None) -> QuantParams:
    """Grid search over symmetric shrink ratios of [x_min, x_max], keeping
    the candidate with the least squared quantization error on ``x`` (the
    first minimum wins, as argmin does). Candidates are evaluated one at a
    time, so memory stays at a few copies of ``x`` whatever the grid size."""
    ratios = mse_ratios(cfg.mse_grid_points, x.device)
    x_min, x_max = x_min.float(), x_max.float()
    best_err = best_ratio = None
    for ratio in ratios:
        qp = params_from_range(x_min * ratio, x_max * ratio, cfg,
                               group_index=group_index)
        e = torch.square(x - fake_quant(x, qp, cfg))
        if cfg.granularity == Granularity.PER_TENSOR:
            err = torch.mean(e)
        else:
            axis = cfg.channel_axis % x.dim()
            red = tuple(a for a in range(x.dim()) if a != axis)
            err = torch.mean(e, dim=red)
            if group_index is not None:          # PEG: (d,) -> (K,)
                k = int(qp.scale.shape[0])
                err = torch.zeros(k, dtype=err.dtype,
                                  device=err.device).index_add_(
                                      0, group_index, err)
        if best_err is None:
            best_err, best_ratio = err, ratio.expand_as(err).clone()
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_ratio = torch.where(better, ratio, best_ratio)
    if group_index is not None:
        gmin, gmax = _group_reduce(x_min, x_max, group_index,
                                   int(best_ratio.shape[0]))
        return params_from_range(gmin * best_ratio, gmax * best_ratio, cfg,
                                 group_index=group_index)
    return params_from_range(x_min * best_ratio, x_max * best_ratio, cfg,
                             group_index=group_index)


def finalize(state: RangeState, cfg: QuantizerConfig,
             calib_tensor: Optional[torch.Tensor] = None,
             group_index: Optional[torch.Tensor] = None) -> QuantParams:
    """Turn accumulated statistics into QuantParams (``group_index`` maps
    embedding dims to PEG groups; MSE needs a calibration tensor)."""
    x_min, x_max = state.x_min, state.x_max
    if cfg.estimator == RangeEstimator.MSE and calib_tensor is None:
        raise ValueError("MSE estimator needs a calibration tensor")
    if cfg.granularity == Granularity.PER_EMBEDDING_GROUP:
        if group_index is None:
            raise ValueError("PEG finalize requires group_index")
        if cfg.estimator == RangeEstimator.MSE:
            return mse_search(calib_tensor, x_min, x_max, cfg, group_index)
        gmin, gmax = _group_reduce(x_min, x_max, group_index,
                                   int(group_index.max()) + 1)
        return params_from_range(gmin, gmax, cfg, group_index=group_index)
    if cfg.estimator == RangeEstimator.MSE:
        return mse_search(calib_tensor, x_min, x_max, cfg)
    return params_from_range(x_min, x_max, cfg)


def estimate_weight_params(w: torch.Tensor, cfg: QuantizerConfig,
                           split=None) -> QuantParams:
    """One-shot range estimation for a static weight tensor.

    ``split`` (dist, dim): ``w`` is this rank's slice of a weight whose dim
    ``dim`` is cut over the ``model`` axis of ``dist``; the grid returned is
    the whole weight's, for this rank's channels. Where the cut dim is the
    channel axis of a per-channel grid each rank holds whole channels and
    estimates them alone; otherwise min-max reduces its ranges over the
    ranks, and the MSE search runs on the whole weight, gathered for the
    estimate alone. The gradients through the grid reach every rank's
    slice as the whole weight's would (``parallel.collectives``
    ``min_over`` / ``max_over`` / ``gather_weight``)."""
    if split is not None:
        dist, dim = split
        dim %= w.dim()
        whole_channels = (cfg.granularity != Granularity.PER_TENSOR
                          and cfg.channel_axis % w.dim() == dim)
        if not whole_channels:
            from repro_torch.parallel import collectives as coll
            if cfg.estimator == RangeEstimator.MSE:
                return estimate_weight_params(
                    coll.gather_weight(w, dist, dim), cfg)
            mn, mx = reduce_range(w, cfg)
            return params_from_range(coll.min_over(mn, dist),
                                     coll.max_over(mx, dist), cfg)
    mn, mx = reduce_range(w, cfg)
    if cfg.estimator == RangeEstimator.MSE:
        return mse_search(w, mn, mx, cfg)
    return params_from_range(mn, mx, cfg)
