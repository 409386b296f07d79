"""Post-training-quantization pipeline (paper §5 setup; port of
``repro.core.pipeline``):

    model + calibration batches + policy
        -> collect activation ranges (static range estimation)
        -> build PEG groups (range-based permutation) where the policy asks
        -> finalize activation QuantParams
        -> estimate weight QuantParams for the named weights
        -> optional AdaRound refinement of selected weights
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.adaround import AdaRoundConfig, optimize_rounding
from repro_torch.core.calibration import (Mode, QuantCtx, build_act_state,
                                          build_weight_state, collect_ranges)
from repro_torch.core.quant_config import QuantizationPolicy
from repro_torch.core.range_estimation import estimate_weight_params


@dataclasses.dataclass
class QuantizedModel:
    """Frozen PTQ artifact: everything needed to run quantized inference."""
    policy: QuantizationPolicy
    act_state: dict
    weight_state: dict
    peg_specs: dict
    adarounded_weights: dict = dataclasses.field(default_factory=dict)
    # site -> hard-rounded weight tensor (AdaRound)

    def ctx(self) -> QuantCtx:
        return QuantCtx(policy=self.policy, mode=Mode.APPLY,
                        act_state=self.act_state,
                        weight_state=self.weight_state)


def ptq(forward: Callable, params, calib_batches: Sequence,
        policy: QuantizationPolicy, *,
        named_weights: Optional[Dict[str, torch.Tensor]] = None,
        tp_shards: int = 1, adaround_sites: Optional[dict] = None,
        adaround_cfg: AdaRoundConfig = AdaRoundConfig(),
        collect_inputs: bool = False) -> QuantizedModel:
    """Run the PTQ pipeline. ``forward(params, batch, ctx)`` must call the
    ctx at its sites; ``adaround_sites`` maps a weight site to (weight,
    calibration inputs of its layer) for AdaRound refinement;
    ``collect_inputs`` also calibrates the matmul-input sites the integer
    deploy path needs."""
    range_states, calib_tensors = collect_ranges(
        forward, params, calib_batches, policy,
        collect_inputs=collect_inputs)
    act_state, peg_specs = build_act_state(range_states, calib_tensors,
                                           policy, tp_shards=tp_shards)
    weight_state = build_weight_state(named_weights or {}, policy)
    adarounded = {}
    for site, (w, x_in) in (adaround_sites or {}).items():
        cfg = policy.weight_config(site)
        qp = weight_state.get(site)
        if qp is None:
            qp = estimate_weight_params(w, cfg)
        adarounded[site], _ = optimize_rounding(w, x_in, qp, cfg,
                                                adaround_cfg)
    return QuantizedModel(policy=policy, act_state=act_state,
                          weight_state=weight_state, peg_specs=peg_specs,
                          adarounded_weights=adarounded)
