"""Mixed-precision utilities (paper §4 "Mixed precision PTQ", Table 4;
port of ``repro.core.mixed_precision``).

The policy itself is ``quant_config.mixed_precision_policy``; this module
adds the paper's accounting (what fraction of activation quantizers run at
16-bit — "36 out of 161 for BERT-base") and the leave-one-out sensitivity
sweep of Table 2.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.quant_config import FP32, QuantizationPolicy


def quantizer_census(policy: QuantizationPolicy, sites: Sequence[str]
                     ) -> Dict[str, int]:
    """Histogram of activation bit-widths over the given sites."""
    hist: Dict[str, int] = {}
    for s in sites:
        cfg = policy.act_config(s)
        key = "fp32" if not cfg.enabled else f"a{cfg.bits}"
        hist[key] = hist.get(key, 0) + 1
    return hist


def leave_one_out_policies(base: QuantizationPolicy,
                           site_patterns: Sequence[str]
                           ) -> List[Tuple[str, QuantizationPolicy]]:
    """Table-2-style ablations: for each pattern, ``base`` with that
    activation group kept in FP32."""
    out = []
    for pat in site_patterns:
        overrides = dict(base.act_overrides)
        overrides[pat] = FP32
        out.append((pat, dataclasses.replace(base, act_overrides=overrides)))
    return out


def sensitivity_sweep(evaluate: Callable[[QuantizationPolicy], float],
                      base: QuantizationPolicy,
                      site_patterns: Sequence[str]) -> Dict[str, float]:
    """The evaluation callback for every leave-one-out policy: the pattern
    whose exclusion recovers the most metric is the bottleneck (the paper
    finds ``.*residual_ffn``)."""
    return {pat: evaluate(pol)
            for pat, pol in leave_one_out_policies(base, site_patterns)}
